"""Training driver, in torch.

Counterpart of ``repro/launch/train.py``: the arch registry, the train
step (AdamW or TreeNewton, gradient accumulation), the deterministic
restart-safe data pipeline, asynchronous atomic checkpoints, a blocking
save on SIGTERM, ``--resume``, and a step-time heartbeat that flags
stragglers.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
        --smoke --device cpu --steps 50 --optimizer tree_newton

It runs on the card (``--device cuda``, the default) or, when asked, on
the CPU; a run on ``cuda`` without a CUDA device raises.

``--mesh host(DxM)`` trains under a ``data x model`` mesh of D x M gloo
ranks that :func:`repro_torch.launch.mesh.launch` starts on this
machine (sharing the card, or the CPU's cores under ``--device cpu``),
``--layout tp|ddp`` as the reference's; the state and batches are
placed (``convert.place_train_state``, ``place_batch``), every rank
writes its slices of each save, and ``--resume`` reads each rank's
slices onto whatever mesh the run has. SIGTERM to the driver (or to a
rank) makes every rank save and stop at the same step. ``--mesh 16x16``
and ``2x16x16`` run only inside a process group of 256 or 512 ranks
(torchrun's environment, or a group already joined); anywhere else they
raise a ``ValueError`` that names the size.

Checkpoints are written in the reference's layout
(:func:`repro_torch.convert.train_state_layout`: its leaf names, the
layers stacked), so a checkpoint of either package's driver resumes in
the other. A new save first waits for the previous one, so at most one
host copy of the state is held. :func:`main` takes the argument list
(``sys.argv`` by default) and returns a summary of the run, the final
state included (under a mesh rank 0's run, the state gathered whole in
the reference's layout, as numpy).
"""
from __future__ import annotations

import argparse
import os
import re
import signal
import statistics
import sys
import tempfile
import threading
import time

import torch
import torch.distributed as dist

from repro_torch import checkpoint as ckpt
from repro_torch import configs, convert
from repro_torch.data import Prefetcher, SyntheticLM
from repro_torch.optim import AdamWConfig, TreeNewtonConfig
from repro_torch.optim.adamw import leaves
from repro_torch.models.transformer import init_params
from repro_torch.train import (TrainConfig, init_state, make_train_step,
                               reshape_for_accum)
from repro_torch.train.step import init_opt


class Heartbeat:
    """Step-time monitor: flags a step slower than ``factor`` times the
    running median of the last 50 (from the 8th step on); it logs."""

    def __init__(self, factor=3.0):
        self.times = []
        self.factor = factor

    def beat(self, dt):
        self.times.append(dt)
        if len(self.times) >= 8:
            med = statistics.median(self.times[-50:])
            if dt > self.factor * med:
                print(f"[heartbeat] straggler step: {dt * 1e3:.0f}ms vs "
                      f"median {med * 1e3:.0f}ms", file=sys.stderr)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="gemma-2b", choices=configs.ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--optimizer", default="adamw",
                    choices=("adamw", "tree_newton"))
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--mesh", default="none",
                    help="none | host(DxM) | 16x16 | 2x16x16")
    ap.add_argument("--layout", default="tp", choices=("tp", "ddp"))
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model trains (never a fallback)")
    return ap.parse_args(argv)


def configs_of(args):
    """``(model config, train config)`` of the parsed arguments, as the
    reference's driver builds them."""
    cfg = configs.get_config(args.arch, smoke=args.smoke)
    if args.smoke:
        cfg = cfg.replace(remat=False)
    adam = AdamWConfig(lr=args.lr, warmup=min(20, args.steps // 5),
                       total_steps=args.steps)
    tn = TreeNewtonConfig(adam=adam, block=128, factor_every=20,
                          stats_every=2)
    return cfg, TrainConfig(optimizer=args.optimizer, adam=adam,
                            tree_newton=tn, accum=args.accum)


_HOST = re.compile(r"^host\((\d+)x(\d+)\)$")
_PRODUCTION = {"16x16": 256, "2x16x16": 512}


def main(argv=None) -> dict:
    """Train as the arguments say. Returns ``{"state", "cfg", "tcfg",
    "start", "losses", "step_s", "save_s", "write_s", "restore_s",
    "preempted"}``: the final state, the configs, the step it started
    from, each step's loss and host seconds (batch to loss), each save's
    blocking seconds and its writer's seconds, the restore's seconds
    (None without a resume), and whether SIGTERM ended it. Under a mesh:
    rank 0's, its ``state`` gathered whole in the reference's layout
    (numpy)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch sees no CUDA device "
                           "(--device cpu trains on the CPU)")
    if args.mesh == "none":
        return _train(args)
    host = _HOST.match(args.mesh)
    if host:
        return _host_mesh(argv, args, int(host.group(1)),
                          int(host.group(2)))
    if args.mesh not in _PRODUCTION:
        raise ValueError(f"--mesh {args.mesh!r}: none, host(DxM), 16x16 "
                         "or 2x16x16")
    from repro_torch.launch.mesh import make_production_mesh
    need = _PRODUCTION[args.mesh]
    have = (dist.get_world_size() if dist.is_initialized()
            else int(os.environ.get("WORLD_SIZE", 0)) or None)
    if have != need:
        raise ValueError(f"--mesh {args.mesh} needs a process group of "
                         f"{need} ranks (torchrun --nproc-per-node ...); "
                         f"this process has {have or 'none'}")
    if not dist.is_initialized():
        dist.init_process_group("gloo")     # torchrun's environment
    multi = args.mesh.count("x") == 2
    mesh = make_production_mesh(multi_pod=multi, device_type=args.device)
    return _train(args, mesh, multi_pod=multi)


def _host_mesh(argv, args, d, m) -> dict:
    """``--mesh host(DxM)``: D x M ranks on this machine, SIGTERM passed
    on to them through a flag file."""
    from repro_torch.launch.mesh import launch
    os.makedirs(args.ckpt_dir, exist_ok=True)
    flag = os.path.join(args.ckpt_dir, f".preempt-{os.getpid()}")

    def _sigterm(signum, frame):
        open(flag, "w").close()
    main_thread = threading.current_thread() is threading.main_thread()
    prev = signal.signal(signal.SIGTERM, _sigterm) if main_thread else None
    try:
        return launch(_mesh_rank, d * m, (argv, d, m, flag),
                      device=args.device, timeout=24 * 3600.0)[0]
    finally:
        if main_thread:
            signal.signal(signal.SIGTERM, prev)
        if os.path.exists(flag):
            os.remove(flag)


def _mesh_rank(argv, d, m, flag):
    """One rank of ``--mesh host(DxM)`` (a spawned process)."""
    from repro_torch.launch.mesh import make_host_mesh
    args = parse_args(argv)
    signal.signal(signal.SIGTERM, lambda *_: open(flag, "w").close())
    mesh = make_host_mesh(d, m, device_type=args.device)
    out = _train(args, mesh, flag=flag)
    return out if dist.get_rank() == 0 else None


def _train(args, mesh=None, *, multi_pod=False, flag=None) -> dict:
    """The driver's run, with no mesh or on ``mesh`` (every rank)."""
    from repro_torch.launch.sharding import make_sharder
    from repro_torch.models.common import NO_SHARD
    lead = mesh is None or dist.get_rank() == 0
    dev = torch.device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    cfg, tcfg = configs_of(args)
    sharder = NO_SHARD
    if mesh is None:
        state = init_state(cfg, tcfg, seed=0, device=dev)
    else:
        # the parameters drawn whole and placed, the optimizer's state
        # made on the placed ones: no rank holds a whole state
        sharder = make_sharder(mesh, multi_pod=multi_pod,
                               batch=args.batch // args.accum,
                               layout=args.layout)
        with torch.no_grad():
            params = convert.place_params(
                init_params(cfg, seed=0, device=dev), cfg, mesh,
                layout=args.layout)
        state = {"params": params, "opt": init_opt(params, tcfg, mesh),
                 "step": 0}
    nparams = sum(p.numel() for _, p in leaves(state["params"]))
    if lead:
        print(f"{cfg.name}: {nparams / 1e6:.1f}M params, "
              f"opt={args.optimizer}, mesh={args.mesh}, "
              f"layout={args.layout}, device={args.device}", flush=True)

    out = {"cfg": cfg, "tcfg": tcfg, "start": 0, "losses": [], "step_s": [],
           "save_s": [], "write_s": [], "restore_s": None,
           "preempted": False}
    if args.resume and ckpt.latest_step(args.ckpt_dir) is not None:
        t0 = time.perf_counter()
        layout, out["start"] = ckpt.restore_into(
            args.ckpt_dir, convert.train_state_layout(state))
        state = convert.train_state_from_layout(layout, state)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out["restore_s"] = time.perf_counter() - t0
        if lead:
            print(f"resumed at step {out['start']}", flush=True)

    step_fn = make_train_step(cfg, tcfg, sharder)
    data = SyntheticLM(cfg.vocab, args.batch, args.seq, seed=0,
                       n_codebooks=cfg.n_codebooks,
                       n_img_tokens=cfg.n_img_tokens, d_model=cfg.d_model)
    pf = Prefetcher(data, start_step=out["start"])
    hb = Heartbeat()
    handles = []

    def save(step, blocking=False):
        if handles:                 # one host copy of the state at a time
            handles[-1].wait()
            if handles[-1].step == step:
                return
        t0 = time.perf_counter()
        handles.append(ckpt.save(args.ckpt_dir, step,
                                 convert.train_state_layout(state),
                                 blocking=blocking))
        out["save_s"].append(time.perf_counter() - t0)

    def stopping() -> bool:
        if mesh is None:
            return stop["now"]
        # every rank stops at the same step
        t = torch.tensor([float(os.path.exists(flag) if flag else
                                stop["now"])])
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    # preemption hook: SIGTERM sets a flag; the loop saves and stops
    stop = {"now": False}

    def _sigterm(signum, frame):
        stop["now"] = True
    main_thread = threading.current_thread() is threading.main_thread()
    prev = (signal.signal(signal.SIGTERM, _sigterm)
            if main_thread and flag is None else None)
    try:
        for _ in range(out["start"], args.steps):
            t0 = time.perf_counter()
            i, batch = pf.next()
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in batch.items()}
            batch = reshape_for_accum(batch, tcfg.accum)
            if mesh is not None:
                batch = convert.place_batch(batch, sharder,
                                            accum=tcfg.accum)
            state, m = step_fn(state, batch)
            loss = float(m["loss"])             # waits for the step
            out["losses"].append(loss)
            out["step_s"].append(time.perf_counter() - t0)
            hb.beat(out["step_s"][-1])
            if (i + 1) % 10 == 0 and lead:
                print(f"step {i + 1:5d} loss={loss:8.4f} "
                      f"gnorm={float(m['grad_norm']):7.3f} "
                      f"lr={float(m['lr']):.2e}", flush=True)
            if (i + 1) % args.ckpt_every == 0:
                save(i + 1)
            if stopping():
                if lead:
                    print("[preempt] SIGTERM — saving and exiting",
                          flush=True)
                save(i + 1, blocking=True)
                out["preempted"] = True
                break
        if handles:
            handles[-1].wait()
        out["write_s"] = [h.seconds for h in handles]
    finally:
        pf.close()
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)
    if lead:
        print("done", flush=True)
    if mesh is None:
        out["state"] = state
        return out
    whole = convert.gather_train_state(state)
    if whole is not None:
        out["state"] = {"params": convert.model_params_to_numpy(
            whole["params"]), "opt": convert.opt_state_to_numpy(whole["opt"]),
            "step": whole["step"]}
    return out


if __name__ == "__main__":
    main()
