"""Training driver, in torch.

Counterpart of ``repro/launch/train.py``: the arch registry, the train
step (AdamW or TreeNewton, gradient accumulation), the deterministic
restart-safe data pipeline, asynchronous atomic checkpoints, a blocking
save on SIGTERM, ``--resume``, and a step-time heartbeat that flags
stragglers.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
        --smoke --device cpu --steps 50 --optimizer tree_newton

It runs on the card (``--device cuda``, the default) or, when asked, on
the CPU; a run on ``cuda`` without a CUDA device raises. Only ``--mesh
none`` is ported: a host or production mesh raises (ROADMAP A3).

Checkpoints are written in the reference's layout
(:func:`repro_torch.convert.train_state_layout`: its leaf names, the
layers stacked), so a checkpoint of either package's driver resumes in
the other. A new save first waits for the previous one, so at most one
host copy of the state is held. :func:`main` takes the argument list
(``sys.argv`` by default) and returns a summary of the run, the final
state included.
"""
from __future__ import annotations

import argparse
import os
import signal
import statistics
import sys
import tempfile
import threading
import time

import torch

from repro_torch import checkpoint as ckpt
from repro_torch import configs, convert
from repro_torch.data import Prefetcher, SyntheticLM
from repro_torch.optim import AdamWConfig, TreeNewtonConfig
from repro_torch.optim.adamw import leaves
from repro_torch.train import (TrainConfig, init_state, make_train_step,
                               reshape_for_accum)


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
                    help="none (host(DxM) and production meshes: ROADMAP A3)")
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


def main(argv=None) -> dict:
    """Train as the arguments say. Returns ``{"state", "cfg", "tcfg",
    "start", "losses", "step_s", "save_s", "write_s", "restore_s",
    "preempted"}``: the final state, the configs, the step it started
    from, each step's loss and host seconds (batch to loss), each save's
    blocking seconds and its writer's seconds, the restore's seconds
    (None without a resume), and whether SIGTERM ended it."""
    args = parse_args(argv)
    if args.mesh != "none":
        raise NotImplementedError(
            f"--mesh {args.mesh}: host and production meshes are not ported "
            "yet (ROADMAP A3, 'Sharding and meshes')")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch sees no CUDA device "
                           "(--device cpu trains on the CPU)")
    cfg, tcfg = configs_of(args)
    state = init_state(cfg, tcfg, seed=0, device=args.device)
    nparams = sum(p.numel() for _, p in leaves(state["params"]))
    print(f"{cfg.name}: {nparams / 1e6:.1f}M params, opt={args.optimizer}, "
          f"mesh={args.mesh}, device={args.device}", flush=True)

    out = {"cfg": cfg, "tcfg": tcfg, "start": 0, "losses": [], "step_s": [],
           "save_s": [], "write_s": [], "restore_s": None,
           "preempted": False}
    if args.resume and ckpt.latest_step(args.ckpt_dir) is not None:
        t0 = time.perf_counter()
        layout, out["start"] = ckpt.restore_into(
            args.ckpt_dir, convert.train_state_layout(state))
        state = convert.train_state_from_layout(layout, state)
        if args.device == "cuda":
            torch.cuda.synchronize()
        out["restore_s"] = time.perf_counter() - t0
        print(f"resumed at step {out['start']}", flush=True)

    step_fn = make_train_step(cfg, tcfg)
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

    # preemption hook: SIGTERM sets a flag; the loop saves and stops
    stop = {"now": False}

    def _sigterm(signum, frame):
        stop["now"] = True
    main_thread = threading.current_thread() is threading.main_thread()
    prev = signal.signal(signal.SIGTERM, _sigterm) if main_thread else None
    try:
        for _ in range(out["start"], args.steps):
            t0 = time.perf_counter()
            i, batch = pf.next()
            batch = {k: torch.from_numpy(v).to(args.device)
                     for k, v in batch.items()}
            batch = reshape_for_accum(batch, tcfg.accum)
            state, m = step_fn(state, batch)
            loss = float(m["loss"])             # waits for the step
            out["losses"].append(loss)
            out["step_s"].append(time.perf_counter() - t0)
            hb.beat(out["step_s"][-1])
            if (i + 1) % 10 == 0:
                print(f"step {i + 1:5d} loss={loss:8.4f} "
                      f"gnorm={float(m['grad_norm']):7.3f} "
                      f"lr={float(m['lr']):.2e}", flush=True)
            if (i + 1) % args.ckpt_every == 0:
                save(i + 1)
            if stop["now"]:
                print("[preempt] SIGTERM — saving and exiting", flush=True)
                save(i + 1, blocking=True)
                out["preempted"] = True
                break
        if handles:
            handles[-1].wait()
        out["write_s"] = [h.seconds for h in handles]
    finally:
        pf.close()
        if main_thread:
            signal.signal(signal.SIGTERM, prev)
    print("done", flush=True)
    out["state"] = state
    return out


if __name__ == "__main__":
    main()
