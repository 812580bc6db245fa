"""The rank side of the distributed path's checks, run by :func:`launch`.

``tests/test_torch_distributed.py`` (4 ranks on the CPU, the JAX
reference computed by the parent process) and ``chip_smoke.py``'s ``dist``
phase (4 ranks sharing one card) drive the distributed factor, solve,
mesh-mode serving and the tuner's distributed grid through
:func:`run_cases`, which every rank runs; ``tests/test_torch_train.py``
and ``chip_smoke.py``'s ``train_dp`` phase drive the int8 error-feedback
all-reduce (``ef_allreduce``) and the reference's mini data-parallel
trainer on it (``train_dp``) the same way, and
``tests/test_torch_mesh_serve.py`` and ``chip_smoke.py``'s
``generate_mesh`` phase drive model serving under a ``data x model`` mesh
(``mesh_serve``, ``moe_ep``) through :func:`run_mesh_cases`, and
``tests/test_torch_mesh_train.py`` and the ``train_mesh`` phase training
there (``mesh_train``: the sharded step against the single rank's;
``elastic``: a mesh's save resumed on another mesh and on one process).
Each case builds its inputs on the rank from a seed (:func:`spd_matrix`)
or takes the caller's arrays,
calls the port's entry points as a user would, and
returns, on rank 0, what the caller checks: results, times and, per rank,
launches by kernel and bytes by collective. The other ranks return None.
A target of ``launch`` must live in an importable module of the port: a
spawned rank imports the module of its target and nothing of the caller's.
"""
from __future__ import annotations

import copy
import dataclasses
import math
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import distributed as D
from repro_torch.core.precision import DTYPES, PAPER_CONFIGS, PrecisionConfig
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_mesh


def spd_matrix(n: int, seed: int, dtype, device, shift=None):
    """Paper §IV-A's matrix: symmetric uniform(-1, 1) entries plus
    ``shift`` (default n) on the diagonal, built on ``device`` from a torch
    generator. A small shift (a few sqrt(n)) gives a factor whose entries
    below the diagonal are a sizable share of its diagonal, and the
    trailing updates a sizable share of them."""
    g = torch.Generator(device=device).manual_seed(seed)
    m = torch.rand((n, n), generator=g, device=device, dtype=dtype)
    m.mul_(2).sub_(1)
    a = m.add_(m.T.clone()).mul_(0.5)
    a.diagonal().add_(n if shift is None else shift)
    return a


def _matrix(data, name, n: int, seed: int, dtype, device, shift=None):
    """The caller's matrix ``data[name]``, or :func:`spd_matrix`."""
    if name is not None:
        return torch.tensor(data[name], dtype=dtype, device=device)
    return spd_matrix(n, seed, dtype, device, shift)


def off_fingerprint(a, seed: int):
    """``a`` plus a symmetric uniform(-1/2, 1/2) matrix that is zero on
    the diagonal, in row 0 and in column 0: another matrix with the same
    ``matrix_fingerprint``."""
    e = spd_matrix(a.shape[0], seed, a.dtype, a.device, shift=0.0)
    e.diagonal().zero_()
    e[0].zero_()
    e[:, 0].zero_()
    return a + 0.5 * e


def _cfg(ladder, leaf=None, engine=None) -> PrecisionConfig:
    cfg = PAPER_CONFIGS[ladder] if isinstance(ladder, str) else ladder
    if leaf is not None:
        cfg = dataclasses.replace(cfg, leaf=leaf)
    if engine is not None:
        cfg = dataclasses.replace(cfg, engine=engine)
    return cfg


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


class _Timer:
    """Wall seconds and, on the card, CUDA-event ms of one collective
    call; every rank enters together. Nothing inside the call is timed
    apart."""

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        _sync(self.device)
        dist.barrier()
        if self.device.type == "cuda":
            self.events = [torch.cuda.Event(enable_timing=True)
                           for _ in range(2)]
            self.events[0].record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            self.events[1].record()
        _sync(self.device)
        self.wall_s = time.perf_counter() - self.t0
        self.ms = (self.events[0].elapsed_time(self.events[1])
                   if self.device.type == "cuda" else None)


def _per_rank(obj) -> list:
    """``obj`` of every rank, in rank order (an object all-gather, outside
    the counted collectives)."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _counters() -> dict:
    return {"launches": dict(ops.LAUNCHES), "batched": dict(ops.BATCHED),
            "qgemm_routes": dict(ops.QGEMM_ROUTES),
            "wire": copy.deepcopy(D.WIRE)}


def _reset() -> None:
    ops.reset_launches()
    D.reset_wire()


def factor(mesh, device, data, *, ladder, n, seed, leaf=None, engine=None,
           matrix=None, shift=None, dtype="f32", broadcast_diag_only=True,
           compress_comm=None, return_factor=False, yardstick=False):
    """One ``dist_cholesky``: per rank its ms, wall s, launches by kernel,
    ``qgemm`` launches by route and bytes by collective, whether every
    upper element is zero and every element finite; with ``yardstick``,
    the largest difference from the single-device factor of the same
    matrix and engine relative to its max |L|, and that of the entries
    below the diagonal relative to their own max (each rank computes that
    factor and compares its own rows; a NaN anywhere makes both NaN); with
    ``return_factor``, the whole L on rank 0."""
    cfg = _cfg(ladder, leaf, engine)
    a = _matrix(data, matrix, n, seed, DTYPES[dtype], device, shift)
    a_sh = D.shard_rows(a, mesh)
    _reset()
    with _Timer(device) as t:
        l = D.dist_cholesky(a_sh, mesh, cfg,
                            broadcast_diag_only=broadcast_diag_only,
                            compress_comm=compress_comm)
    mine = {"ms": t.ms, "wall_s": t.wall_s, **_counters()}
    l_local = l.to_local()
    w = l_local.shape[0]
    r0 = dist.get_rank() * w
    mine["upper_zero"] = bool((torch.triu(l_local, r0 + 1) == 0).all())
    mine["finite"] = bool(torch.isfinite(l_local).all())
    if yardstick:
        from repro_torch.core.blocked import blocked_potrf
        from repro_torch.core.tree import tree_potrf
        ref = (tree_potrf if cfg.engine == "tree" else blocked_potrf)(a, cfg)
        diff = (l_local - ref[r0:r0 + w]).abs()
        mine["max_diff"] = float(diff.max())
        mine["max_ref"] = float(ref.abs().max())
        mine["max_diff_lower"] = float(torch.tril(diff, r0 - 1).max())
        mine["max_ref_lower"] = float(torch.tril(ref, -1).abs().max())
        del ref, diff
    full = D.gather_rows(l, mesh) if return_factor else None
    ranks = _per_rank(mine)
    if dist.get_rank() != 0:
        return None
    out = {"ranks": ranks, "n": n, "leaf": cfg.leaf, "engine": cfg.engine,
           "nshards": mesh.size(),
           "upper_zero": all(r["upper_zero"] for r in ranks),
           "finite": all(r["finite"] for r in ranks)}
    if yardstick:
        def most(key):             # NaN-propagating, unlike max()
            return torch.tensor([r[key] for r in ranks]).max().item()
        out["rel_to_single"] = most("max_diff") / most("max_ref")
        out["rel_lower_to_single"] = (most("max_diff_lower")
                                      / most("max_ref_lower"))
    if full is not None:
        out["l"] = full.cpu().numpy()
    return out


def _digits(a, x, b) -> float:
    """-log10 of ||b - A x|| / ||b|| in f64."""
    a64, x64, b64 = a.double(), x.double(), b.double()
    res = float(torch.linalg.norm(b64 - a64 @ x64) / torch.linalg.norm(b64))
    return -math.log10(max(res, 1e-300))


def solve(mesh, device, data, *, ladder, n, seed, k, leaf=None,
          matrix=None, rhs=None, shift=None, compare_single=False):
    """``dist_cholesky`` then ``dist_cholesky_solve`` for k right-hand
    sides; per rank the ms of each; on rank 0 the whole x, its digits and,
    with ``compare_single``, the single-device ``cholesky_solve``'s digits
    on the same system. ``rhs`` names the caller's (n, k) right-hand
    sides; else they are standard normal on the device."""
    from repro_torch.core.solve import cholesky_solve
    cfg = _cfg(ladder, leaf)
    a = _matrix(data, matrix, n, seed, torch.float32, device, shift)
    if rhs is not None:
        b = torch.tensor(data[rhs], dtype=torch.float32, device=device)
    else:
        g = torch.Generator(device=device).manual_seed(seed + 1)
        b = torch.randn((n, k), generator=g, device=device)
    _reset()
    with _Timer(device) as tf:
        l = D.dist_cholesky(D.shard_rows(a, mesh), mesh, cfg)
    with _Timer(device) as ts:
        x = D.dist_cholesky_solve(None, D.shard_rows(b, mesh), mesh, cfg,
                                  l=l)
    mine = {"factor_ms": tf.ms, "factor_wall_s": tf.wall_s,
            "solve_ms": ts.ms, "solve_wall_s": ts.wall_s, **_counters()}
    x = D.gather_rows(x, mesh)
    ranks = _per_rank(mine)
    if dist.get_rank() != 0:
        return None
    out = {"ranks": ranks, "n": n, "k": k, "leaf": cfg.leaf,
           "x": x.cpu().numpy(), "digits": _digits(a, x, b)}
    if compare_single:
        out["single_digits"] = _digits(a, cholesky_solve(a, b, cfg), b)
    return out


def serve(mesh, device, data, *, ladder, n, n_local, seed, targets,
          waves=(1, 7), residual_dtype="f32", max_sweeps=10,
          dist_threshold=None, matrix=None, shift=None, fault_rank=1,
          max_wait_ms=200.0):
    """Mesh-mode serving with rank 0 leading: rank 0's ``BatchScheduler``
    (windowed async drains) answers ``sum(waves)`` requests against one
    matrix A of order ``n`` (cache key "big"; targets cycle through
    ``targets``), the waves one after another so that the later ones find
    the sharded factor cached, and one request of order ``n_local`` below
    the threshold. Then, through the same scheduler: a request that rank
    ``fault_rank`` fails (its cache lookup raises for the key "fault"), and
    after it one under the key "big" whose matrix differs from A off the
    fingerprint's samples (:func:`off_fingerprint`). Last, rank 0 makes a
    call with a matrix of the wrong shape, and ``engine.solve`` answers
    each of the first requests again alone. The other ranks follow. Rank 0
    returns each request's x and SolveInfo from both, its digits against
    its own matrix, the exceptions, the wall seconds of each wave, and
    every rank's launches and bytes and number of calls followed."""
    from repro_torch.serve import SolverEngine
    eng = SolverEngine(ladder, max_sweeps=max_sweeps, mesh=mesh,
                       dist_threshold=dist_threshold,
                       residual_dtype=residual_dtype, device=device)
    if dist.get_rank() == fault_rank:
        lookup = eng._lookup

        def faulty(key, fp):
            if key == "fault":
                raise RuntimeError("fault injected for the test")
            return lookup(key, fp)
        eng._lookup = faulty
    _reset()
    followed = None
    if dist.get_rank() == 0:
        out = _lead(eng, device, data, n=n, n_local=n_local, seed=seed,
                    targets=targets, waves=waves, matrix=matrix, shift=shift,
                    max_wait_ms=max_wait_ms)
    else:
        followed = eng.follow()
        out = None
    ranks = _per_rank({**_counters(), "followed": followed})
    if out is not None:
        out["ranks"] = ranks
    return out


def _lead(eng, device, data, *, n, n_local, seed, targets, waves, matrix,
          shift, max_wait_ms):
    """Rank 0's half of :func:`serve`."""
    from repro_torch.serve import BatchScheduler, SolveOptions
    dtype = torch.float32
    a = _matrix(data, matrix, n, seed, dtype, device, shift)
    a_loc = spd_matrix(n_local, seed + 1, dtype, device)
    a_off = off_fingerprint(a, seed + 3)
    g = torch.Generator(device=device).manual_seed(seed + 2)
    nreq = sum(waves)
    bs = [torch.randn((n,), generator=g, device=device, dtype=dtype)
          for _ in range(nreq + 2)]
    b_loc = torch.randn((n_local,), generator=g, device=device, dtype=dtype)
    opts = [SolveOptions(target_digits=targets[i % len(targets)],
                         cache_key="big") for i in range(nreq + 1)]
    opt_loc = SolveOptions(target_digits=targets[0], cache_key="small")
    opt_fault = SolveOptions(target_digits=targets[0], cache_key="fault")
    got, walls = [], []

    def raised(fn):
        try:
            fn()
        except Exception as exc:  # noqa: BLE001 — what the caller checks
            return {"type": type(exc).__name__, "message": str(exc)}
        return None
    with eng.lead():
        sch = BatchScheduler(eng, max_wait_ms=max_wait_ms)
        sch.start()
        try:
            i = 0
            for wave in waves:
                t0 = time.perf_counter()
                futs = [sch.submit_async(a, bs[j], opts[j])
                        for j in range(i, i + wave)]
                if i == 0:
                    futs.append(sch.submit_async(a_loc, b_loc, opt_loc))
                got += [f.result(timeout=1800) for f in futs]
                walls.append(time.perf_counter() - t0)
                i += wave
            fault = sch.submit_async(a, bs[nreq + 1], opt_fault)
            fault = raised(lambda: fault.result(timeout=1800))
            off = sch.submit_async(a_off, bs[nreq], opts[nreq]).result(
                timeout=1800)
        finally:
            sch.stop()
        wrong = raised(lambda: eng.solve(a[:, :n - 1], bs[0], opts[0]))
        # the local request came back with the first wave
        local = got.pop(waves[0])
        direct = [eng.solve(a, bs[j], opts[j]) for j in range(nreq)]
        direct_local = eng.solve(a_loc, b_loc, opt_loc)

    def pack(x, info, a_, b_):
        return {"x": x.cpu().numpy(), "info": dataclasses.asdict(info),
                "digits": _digits(a_, x, b_)}
    return {"n": n, "n_local": n_local, "wave_wall_s": walls,
            "scheduled": [pack(x, info, a, b)
                          for (x, info), b in zip(got, bs)],
            "direct": [pack(x, info, a, b)
                       for (x, info), b in zip(direct, bs)],
            "local": pack(*local, a_loc, b_loc),
            "direct_local": pack(*direct_local, a_loc, b_loc),
            "off_fingerprint": {**pack(*off, a_off, bs[nreq]),
                                "digits_against_a": _digits(a, off[0],
                                                            bs[nreq]),
                                "target": opts[nreq].target_digits},
            "fault": fault, "wrong_shape": wrong,
            "targets": [o.target_digits for o in opts[:nreq]]}


def engine_spmd(mesh, device, data, *, ladder, dist_threshold,
                max_sweeps=8):
    """The reference suite's mesh-mode engine test, SPMD: every rank makes
    the same calls with the caller's matrices. A request with ``data``'s
    "a" and "b" under cache key "big", the same key again with 2 b, the
    same key with "a_off" (the same fingerprint, another matrix), and one
    with "a_small" and "b_small" below the threshold; rank 0 returns each
    x and SolveInfo."""
    from repro_torch.serve import SolverEngine
    eng = SolverEngine(ladder, max_sweeps=max_sweeps, mesh=mesh,
                       dist_threshold=dist_threshold, device=device)
    t = {k: torch.tensor(v, dtype=torch.float32, device=device)
         for k, v in data.items()
         if k in ("a", "b", "a_off", "a_small", "b_small")}
    runs = [eng.solve(t["a"], t["b"], target_digits=6, cache_key="big"),
            eng.solve(t["a"], 2.0 * t["b"], target_digits=6,
                      cache_key="big"),
            eng.solve(t["a_off"], t["b"], target_digits=6, cache_key="big"),
            eng.solve(t["a_small"], t["b_small"], target_digits=6)]
    if dist.get_rank() != 0:
        return None
    return [{"x": x.cpu().numpy(), "info": dataclasses.asdict(info)}
            for x, info in runs]


def gloo(mesh, device, data, *, nbytes=64 << 20, reps=3):
    """The collectives the distributed path uses, on this device: the list
    forms of ``all_gather``, ``broadcast`` and ``scatter`` for every dtype
    must give every rank its values and leave them on the device; then the
    host seconds of an f32 ``all_gather`` of ``nbytes`` a rank, ``reps``
    times. Rank 0 returns what it saw."""
    group = mesh.get_group("model")
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    checks = {}
    for name, dt in DTYPES.items():
        t = torch.full((5,), rank + 1, dtype=dt, device=device)
        got = D.all_gather_counted(t, group)
        ok = [int(g[0]) for g in got] == list(range(1, size + 1))
        ok &= all(g.device == t.device for g in got)
        D.broadcast_counted(t, size - 1, group)
        ok &= int(t[0]) == size and t.device.type == device.type
        chunks = ([torch.full((5,), r + 1, dtype=dt, device=device)
                   for r in range(size)] if rank == 0 else None)
        D.scatter_counted(t, chunks, 0, group)
        ok &= int(t[0]) == rank + 1 and t.device.type == device.type
        checks[name] = bool(ok)
    big = torch.ones(nbytes // 4, device=device)
    secs = []
    for _ in range(reps):
        _sync(device)
        dist.barrier()
        t0 = time.perf_counter()
        D.all_gather_counted(big, group)
        _sync(device)
        secs.append(time.perf_counter() - t0)
    ranks = _per_rank({"checks": checks, "all_gather_s": secs})
    if rank != 0:
        return None
    return {"ranks": ranks, "nbytes": nbytes,
            "ok": all(all(r["checks"].values()) for r in ranks)}


def imports(mesh, device, data):
    """The modules of jax or of the JAX package that any rank has loaded
    (the port's ranks must load none)."""
    import sys
    bad = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith(("jax.", "repro."))
                 or m == "repro")
    ranks = _per_rank(bad)
    return ranks if dist.get_rank() == 0 else None


def counting_timer():
    """tests/test_tune.py's order-dependent fake timer: the k-th call
    returns 1000 + 7 k microseconds and runs nothing."""
    calls = [0]

    def timer(fn, *args):
        calls[0] += 1
        return 1000.0 + 7.0 * calls[0]
    return timer


def tune(mesh, device, data, *, smoke=True, fake_timer=False,
         ladders=("bf16_f32",), backend=None):
    """``autotune(nshards=P)`` on every rank; rank 0 returns the payload
    and the wall seconds."""
    from repro_torch.tune import autotune
    kwargs = {"log": lambda *a: None}         # the payload has every time
    if fake_timer:
        kwargs["timer"] = counting_timer()
    _reset()
    t0 = time.perf_counter()
    payload = autotune(backend or device.type, smoke=smoke, ladders=ladders,
                       nshards=mesh.size(), device=device, **kwargs)
    wall = time.perf_counter() - t0
    ranks = _per_rank(_counters())
    if dist.get_rank() != 0:
        return None
    return {"payload": payload, "wall_s": wall, "ranks": ranks}


def ef_allreduce(mesh, device, data, *, rounds=1):
    """``train.compress.ef_allreduce_mean`` ``rounds`` times, rank r
    taking row r of ``data["grad"]`` as its gradient every round and
    carrying its residual (from ``data["residual"]``'s row r). Rank 0
    returns every rank's reduced gradient and residual (numpy)."""
    from repro_torch.train.compress import ef_allreduce_mean
    group = mesh.get_group("model")
    rank = dist.get_rank(group)
    g = torch.as_tensor(data["grad"][rank], device=device)
    res = torch.as_tensor(data["residual"][rank], device=device)
    for _ in range(rounds):
        red, new = ef_allreduce_mean({"w": g}, {"w": res}, group)
        res = new["w"]
    ranks = _per_rank({"reduced": red["w"].cpu().numpy(),
                       "residual": res.cpu().numpy()})
    return ranks if rank == 0 else None


def train_dp(mesh, device, data, *, steps=600, lr=0.05, seed=0):
    """The reference's mini data-parallel trainer
    (``tests/test_train.py:test_ef_compression_dp_trainer``): least
    squares ``y = x w_true`` (16 x 4) on 64 rows, each rank its own
    64 / world rows, gradients averaged by ``ef_allreduce_mean`` with each
    rank's residual, ``steps`` steps of plain gradient descent. Rank 0
    returns max|w - w_true|, the loss and the wall seconds."""
    from repro_torch.train.compress import ef_allreduce_mean
    group = mesh.get_group("model")
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    rng = np.random.default_rng(seed)
    w_true = rng.standard_normal((16, 4)).astype(np.float32)
    X = rng.standard_normal((64, 16)).astype(np.float32)
    Y = X @ w_true
    rows = slice(rank * 64 // size, (rank + 1) * 64 // size)
    x = torch.as_tensor(X[rows], device=device)
    y = torch.as_tensor(Y[rows], device=device)
    w = torch.zeros((16, 4), device=device)
    res = torch.zeros((16, 4), device=device)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        wg = w.clone().requires_grad_()
        loss = torch.mean((x @ wg - y) ** 2)
        g, = torch.autograd.grad(loss, wg)
        red, new = ef_allreduce_mean({"w": g}, {"w": res}, group)
        w, res = w - lr * red["w"], new["w"]
    _sync(device)
    wall = time.perf_counter() - t0
    err = float((w.cpu() - torch.as_tensor(w_true)).abs().max())
    return ({"err": err, "loss": float(loss.detach()), "wall_s": wall,
             "steps": steps} if rank == 0 else None)


CASES = {"gloo": gloo, "factor": factor, "solve": solve, "serve": serve,
         "engine_spmd": engine_spmd, "tune": tune, "imports": imports,
         "ef_allreduce": ef_allreduce, "train_dp": train_dp}


# ---------------------------------------------------------------------------
# model serving under a data x model mesh
# ---------------------------------------------------------------------------
def _model_cfg(arch, *, smoke, n_layers=None, dtype=None, over=None):
    from repro_torch.configs import get_config
    cfg = get_config(arch, smoke=smoke)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    if dtype is not None:
        cfg = cfg.replace(param_dtype=dtype, activ_dtype=dtype)
    return cfg.replace(**(over or {}))


def _prompt(cfg, B, S, seed, device):
    """A prompt batch drawn on the host from ``seed`` (every rank draws
    the same)."""
    g = torch.Generator().manual_seed(seed)
    shape = (B, S, cfg.n_codebooks) if cfg.family == "audio" else (B, S)
    batch = {"tokens": torch.randint(0, cfg.vocab, shape, generator=g)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn(
            (B, cfg.n_img_tokens, cfg.d_model), generator=g)
    return {k: v.to(device) for k, v in batch.items()}


def _full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _shards_match(tree, spec_of, mesh) -> int:
    """How many DTensor leaves of ``tree`` hold a shard of the shape
    their rule ``spec_of(path, leaf)`` gives; raises on one that does
    not."""
    from repro_torch.launch.sharding import local_shape
    from repro_torch.optim.adamw import leaves
    n = 0
    for path, t in leaves(tree):
        spec = spec_of(path, t)
        want = local_shape(t.shape, spec, mesh)
        if tuple(t.to_local().shape) != want:
            raise AssertionError(f"{path}: shard {tuple(t.to_local().shape)}"
                                 f", its rule {spec} gives {want}")
        n += 1
    return n


def mesh_serve(mesh, device, data, *, arch, layout="tp", smoke=True,
               n_layers=None, dtype=None, over=None, B=4, S=16,
               n_tokens=3, params=None, seed=0, one_rank=True,
               generate=True):
    """One model served under ``mesh`` through the entry points a user
    calls with the sharder: the parameters (the caller's reference pytree
    ``data[params]``, else the port's ``init_params`` from ``seed``)
    placed by ``param_spec``, a prompt [B, S] from ``seed + 1``, then
    ``prefill_step``, ``n_tokens - 1`` greedy ``serve_step``s and, with
    ``generate``, ``generate`` of ``n_tokens``. Rank 0 returns the
    prompt, the prefill's and the first decode's logits (whole, numpy),
    the greedy tokens, how many parameter and cache shards have their
    rule's shape, and per rank the prefill and decode times, the peak
    memory, the bytes by collective (``hostwire.WIRE``) and the kernel
    launches of those calls (``ops``' counters, set to 0 before them);
    with ``one_rank`` also the same calls unsharded on the rank
    (``one_rank``) and ``teacher_forced``: the one-rank port's greedy
    choice at each step, fed the mesh's tokens, is the mesh's next
    token."""
    from repro_torch import convert
    from repro_torch.launch import hostwire
    from repro_torch.launch.sharding import (cache_spec, make_sharder,
                                             param_spec)
    from repro_torch.models import transformer as T
    from repro_torch import serve as E
    cfg = _model_cfg(arch, smoke=smoke, n_layers=n_layers, dtype=dtype,
                     over=over)
    sh = make_sharder(mesh, multi_pod=False, batch=B, layout=layout)
    if params is not None:
        full = convert.model_params_from_reference(data[params], cfg,
                                                   device)
    else:
        full = T.init_params(cfg, seed=seed, device=device)
    batch = _prompt(cfg, B, S, seed + 1, device)
    out = {"batch": {k: v.cpu().numpy() for k, v in batch.items()}}
    with torch.no_grad():
        pp = convert.place_params(full, cfg, mesh, layout=layout)
        if not one_rank:
            del full
        pb = convert.place_batch(batch, sh)
        out["param_shards"] = _shards_match(
            pp, lambda p, t: param_spec(p, t, cfg, mesh, layout), mesh)
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        hostwire.reset_wire()
        _sync(device)
        t0 = time.perf_counter()
        last, caches = E.prefill_step(pp, pb, cfg, sh)
        _sync(device)
        prefill_s = time.perf_counter() - t0
        flash = ops.LAUNCHES["flash_attention"]
        wire_prefill = copy.deepcopy(hostwire.WIRE)
        hostwire.reset_wire()
        caches = convert.place_caches(T.pad_caches(caches, S + n_tokens),
                                      cfg, sh)
        out["cache_shards"] = _shards_match(
            caches, lambda p, t: cache_spec(p, t, cfg, sh, mesh), mesh)
        tok = E.pick(last, cfg, sharder=sh)
        toks, decode_s = [tok], []
        out["prefill_logits"] = _full(last).float().cpu().numpy()
        for i in range(1, n_tokens):
            _sync(device)
            t0 = time.perf_counter()
            logits, caches = E.serve_step(pp, caches, toks[-1], S + i - 1,
                                          cfg, sh)
            toks.append(E.pick(logits, cfg, sharder=sh))
            _sync(device)
            decode_s.append(time.perf_counter() - t0)
            if i == 1:
                out["decode_logits"] = _full(logits).float().cpu().numpy()
        wire_decode = copy.deepcopy(hostwire.WIRE)
        greedy = _full(torch.cat(toks, dim=1))
        out["greedy"] = greedy.cpu().numpy()
        out["decode_token"] = out["greedy"][:, :1]
        if generate:
            gen = _full(E.generate(pp, pb, cfg, n_tokens=n_tokens,
                                   sharder=sh))
            out["generated"] = gen.cpu().numpy()
        r = {"prefill_s": prefill_s, "decode_s": decode_s,
             "flash_launches_prefill": flash,
             "wire_prefill": wire_prefill, "wire_decode": wire_decode,
             "counters": _counters(),
             "flash_routes": dict(ops.FLASH_ROUTES)}
        if device.type == "cuda":
            r["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        out["ranks"] = _per_rank(r)
        del pp, caches
        if one_rank:
            l1, c1 = E.prefill_step(full, batch, cfg)
            c1 = T.pad_caches(c1, S + n_tokens)
            agree = bool(torch.equal(E.pick(l1, cfg), greedy[:, :1]))
            one = {"prefill_logits": l1.float().cpu().numpy()}
            for i in range(1, n_tokens):
                d1, c1 = E.serve_step(full, c1, greedy[:, i - 1:i],
                                      S + i - 1, cfg)
                if i == 1:
                    one["decode_logits"] = d1.float().cpu().numpy()
                agree &= bool(torch.equal(E.pick(d1, cfg),
                                          greedy[:, i:i + 1]))
            out["teacher_forced"] = agree
            if generate:
                one["generated"] = E.generate(full, batch, cfg,
                                              n_tokens=n_tokens).cpu().numpy()
            out["one_rank"] = one
    return out if dist.get_rank() == 0 else None


def moe_ep(mesh, device, data, *, cfg, params="moe_params", x="moe_x",
           seed=None, x_shape=None, capacity_factors=(None, 1.0)):
    """The expert-parallel MoE (``moe.moe_ffn`` under the mesh's sharder,
    EP over ``model``) on the caller's parameters and input, or, with
    ``seed``, on ``moe.moe_params`` and an input of ``x_shape`` drawn
    from a generator on ``device`` seeded with it: for each capacity
    factor (None: the config's), rank 0 returns the routed output (the
    block's output less the shared experts', whole, numpy), whether every
    value is finite, and the aux, and the port's dense oracle."""
    import torch.nn.functional as F
    from repro_torch import convert
    from repro_torch.launch.sharding import make_sharder, param_spec
    from repro_torch.models import moe
    from repro_torch.models.common import ModelConfig, matmul
    base = ModelConfig(**cfg)
    if seed is None:
        p = {k: (convert._tensor(v, device) if not isinstance(v, dict) else
                 {n: convert._tensor(a, device) for n, a in v.items()})
             for k, v in data[params].items()}
        xs = torch.as_tensor(data[x], device=device)
    else:
        g = torch.Generator(device=device).manual_seed(seed)
        p = moe.moe_params(base, generator=g, device=device)
        xs = torch.randn(x_shape, generator=g, device=device).to(base.adt)
    sh = make_sharder(mesh, multi_pod=False, batch=xs.shape[0])
    res = []
    with torch.no_grad():
        dense = moe.moe_ffn_dense_reference(xs, p, base)
        sp = p["shared"]
        shared = matmul(F.silu(matmul(xs, sp["w_gate"])) * matmul(
            xs, sp["w_in"]), sp["w_out"])
        pp = convert._tree_placed(
            p, lambda path, t: param_spec(f"layers/0/moe/{path}", t, base,
                                          mesh), mesh)
        xd = convert.place_batch({"x": xs}, sh)["x"]
        for cf in capacity_factors:
            c = base if cf is None else base.replace(moe_capacity_factor=cf)
            routed, aux = moe.moe_ffn(xd, pp, c, sh)
            got = _full(routed) - shared
            res.append({"capacity_factor": c.moe_capacity_factor,
                        "routed": got.float().cpu().numpy(),
                        "finite": bool(torch.isfinite(got).all()),
                        "aux": float(aux)})
    return ({"cases": res, "dense": dense.float().cpu().numpy()}
            if dist.get_rank() == 0 else None)


# ---------------------------------------------------------------------------
# training under a data x model mesh
# ---------------------------------------------------------------------------
def _train_cfg(optimizer, lr, block, accum, ladder=None,
               state_dtype="f32"):
    """AdamW (no warmup; moments in ``state_dtype``) or TreeNewton with a
    refactor every step (the default bf16_f32 ladder, or ``ladder``'s)."""
    from repro_torch.optim import AdamWConfig, TreeNewtonConfig
    from repro_torch.train import TrainConfig
    adam = AdamWConfig(lr=lr, warmup=0, total_steps=100,
                       state_dtype=state_dtype)
    tn = TreeNewtonConfig(adam=adam, block=block, factor_every=1,
                          stats_every=1)
    if ladder is not None:
        tn = dataclasses.replace(tn, precision=_cfg(ladder, leaf=128))
    return TrainConfig(optimizer=optimizer, adam=adam, tree_newton=tn,
                       accum=accum)


def _batches(cfg, B, S, seed):
    """Step ``i``'s batch (numpy), the same on every rank:
    ``data.SyntheticLM`` from ``seed``."""
    from repro_torch.data import SyntheticLM
    data = SyntheticLM(cfg.vocab, B, S, seed=seed,
                       n_codebooks=cfg.n_codebooks,
                       n_img_tokens=cfg.n_img_tokens, d_model=cfg.d_model)
    return data.get


def _on(batch, device, accum):
    from repro_torch.train import reshape_for_accum
    return reshape_for_accum({k: torch.from_numpy(v).to(device)
                              for k, v in batch.items()}, accum)


def _steps(step_fn, state, batch_of, first, n, device, place=None):
    """``n`` steps from step ``first``; per step the loss and, on a mesh,
    the step's seconds, bytes by collective and launches."""
    from repro_torch.launch import hostwire
    out = {"losses": [], "grad_norms": [], "step_s": [], "wire": [],
           "launches": [], "batched": [], "flash_routes": []}
    for i in range(first, first + n):
        batch = batch_of(i)
        if place is not None:
            batch = place(batch)
        ops.reset_launches()
        hostwire.reset_wire()
        _sync(device)
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        loss = float(m["loss"])
        _sync(device)
        out["step_s"].append(time.perf_counter() - t0)
        out["losses"].append(loss)
        out["grad_norms"].append(float(m["grad_norm"]))
        out["wire"].append(copy.deepcopy(hostwire.WIRE))
        out["launches"].append(dict(ops.LAUNCHES))
        out["batched"].append(dict(ops.BATCHED))
        out["flash_routes"].append(dict(ops.FLASH_ROUTES))
    return state, out


def _params_gap(placed, ref, adam, steps) -> dict | None:
    """The placed train state's parameters and first moments against
    ``ref``'s (:func:`_single_card`'s host copies on rank 0, None
    elsewhere; every rank takes part, each leaf gathered to rank 0 in
    turn): ``resolved``, max |placed - ref| where ref's first moment says
    |g| > 100 eps; ``unresolved_steps``, the largest |placed - ref|
    elsewhere in units of ``steps`` steps' size lr (1 + wd |p|), where
    AdamW's g / (|g| + eps) moves with the last bits of g
    (tests/test_torch_train.py); ``all``, the max over every entry;
    ``m_rel``, the first moments' largest gap over a leaf's largest
    |m|: after one step m = (1 - b1) g, so it reads the gradient's
    magnitude, which AdamW's first update does not (TreeNewton's whitened
    leaves apart, under ``m_rel_whitened``: their statistics hold their
    gradients)."""
    from repro_torch.launch.hostwire import gather_to
    from repro_torch.optim.adamw import leaves, schedule
    gap = {"resolved": 0.0, "unresolved_steps": 0.0, "all": 0.0,
           "m_rel": 0.0, "m_rel_whitened": 0.0}
    lr = float(schedule(adam, steps))
    opt = placed["opt"]
    moments = dict(leaves((opt["adam"] if "stats" in opt else opt)["m"]))
    for p, a in leaves(placed["params"]):
        full, m = gather_to(a, (0,)), gather_to(moments[p], (0,))
        if ref is not None:
            w = ref["params"][p].float()
            err = (full.float() - w).abs()
            res = ref["m"][p].float().abs() / (1 - adam.b1) > 100 * adam.eps
            step = steps * lr * (1 + adam.weight_decay * w.abs())
            gap["all"] = max(gap["all"], float(err.max()))
            if res.any():
                gap["resolved"] = max(gap["resolved"],
                                      float(err[res].max()))
            if (~res).any():
                gap["unresolved_steps"] = max(
                    gap["unresolved_steps"],
                    float((err[~res] / step[~res]).max()))
            key = "m_rel_whitened" if p in ref.get("stats", {}) else "m_rel"
            gap[key] = max(gap[key], _rel(m, ref["m"][p]))
        del full, m
    return gap if ref is not None else None


def _rel(got, want) -> float:
    """max|got - want| / max|want| (0 where both are 0)."""
    g, w = got.double(), want.to(got.device).double()
    err = float((g - w).abs().max())
    return err / float(w.abs().max()) if err else 0.0


def _first_step_gaps(placed, ref, tcfg, optimizer) -> dict:
    """After one step: the parameters' and first moments' gaps
    (:func:`_params_gap`) and, for TreeNewton, the statistics' and
    factors' (each matrix against its largest entry), the ranks' held
    matrices gathered onto rank 0."""
    out = {"params_gap": _params_gap(placed, ref, tcfg.adam, 1)}
    if optimizer == "tree_newton":
        for part in ("stats", "factors"):
            mine = {p: t.cpu() for p, t in placed["opt"][part].items()
                    if t.device.type != "meta"}
            every = {}
            for h in _per_rank(mine):
                every.update(h)
            if ref is not None:
                out[f"{part}_rel"] = _stats_rel(every, ref[part])
    return out


def _stats_rel(got, want) -> float:
    """max over matrices of max|got - want| / max|want|."""
    return max((_rel(got[p], w) for p, w in want.items()), default=0.0)


def mesh_train(mesh, device, data, *, arch, layout="tp", smoke=True,
               n_layers=2, dtype="f32", over=None, optimizer="adamw",
               accum=1, B=4, S=16, steps=1, seed=0, params=None, lr=1e-2,
               block=64, ladder=None, one_rank=False, return_state=False,
               fixed_batch=False, place_whole=False):
    """``steps`` train steps under the mesh's sharder (``layout``): the
    port's parameters from ``seed`` (or the caller's reference pytree
    ``data[params]``), placed, and the optimizer's state made on them
    (``init_opt(..., mesh)``), batches from ``SyntheticLM(seed)`` placed
    by ``place_batch`` (``accum`` microbatches). Rank 0 returns
    the losses, per rank the step seconds, peak GiB, bytes by collective
    and launches of each step; with ``return_state`` the final state
    gathered whole (numpy, the reference's layout), and with
    ``one_rank`` the same steps unsharded on rank 0 and the gaps:
    losses, parameters, TreeNewton's statistics and factors (each matrix
    against its largest entry). ``fixed_batch`` trains every step on the
    first batch. No rank holds a whole optimizer state but rank 0 with
    ``one_rank``, unless ``place_whole``: then every rank makes the whole
    state and places it (``convert.place_train_state``)."""
    from repro_torch import convert
    from repro_torch.launch.sharding import make_sharder
    from repro_torch.models import transformer as T
    from repro_torch.train import make_train_step
    from repro_torch.train.step import init_opt
    cfg = _model_cfg(arch, smoke=smoke, n_layers=n_layers, dtype=dtype,
                     over=over)
    tcfg = _train_cfg(optimizer, lr, block, accum, ladder)
    sh = make_sharder(mesh, multi_pod=False, batch=B // accum,
                      layout=layout)
    full = (convert.model_params_from_reference(data[params], cfg, device)
            if params is not None else
            T.init_params(cfg, seed=seed, device=device))
    with torch.no_grad():
        if place_whole:
            placed = convert.place_train_state(
                {"params": full, "opt": init_opt(full, tcfg), "step": 0},
                cfg, mesh, layout=layout)
        else:
            pp = convert.place_params(full, cfg, mesh, layout=layout)
            placed = {"params": pp, "opt": init_opt(pp, tcfg, mesh),
                      "step": 0}
    draw = _batches(cfg, B, S, seed + 1)
    batch_of = (lambda i: _on(draw(0 if fixed_batch else i), device,
                              accum))
    # the single card first, on rank 0 (the others wait at the mesh's
    # first collective); its first step is kept on the host
    ref = _single_card(cfg, tcfg, full, batch_of, steps, device) \
        if one_rank and dist.get_rank() == 0 else None
    del full
    _release(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    mesh_fn = make_train_step(cfg, tcfg, sh)
    place = (lambda b: convert.place_batch(b, sh, accum=accum))
    # with one_rank, the gaps after the first step (the reference's test
    # is one step: a second one starts from parameters that differ where
    # g / (|g| + eps) read the last bits of a tiny g), the losses of all
    placed, r = _steps(mesh_fn, placed, batch_of, 0, 1 if one_rank else
                       steps, device, place)
    if one_rank:
        gaps = _first_step_gaps(placed, ref, tcfg, optimizer)
        if steps > 1:
            placed, more = _steps(mesh_fn, placed, batch_of, 1, steps - 1,
                                  device, place)
            for k, v in more.items():
                r[k] += v
    if device.type == "cuda":
        r["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    held = [p for p, t in placed["opt"].get("stats", {}).items()
            if t.device.type != "meta"]
    r["stats_held"] = len(held)
    ranks = _per_rank(r)
    out = {"losses": r["losses"], "grad_norms": r["grad_norms"],
           "ranks": ranks, "held": [x["stats_held"] for x in ranks]}
    if return_state:
        g = convert.gather_train_state(placed)
        if g is not None:
            out["state"] = {"params": convert.model_params_to_numpy(
                g["params"]), "opt": convert.opt_state_to_numpy(g["opt"]),
                "step": g["step"]}
    if one_rank:
        out.update(gaps)
        if ref is not None:
            out["one_rank"] = ref["run"]
    del placed
    _release(device)
    return out if dist.get_rank() == 0 else None


def _single_card(cfg, tcfg, params, batch_of, steps, device) -> dict:
    """``steps`` unsharded steps from ``params`` (updated in place): the
    run's losses and launches, and the parameters, first moments and
    TreeNewton matrices after the first step, copied to the host."""
    from repro_torch.optim.adamw import leaves
    from repro_torch.train import make_train_step
    from repro_torch.train.step import init_opt
    state = {"params": params, "opt": init_opt(params, tcfg), "step": 0}
    fn = make_train_step(cfg, tcfg)
    state, r = _steps(fn, state, batch_of, 0, 1, device)
    opt = state["opt"]

    def copy(tree):         # the state moves on in place
        return {p: t.to("cpu", copy=True) for p, t in tree}
    host = {"params": copy(leaves(state["params"])),
            "m": copy(leaves((opt["adam"] if "stats" in opt else opt)["m"]))}
    for part in ("stats", "factors"):
        if part in opt:
            host[part] = copy(opt[part].items())
    if steps > 1:
        state, more = _steps(fn, state, batch_of, 1, steps - 1, device)
        for k, v in more.items():
            r[k] += v
    host["run"] = {k: r[k] for k in ("losses", "grad_norms", "launches",
                                     "batched")}
    return host


def single_card_train(device, *, arch, smoke=True, n_layers=2, dtype="f32",
                      over=None, optimizer="adamw", B=4, S=16, steps=1,
                      seed=0, lr=1e-2, block=64, ladder=None,
                      fixed_batch=False) -> dict:
    """:func:`mesh_train`'s run with the same arguments (the same
    parameters, batches and optimizer) in one process with no mesh: its
    losses, gradient norms and step seconds."""
    from repro_torch.models import transformer as T
    from repro_torch.train import make_train_step
    from repro_torch.train.step import init_opt
    device = torch.device(device)
    cfg = _model_cfg(arch, smoke=smoke, n_layers=n_layers, dtype=dtype,
                     over=over)
    tcfg = _train_cfg(optimizer, lr, block, 1, ladder)
    params = T.init_params(cfg, seed=seed, device=device)
    draw = _batches(cfg, B, S, seed + 1)
    state = {"params": params, "opt": init_opt(params, tcfg), "step": 0}
    state, r = _steps(make_train_step(cfg, tcfg), state,
                      lambda i: _on(draw(0 if fixed_batch else i), device, 1),
                      0, steps, device)
    del state, params
    _release(device)
    return {k: r[k] for k in ("losses", "grad_norms", "step_s")}


def _placed_state(cfg, tcfg, mesh, layout, device, seed):
    """``init_state`` on ``mesh``: the parameters drawn whole and placed,
    the optimizer's state made on the placed ones."""
    from repro_torch import convert
    from repro_torch.models import transformer as T
    from repro_torch.train.step import init_opt
    with torch.no_grad():
        pp = convert.place_params(T.init_params(cfg, seed=seed,
                                                device=device), cfg, mesh,
                                  layout=layout)
    return {"params": pp, "opt": init_opt(pp, tcfg, mesh), "step": 0}


def elastic(mesh, device, data, *, arch, ckpt_dir, smoke=True, n_layers=2,
            dtype="f32", over=None, optimizer="adamw", B=4, S=16, first=3,
            more=2, seed=0, lr=1e-2, block=64, state_dtype="f32",
            byte_check=False):
    """The reference's elastic test (tests/test_elastic.py) on this
    group: ``first`` steps on the (2, 2) mesh under ``tp``, a save
    (every rank writes its slices), ``more`` steps as the reference
    trajectory; then the checkpoint restored with ``shardings`` onto a
    (4, 1) mesh under ``ddp`` and, on rank 0, into one process with no
    mesh, each running the same ``more`` steps. Rank 0 returns the
    losses of each and the parameter gaps to the trajectory's; with
    ``byte_check`` whether every saved file equals, byte for byte, a
    one-process save of the same state gathered whole."""
    import filecmp
    import os
    import shutil
    from repro_torch import checkpoint as ckpt
    from repro_torch import convert
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import make_sharder
    from repro_torch.models.common import NO_SHARD
    from repro_torch.optim.adamw import leaves
    from repro_torch.train import init_state, make_train_step
    cfg = _model_cfg(arch, smoke=smoke, n_layers=n_layers, dtype=dtype,
                     over=over)
    tcfg = _train_cfg(optimizer, lr, block, 1, state_dtype=state_dtype)
    me = dist.get_rank()
    batch_of = _batches(cfg, B, S, seed + 1)
    out = {}

    def run(state, sharder, first_step, n):
        fn = make_train_step(cfg, tcfg, sharder)
        place = (None if not sharder.enabled else
                 lambda b: convert.place_batch(b, sharder))
        return _steps(fn, state, lambda i: _on(batch_of(i), device, 1),
                      first_step, n, device, place)

    sh = make_sharder(mesh, multi_pod=False, batch=B)
    state = _placed_state(cfg, tcfg, mesh, "tp", device, seed)
    state, r0 = run(state, sh, 0, first)
    t0 = time.perf_counter()
    h = ckpt.save(ckpt_dir, first, convert.train_state_layout(state),
                  blocking=True)
    out["save_s"] = time.perf_counter() - t0
    out["ckpt_bytes"] = sum(os.path.getsize(os.path.join(h.final, f))
                            for f in os.listdir(h.final)) if me == 0 else 0
    if byte_check:
        whole = convert.gather_train_state(state)
        if me == 0:
            one = ckpt.save(ckpt_dir + "_one", first,
                            convert.train_state_layout(whole),
                            blocking=True).wait()
            names = sorted(os.listdir(h.final))
            out["byte_equal"] = (names == sorted(os.listdir(one)) and all(
                filecmp.cmp(os.path.join(h.final, f),
                            os.path.join(one, f), shallow=False)
                for f in names))
            shutil.rmtree(ckpt_dir + "_one")
        del whole
    state, ref = run(state, sh, first, more)
    want = None
    if me == 0:
        want = _gathered_params(state)
    else:
        _gathered_params(state)
    del state
    _release(device)
    out["first_losses"], out["ref_losses"] = r0["losses"], ref["losses"]

    # onto (4, 1) under ddp, restored with the new mesh's shardings
    mesh4 = make_host_mesh(4, 1, device_type=device.type)
    sh4 = make_sharder(mesh4, multi_pod=False, batch=B, layout="ddp")
    template = init_state(cfg, tcfg, device="meta")
    t0 = time.perf_counter()
    layout, s0 = ckpt.restore(ckpt_dir, convert.train_state_layout(template),
                              shardings=convert.train_state_shardings(
                                  template, cfg, mesh4, layout="ddp"))
    restored = convert.train_state_from_layout(layout, template)
    out["restore_s"] = time.perf_counter() - t0
    restored, r4 = run(restored, sh4, s0, more)
    got = _gathered_params(restored)
    del restored
    _release(device)
    out["mesh_4x1"] = {"start": s0, "losses": r4["losses"]}

    # one process, no mesh; its second moments tell which gradients both
    # trajectories resolve
    if me == 0:
        one = init_state(cfg, tcfg, seed=seed + 7, device=device)
        lay, s1 = ckpt.restore_into(ckpt_dir, convert.train_state_layout(one))
        one = convert.train_state_from_layout(lay, one)
        one, r1 = run(one, NO_SHARD, s1, more)
        adam = one["opt"]["adam"] if "stats" in one["opt"] else one["opt"]
        v = {p: t.cpu() for p, t in leaves(adam["v"])}
        resolve = (tcfg.adam, adam["count"], v, more)
        out["one_process"] = {"start": s1, "losses": r1["losses"],
                              "params_gap": _gap(
                                  {p: t.cpu() for p, t in
                                   leaves(one["params"])}, want, resolve)}
        out["mesh_4x1"]["params_gap"] = _gap(got, want, resolve)
        del one
    dist.barrier()
    if me == 0:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return out if me == 0 else None


def _release(device) -> None:
    """Hand the card's cached blocks back (the ranks share one card)."""
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _gathered_params(state) -> dict:
    """``{path: whole tensor}`` of a placed state's parameters on rank 0's
    host (every rank takes part; the others get an empty dict)."""
    from repro_torch.launch.hostwire import gather_to
    from repro_torch.optim.adamw import leaves
    out = {}
    for p, t in leaves(state["params"]):
        full = gather_to(t, (0,))
        if full is not None:
            out[p] = full
    return out


def _gap(got, want, resolve=None) -> dict:
    """``max_abs`` of got - want over the parameters; with ``resolve`` =
    (AdamW config, count, second moments, steps) also ``resolved``, the
    max where the bias-corrected second moment resolves the gradient
    (sqrt(v / (1 - b2^count)) > 100 eps), and ``beyond``: how many
    entries differ by more than 1e-4 there, or elsewhere by more than the
    steps' own size lr (1 + wd |w|) (AdamW's m / sqrt(v) reads the last
    bits of a gradient near 0)."""
    from repro_torch.optim.adamw import schedule
    worst, res_worst, beyond = 0.0, 0.0, 0
    for p, w in want.items():
        w = w.float()
        err = (got[p].float() - w).abs()
        worst = max(worst, float(err.max()))
        if resolve is None:
            continue
        adam, count, v, steps = resolve
        res = torch.sqrt(v[p].float() / (1 - adam.b2 ** count)) \
            > 100 * adam.eps
        lr = float(schedule(adam, count))
        bound = torch.where(res, torch.full_like(w, 1e-4),
                            steps * lr * (1 + adam.weight_decay * w.abs()))
        if res.any():
            res_worst = max(res_worst, float(err[res].max()))
        beyond += int((err > bound).sum())
    out = {"max_abs": worst}
    if resolve is not None:
        out.update(resolved=res_worst, beyond=beyond)
    return out


MESH_CASES = {"mesh_serve": mesh_serve, "moe_ep": moe_ep,
              "mesh_train": mesh_train, "elastic": elastic}


def run_mesh_cases(cases, device="cuda", data=None, mesh_shape=(2, 2)):
    """Every rank's target for the model mesh: each ``{"kind": name,
    **arguments}`` of ``cases`` in order on ``make_host_mesh(*mesh_shape)``
    (``data x model``). Returns the cases' results on rank 0, None
    elsewhere."""
    from repro_torch.launch.mesh import make_host_mesh
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    mesh = make_host_mesh(*mesh_shape, device_type=device.type)
    out = []
    for case in cases:
        case = dict(case)
        out.append(MESH_CASES[case.pop("kind")](mesh, device, data or {},
                                                **case))
    return out if dist.get_rank() == 0 else None


def run_cases(cases, device="cuda", data=None) -> list | None:
    """Every rank's target: each ``{"kind": name, **arguments}`` of
    ``cases`` in order, on a 1-D mesh of all ranks named "model"; ``data``
    holds the caller's named arrays, which a case's ``matrix=`` or
    ``rhs=`` names. Returns the cases' results on rank 0, None
    elsewhere."""
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh((dist.get_world_size(),), ("model",), device.type)
    out = []
    for case in cases:
        case = dict(case)
        out.append(CASES[case.pop("kind")](mesh, device, data or {}, **case))
    return out if dist.get_rank() == 0 else None
