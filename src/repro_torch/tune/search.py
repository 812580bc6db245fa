"""Measured-search autotuner over the plan/engine knob space, in torch.

Counterpart of ``repro/tune/search.py``. :func:`autotune` races candidate
configurations over the knobs the port's speed hinges on (execution
engine, tree vs blocked; leaf size; the serving batch width), times each
with a host-clock median (:func:`timeit`), and returns a tuning-database
payload (:mod:`repro_torch.tune.db`) whose entries record both the
winning choice and every raw measurement. Engine winners are also
interpolated into a **crossover** size per ``(backend, ladder,
nshards)``: the problem size where the blocked engine starts beating the
tree engine.

Everything here is deterministic given deterministic timings: candidates
enumerate in a fixed order, ties break toward the tree engine (the
conservative below-crossover choice) and the smaller knob value, and the
payload carries no timestamps, so two runs with identical timer results
produce byte-identical databases, the same bytes as the reference's.

Competing candidates are timed **interleaved** (:func:`race`: round-robin
rounds, per-candidate minimum), and engine decisions carry a relative
noise tolerance (:data:`REL_TOL`): the blocked engine must beat the tree
by more than timer noise to win a size, both in the per-entry choice and
in the crossover interpolation.

With ``nshards >= 2`` the search also races the distributed path
(:func:`~repro_torch.core.distributed.dist_cholesky` on a 1-D mesh of
``nshards`` ranks): both local engines on full-precision gathers, the
compressed collective, and the size from which the distributed factor
beats the best single-device one (``dist_threshold``). That grid runs
collectively: every rank of a ``torch.distributed`` group of ``nshards``
calls :func:`autotune` with the same arguments (``python -m
repro_torch.tune --nshards P`` starts the ranks). Rank 0 alone races the
single-device grid and the serving width, so those races do not share
the ranks' card, and its payload is the one every rank returns.
"""
from __future__ import annotations

import functools
import math
import time

import numpy as np
import torch

from repro_torch.tune.db import DEFAULTS, SCHEMA_VERSION, validate_db

#: relative timer-noise allowance for engine decisions: blocked must win
#: by more than this margin, else the conservative tree choice stands
REL_TOL = 0.03

#: candidate grids (fixed enumeration order = deterministic tie-breaks)
LEAVES = (128, 256)
ENGINES = ("tree", "blocked")
MAX_BATCHES = (8, 16, 32)

DIST_LEAF = 128         # several tile rows per shard at the grid's sizes

SMOKE_SIZES = (256, 512)
SMOKE_DIST_SIZES = (512, 1024)
#: the reference's grids (512 .. 2048, chosen for a CPU) widened to the
#: sizes the card's paths run
FULL_SIZES = (512, 1024, 2048, 4096, 8192, 16384)
FULL_DIST_SIZES = FULL_SIZES


def timeit(fn, *args, warmup=2, iters=5, device="cuda"):
    """Median wall time in microseconds of ``fn(*args)`` on the host clock,
    with ``torch.cuda.synchronize()`` before and after each call when
    ``device`` is a CUDA device (the port's kernels return before the card
    has finished)."""
    if torch.device(device).type == "cuda":
        sync = torch.cuda.synchronize
    else:
        def sync():
            pass
    for _ in range(warmup):
        fn(*args)
    sync()
    ts = []
    for _ in range(iters):
        sync()
        t0 = time.perf_counter()
        fn(*args)
        sync()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts) * 1e6)


def _spd(n, dtype=np.float32, seed=0):
    """Paper §IV-A test matrix (the reference tuner's generator)."""
    rng = np.random.default_rng(seed)
    m = rng.uniform(-1.0, 1.0, (n, n))
    a = (m + m.T) / 2
    a[np.diag_indices(n)] += n
    return a.astype(dtype)


def interp_crossover(ns, t_tree, t_blocked, rel_tol=REL_TOL):
    """Interpolated n where blocked starts beating tree (log2 space).

    Returns ``None`` when tree holds the top of the grid (never
    crosses for good), the smallest measured n when blocked wins
    everywhere, otherwise the linearly interpolated size at the **last**
    tree->blocked flip: blocked must win every grid point from the
    crossover up, so an isolated blocked "win" at a small size (noise)
    cannot drag the crossover below sizes the tree measurably owns.
    Blocked "wins" a grid point only by more than ``rel_tol``. The
    per-entry engine choices are re-derived from this fitted crossover
    (:func:`_refit_engines`), so exact-entry and crossover lookups agree
    at every measured size by construction.
    """
    # margin over the noise floor; > 0 means blocked measurably wins
    g = [tt - tb - rel_tol * tb for tt, tb in zip(t_tree, t_blocked)]
    if all(x > 0 for x in g):
        return int(ns[0])
    k = max(i for i, x in enumerate(g) if x <= 0)    # last tree win
    if k == len(ns) - 1:
        return None
    lo, hi = math.log2(ns[k]), math.log2(ns[k + 1])
    frac = -g[k] / (g[k + 1] - g[k])
    return int(round(2 ** (lo + frac * (hi - lo))))


def _won(t_tree, t_blocked, rel_tol=REL_TOL) -> str:
    """Engine pick with the noise margin: blocked must beat the tree by
    more than ``rel_tol`` of its own time, else tree stands."""
    return "blocked" if t_tree - t_blocked > rel_tol * t_blocked else "tree"


#: interleaved timing rounds per candidate race: transient load inflates
#: one round for every candidate instead of one candidate's whole budget,
#: and the per-candidate minimum discards inflated rounds
RACE_ROUNDS = 3


def race(timer, cands):
    """Time competing candidates round-robin; returns ``{name: us}``.

    ``cands`` is an ordered ``{name: make}`` where ``make()`` builds the
    candidate and returns ``(fn, args)``; each round gets a **fresh**
    build (the tuner's makers copy A anew on the device), so a slow
    allocation layout cannot stick to one candidate. Interleaved rounds
    and the per-candidate minimum make the comparison differential.
    """
    results = {k: [] for k in cands}
    for _ in range(RACE_ROUNDS):
        for k, make in cands.items():
            fn, args = make()
            results[k].append(timer(fn, *args))
    return {k: min(v) for k, v in results.items()}


# ---------------------------------------------------------------------------
# per-key candidate measurement
# ---------------------------------------------------------------------------
def _tune_single(n, levels, timer, log, device="cuda"):
    """Engine x leaf race on the single-device factorization."""
    from repro_torch.core.precision import PrecisionConfig
    from repro_torch.core.solve import as_tensor, cholesky
    a = as_tensor(_spd(n), device)
    cands = {}
    for eng in ENGINES:
        for leaf in LEAVES:
            if n % leaf != 0 or n < leaf:
                continue
            cfg = PrecisionConfig(levels=levels, leaf=leaf, engine=eng)
            cands[f"us_{eng}_leaf{leaf}"] = lambda cfg=cfg: (
                functools.partial(cholesky, cfg=cfg), (a.clone(),))
    meas = {}
    for name, t in race(timer, cands).items():
        meas[name] = round(t, 1)
        eng, leaf = name[3:].rsplit("_leaf", 1)
        log(f"tune_local_n{n}_{eng}_leaf{leaf}", t, "nshards=1")
    # per-engine best (over leaves) feeds both the noise-margined engine
    # pick and the crossover interpolation
    per_engine = {e: min(v for k, v in meas.items()
                         if k.startswith(f"us_{e}_"))
                  for e in ENGINES if any(k.startswith(f"us_{e}_")
                                          for k in meas)}
    eng = _won(per_engine.get("tree", math.inf),
               per_engine.get("blocked", math.inf))
    best = min((k for k in meas if k.startswith(f"us_{eng}_")),
               key=lambda k: (meas[k], k))
    choice = {"engine": eng,
              "leaf": int(best.rsplit("leaf", 1)[1])}
    return choice, meas, per_engine


def _tune_dist(n, levels, mesh, timer, log, device="cuda"):
    """Engine + collective-compression race on the distributed path (every
    rank runs it; each candidate call is collective)."""
    import dataclasses

    from repro_torch.core.distributed import dist_cholesky, shard_rows
    from repro_torch.core.precision import PrecisionConfig
    from repro_torch.core.solve import as_tensor
    cfg = PrecisionConfig(levels=levels, leaf=DIST_LEAF)
    a = as_tensor(_spd(n), device)
    nshards = mesh.size()

    # one interleaved race: both local engines on identical full-precision
    # gathers, plus the compressed collective on the blocked engine (its
    # f32 side is the blocked candidate)
    def make(cfg_e, cc):
        return lambda: (functools.partial(dist_cholesky, mesh=mesh,
                                          cfg=cfg_e, compress_comm=cc),
                        (shard_rows(a.clone(), mesh),))
    cands = {}
    for eng in ENGINES:
        cands[f"us_local_{eng}"] = make(dataclasses.replace(cfg, engine=eng),
                                        False)
    cands["us_comm_compressed"] = make(cfg, True)
    meas = {}
    for name, t in race(timer, cands).items():
        meas[name] = round(t, 1)
        log(f"tune_dist_n{n}_{name[3:]}", t, f"nshards={nshards}")
    meas["us_comm_f32"] = meas["us_local_blocked"]
    choice = {
        "engine": _won(meas["us_local_tree"], meas["us_local_blocked"]),
        "leaf": DIST_LEAF,
        "compress_comm": meas["us_comm_compressed"] <= meas["us_comm_f32"],
    }
    per_engine = {e: meas[f"us_local_{e}"] for e in ENGINES}
    return choice, meas, per_engine


def _tune_serving(levels, timer, log, *, n=256, n_rhs=16, device="cuda"):
    """Scheduler batch-width race: chunked multi-RHS refine calls."""
    from repro_torch.core.precision import PrecisionConfig
    from repro_torch.core.solve import as_tensor
    from repro_torch.serve import SolveOptions, SolverEngine
    cfg = PrecisionConfig(levels=levels, leaf=128)
    eng = SolverEngine(cfg, max_sweeps=4, device=device)
    a = as_tensor(_spd(n, seed=3), device)
    rng = np.random.default_rng(4)
    bs = [as_tensor(rng.standard_normal(n).astype(np.float32), device)
          for _ in range(n_rhs)]
    cands = {}
    for mb in MAX_BATCHES:
        def run(mb=mb):
            xs = []
            for i in range(0, n_rhs, mb):
                x, _ = eng.solve_batched(
                    a, bs[i:i + mb],
                    SolveOptions(target_digits=4, cache_key="tune"))
                xs.extend(x)
            return xs
        cands[f"us_serve_batch{mb}"] = lambda run=run: (run, ())
    meas = {}
    for name, t in race(timer, cands).items():
        meas[name] = round(t, 1)
        log(f"tune_serve_batch{name.rsplit('batch', 1)[1]}_n{n}", t,
            f"n_rhs={n_rhs}")
    best = min(MAX_BATCHES,
               key=lambda mb: (meas[f"us_serve_batch{mb}"], mb))
    # batching window sized to one solve call: a request never waits
    # longer than the latency of the work it would join
    t1 = timer(lambda: eng.solve(a, bs[0], SolveOptions(
        target_digits=4, cache_key="tune"))[0])
    meas["us_serve_single"] = round(t1, 1)
    max_wait_ms = float(min(50.0, max(1.0, round(t1 / 1e3, 1))))
    return {"max_batch": int(best), "max_wait_ms": max_wait_ms}, meas


def _refit_engines(entries, ladder, nshards, xn):
    """Re-derive each entry's engine from the fitted crossover side.

    The per-size :func:`_won` votes feed the crossover fit; the fit then
    overrides any vote it treated as noise, so exact-entry and crossover
    lookups agree at every measured size. The raw measurements stay
    untouched in the entry.
    """
    for e in entries:
        if e["ladder"] != ladder or e["nshards"] != nshards:
            continue
        want = "blocked" if xn is not None and e["n"] >= xn else "tree"
        if e["choice"]["engine"] != want:
            e["choice"]["engine"] = want
            meas = e["measurements"]
            leaves = [k for k in meas if k.startswith(f"us_{want}_leaf")]
            if leaves:     # single-device entries race leaf sizes too
                best = min(leaves, key=lambda k: (meas[k], k))
                e["choice"]["leaf"] = int(best.rsplit("leaf", 1)[1])


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------
def autotune(backend=None, *, ladders=("bf16_f32",), sizes=None,
             dist_sizes=None, smoke=False, timer=None, nshards=0,
             serving=True, log=None, device="cuda"):
    """Run the measured search on ``device``; returns a tuning-database
    payload.

    ``backend`` is the payload's key, the type of ``device`` by default.
    ``timer(fn, *args) -> us`` is injectable (tests pass a deterministic
    fake; the default is :func:`timeit`). ``ladders`` entries are
    canonical ladder keys (``"bf16_f32"``). ``nshards >= 2`` adds the
    distributed grid (``dist_sizes``); every rank of a process group of
    that size must then make the same call (module docstring).
    """
    backend = backend or torch.device(device).type
    sizes = tuple(sizes or (SMOKE_SIZES if smoke else FULL_SIZES))
    dist_sizes = tuple(dist_sizes
                       or (SMOKE_DIST_SIZES if smoke else FULL_DIST_SIZES))
    if timer is None:
        timer = functools.partial(timeit, warmup=1 if smoke else 2,
                                  iters=3 if smoke else 7, device=device)
    if log is None:
        def log(name, us, derived):
            print(f"{name},{us:.1f},{derived}", flush=True)
    lead, mesh = True, None
    if nshards >= 2:
        import torch.distributed as dist

        from repro_torch.launch.mesh import make_mesh
        if not dist.is_initialized() or dist.get_world_size() != nshards:
            raise ValueError(f"autotune(nshards={nshards}) runs on every "
                             f"rank of a process group of {nshards} "
                             "(repro_torch.launch.launch starts one)")
        mesh = make_mesh((nshards,), ("model",), torch.device(device).type)
        lead = dist.get_rank() == 0
        if not lead:
            def log(name, us, derived):
                pass

    entries, crossovers = [], []
    for ladder in ladders:
        levels = tuple(ladder.split("_"))
        serve_choice, serve_meas = ({}, {})
        singles = {}
        if serving and lead:
            serve_choice, serve_meas = _tune_serving(levels, timer, log,
                                                     device=device)
        # -- single-device grid (rank 0 alone) ----------------------------
        for n in sizes if lead else ():
            choice, meas, per_engine = _tune_single(n, levels, timer, log,
                                                    device)
            singles[n] = per_engine
            choice.update(serve_choice)
            meas.update(serve_meas if n == sizes[0] else {})
            entries.append({"backend": backend, "n": n, "ladder": ladder,
                            "nshards": 1, "choice": choice,
                            "measurements": meas})
        if lead:
            grid = sorted(singles)
            xn = interp_crossover(grid,
                                  [singles[n]["tree"] for n in grid],
                                  [singles[n]["blocked"] for n in grid])
            crossovers.append({
                "backend": backend, "ladder": ladder, "nshards": 1,
                "knob": "engine", "below": "tree", "above": "blocked",
                "n": xn})
            _refit_engines(entries, ladder, 1, xn)
        # -- distributed grid (every rank) -----------------------------------
        dists = {}
        for n in dist_sizes if nshards >= 2 else ():
            if n % (nshards * DIST_LEAF) != 0:
                continue
            choice, meas, per_engine = _tune_dist(n, levels, mesh, timer,
                                                  log, device)
            dists[n] = per_engine
            entries.append({"backend": backend, "n": n, "ladder": ladder,
                            "nshards": nshards, "choice": choice,
                            "measurements": meas})
        if dists:
            grid = sorted(dists)
            xn = interp_crossover(grid,
                                  [dists[n]["tree"] for n in grid],
                                  [dists[n]["blocked"] for n in grid])
            crossovers.append({
                "backend": backend, "ladder": ladder, "nshards": nshards,
                "knob": "engine", "below": "tree", "above": "blocked",
                "n": xn})
            _refit_engines(entries, ladder, nshards, xn)
            log(f"tune_crossover_{ladder}_p{nshards}", 0.0,
                f"engine_crossover_n={xn}")
        # dist_threshold: the smallest n where the distributed path beats
        # the best single-device engine; a grid where it never wins keeps
        # the default
        thr = DEFAULTS["dist_threshold"]
        wins = [n for n in sorted(set(singles) & set(dists))
                if min(dists[n].values()) < min(singles[n].values())]
        if wins:
            thr = int(wins[0])
        for e in entries:
            if e["ladder"] == ladder:
                e["choice"].setdefault("dist_threshold", thr)

    payload = {"version": SCHEMA_VERSION, "backend": backend,
               "smoke": bool(smoke), "sizes": list(sizes),
               "nshards_dist": nshards if nshards >= 2 else None,
               "entries": entries, "crossovers": crossovers}
    if mesh is not None:
        # rank 0 raced the single-device grid: its payload is the result
        import torch.distributed as dist
        box = [payload]
        dist.broadcast_object_list(box, src=0)
        payload = box[0]
    errs = validate_db(payload)
    assert not errs, f"autotune produced an invalid DB: {errs}"
    return payload
