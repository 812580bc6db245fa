"""The port's solve serving (``repro_torch.serve``), on the CPU.

The contracts of the reference's serving tests, held inside the port:
the solver half of tests/test_serve.py (factor cache, batching, ordering,
drain failures) and all of tests/test_serve_continuous.py, whose
load-bearing contract is DETERMINISM — a column's refinement trajectory is
bitwise the same in a window (``SolverEngine.solve_batched``) and in the
re-entrant slot loop (``BatchScheduler(continuous=True)``), whatever its
co-tenants or when it joined. The port holds it on the CPU for every
block width, width 1 included, because its plain products and norms are
summed column by column (kernels/ref.py, core/refine.py).
"""
from __future__ import annotations

import threading
import warnings

import numpy as np
import pytest
import torch

from repro_torch.serve import (BatchScheduler, InMemoryMetrics,
                               MetricsTracker, NullMetrics,
                               SchedulerOverload, ServeFrontend,
                               SolveOptions, SolverEngine)

torch.set_num_threads(2)

N = 64


def _spd(n=N, seed=0):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n))
    return (m @ m.T + n * np.eye(n)).astype(np.float32)


def _rhs(a, seed=0, k=None):
    rng = np.random.default_rng(100 + seed)
    shape = (a.shape[0],) if k is None else (a.shape[0], k)
    return (a @ rng.standard_normal(shape)).astype(np.float32)


def _engine(ladder="f16_f32", **kw):
    return SolverEngine(ladder, device="cpu", **kw)


@pytest.fixture(scope="module")
def eng():
    return _engine(max_sweeps=8, metrics=InMemoryMetrics())


# ---------------------------------------------------------------------------
# determinism: continuous == window, column for column
# ---------------------------------------------------------------------------
def test_continuous_matches_window_column_for_column(eng):
    """4 mixed-target requests through a 2-slot continuous loop (so two
    of them MUST join mid-flight) vs one windowed stacked call: same x,
    same sweep counts, same per-column residual histories."""
    a = _spd(seed=1)
    bs = [_rhs(a, seed=i) for i in range(4)]
    targets = [3.0, 6.0, 3.0, 6.0]

    xs_w, infos_w = eng.solve_batched(
        a, bs, SolveOptions(target_digits=targets, cache_key="det"))

    sch = BatchScheduler(eng, max_batch=2, continuous=True)
    sch.start()
    futs = [sch.submit_async(a, b, SolveOptions(target_digits=t,
                                                cache_key="det"))
            for b, t in zip(bs, targets)]
    outs = [f.result(timeout=120) for f in futs]
    sch.stop()

    for i, ((x_c, info_c), x_w, info_w) in enumerate(zip(outs, xs_w,
                                                         infos_w)):
        assert torch.equal(x_c, x_w), i
        assert info_c.sweeps == info_w.sweeps, i
        assert info_c.converged and info_w.converged, i
        assert info_c.history == info_w.history, i
        assert info_c.residual == pytest.approx(info_w.residual), i


@pytest.mark.parametrize("widths", [(2, 4), (1, 3)])
def test_continuous_blockwidth_invariance(eng, widths):
    """A request's result must not depend on the slot-block width it ran
    in; in the port that holds for width 1 too (column-wise products)."""
    a = _spd(seed=2)
    b = _rhs(a, seed=9)
    outs = []
    for slots in widths:
        sch = BatchScheduler(eng, max_batch=slots, continuous=True)
        sch.start()
        fut = sch.submit_async(a, b, SolveOptions(target_digits=6.0,
                                                  cache_key="width"))
        outs.append(fut.result(timeout=120))
        sch.stop()
    (x2, i2), (x4, i4) = outs
    assert torch.equal(x2, x4)
    assert i2.history == i4.history


# ---------------------------------------------------------------------------
# stepper-level: mid-flight join, retire-once
# ---------------------------------------------------------------------------
def test_midflight_join_preserves_histories(eng):
    """A column joining two sweeps into a stranger's run must follow the
    exact trajectory it has when running alone in the same slot block —
    co-tenancy (who else occupies the block, and when they joined) must
    not perturb a column."""
    a = _spd(seed=3)
    b0, b1 = _rhs(a, seed=0), _rhs(a, seed=1)
    stepper, base_solve, _ = eng.continuous_stepper(a, slots=3,
                                                    cache_key="join")
    tol = 1e-12                       # unreachable: run both to stall

    def prep(b):
        bb = torch.from_numpy(b)[:, None]
        return bb, base_solve(bb.to(stepper.rdtype))

    def solo(b, slot):
        """Reference: the column alone in an otherwise-empty block."""
        bb, x0 = prep(b)
        state = stepper.init()
        state = stepper.join(state, [slot], bb, x0, [tol])
        hist = [float(state.rel[slot])]
        while stepper.active_mask(state).any():
            state, _ = stepper.step(state)
            hist.append(float(state.rel[slot]))
        return tuple(hist)

    ref0, ref1 = solo(b0, 0), solo(b1, 1)

    state = stepper.init()
    bb0, x00 = prep(b0)
    state = stepper.join(state, [0], bb0, x00, [tol])
    hist = {0: [float(state.rel[0])], 1: []}
    for _ in range(2):                # col 0 runs alone for two sweeps
        state, act = stepper.step(state)
        assert act[0] and not act[1]
        hist[0].append(float(state.rel[0]))
    bb1, x01 = prep(b1)
    state = stepper.join(state, [1], bb1, x01, [tol])   # mid-flight join
    hist[1].append(float(state.rel[1]))
    while stepper.active_mask(state).any():
        state, act = stepper.step(state)
        rel = state.rel.numpy()
        for s in (0, 1):
            if act[s]:
                hist[s].append(float(rel[s]))
    assert tuple(hist[0]) == ref0
    assert tuple(hist[1]) == ref1


def test_retired_slots_never_recompute(eng):
    """A retired slot is inert: cleared, excluded from the active mask,
    and untouched by later sweeps until a new column joins it."""
    a = _spd(seed=4)
    stepper, base_solve, _ = eng.continuous_stepper(a, slots=2,
                                                    cache_key="retire")
    bb = torch.from_numpy(_rhs(a, seed=0))[:, None]
    state = stepper.init()
    state = stepper.join(state, [0], bb, base_solve(bb), [1e-6])
    while not stepper.done_mask(state).any():
        state, _ = stepper.step(state)
    state, [(x, relres, sweeps, conv)] = stepper.retire(state, [0])
    assert conv and relres <= 1e-6 and sweeps >= 1
    assert not state.occ[0]
    assert state.its[0] == 0
    assert not state.x[:, 0].any()                # cleared
    # join a second column into slot 1 and sweep: slot 0 must stay inert
    b2 = torch.from_numpy(_rhs(a, seed=1))[:, None]
    state = stepper.join(state, [1], b2, base_solve(b2), [1e-6])
    state, act = stepper.step(state)
    assert not act[0] and act[1]
    assert state.its[0] == 0
    assert not state.x[:, 0].any()


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------
def test_deadline_expiry_returns_best_so_far(eng):
    """deadline_ms=0 expires before the first sweep: the request comes
    back immediately with its initial iterate, marked, not converged."""
    a = _spd(seed=5)
    b = _rhs(a, seed=0)
    sch = BatchScheduler(eng, max_batch=2, continuous=True)
    sch.start()
    fut = sch.submit_async(a, b, SolveOptions(
        target_digits=6.0, deadline_ms=0.0, cache_key="dead"))
    x, info = fut.result(timeout=120)
    sch.stop()
    assert info.deadline_expired and not info.converged
    assert info.sweeps == 0
    assert len(info.history[0]) == 1          # rel0 only, no sweeps ran
    assert info.residual == pytest.approx(info.history[0][0])
    # best-so-far == the base (factored) solve's initial iterate
    stepper, base_solve, _ = eng.continuous_stepper(a, slots=2,
                                                    cache_key="dead")
    x0 = base_solve(torch.from_numpy(b)[:, None])
    assert torch.equal(x, x0[:, 0])


# ---------------------------------------------------------------------------
# tiered shedding (frontend)
# ---------------------------------------------------------------------------
class _StubScheduler:
    def __init__(self):
        self.metrics = InMemoryMetrics()
        self.depth = 0
        self.seen: list[SolveOptions] = []

    def pending_cols(self):
        return self.depth

    def submit_async(self, a, b, options):
        self.seen.append(options)
        return "future"


def test_shedding_tier_boundaries():
    sch = _StubScheduler()
    fe = ServeFrontend(sch, soft_pending=2, hard_pending=4,
                       degraded_digits=4.0)
    # tier 0: below soft — request passes through untouched
    sch.depth = 1
    fe.submit(None, None, SolveOptions(target_digits=7.0))
    assert sch.seen[-1].target_digits == 7.0
    assert sch.seen[-1].shed_tier == 0
    # tier 1: [soft, hard) — degrade the target, stamp the tier
    for depth in (2, 3):
        sch.depth = depth
        fe.submit(None, None, SolveOptions(target_digits=7.0))
        assert sch.seen[-1].target_digits == 4.0
        assert sch.seen[-1].shed_tier == 1
    # a request already below the degraded floor keeps its own target
    fe.submit(None, None, SolveOptions(target_digits=3.0))
    assert sch.seen[-1].target_digits == 3.0
    # tier 2: at/above hard — reject
    sch.depth = 4
    with pytest.raises(SchedulerOverload):
        fe.submit(None, None, SolveOptions(target_digits=7.0))
    m = sch.metrics
    assert m.counter("frontend.shed", tier=1) == 3
    assert m.counter("frontend.shed", tier=2) == 1
    assert m.counter("frontend.requests") == 5


def test_frontend_end_to_end_degrades(eng):
    """Against a real continuous scheduler: a backlogged queue degrades
    the admitted request and its SolveInfo says so."""
    a = _spd(seed=6)
    sch = BatchScheduler(eng, max_batch=2, continuous=True)
    fe = ServeFrontend(sch, soft_pending=1, hard_pending=64)
    sch.start()
    opts = SolveOptions(target_digits=7.0, cache_key="fe")
    futs = [fe.submit(a, _rhs(a, seed=i), opts) for i in range(6)]
    outs = [f.result(timeout=120) for f in futs]
    sch.stop()
    tiers = [info.shed_tier for _, info in outs]
    assert tiers[0] == 0
    assert 1 in tiers                 # backlog built up -> some degraded
    for _, info in outs:
        if info.shed_tier == 1:
            assert info.target_digits == pytest.approx(4.0)
            assert info.converged


# ---------------------------------------------------------------------------
# stop() vs submit race
# ---------------------------------------------------------------------------
def test_stop_after_submit_completes_or_raises(eng):
    """A submission racing stop() must either resolve its future or
    raise at submission — never hang or vanish (the silent-drop bug)."""
    a = _spd(seed=7)
    opts = SolveOptions(target_digits=3.0, cache_key="race")
    for round_ in range(5):
        sch = BatchScheduler(eng, max_batch=4, continuous=True)
        sch.start()
        futs, rejected = [], []

        def submitter():
            for i in range(4):
                try:
                    futs.append(sch.submit_async(a, _rhs(a, seed=i), opts))
                except (RuntimeError, AssertionError):
                    # stop won the race: refused loudly, never dropped
                    rejected.append(i)
                    break

        t = threading.Thread(target=submitter)
        t.start()
        sch.stop()
        t.join()
        for f in futs:                    # accepted => must resolve
            x, info = f.result(timeout=120)
            assert info.converged
        assert len(futs) + len(rejected) >= 1


def test_submit_async_raises_while_stopping(eng):
    """Deterministic half of the race: once the stop flag is up, new
    submissions are refused loudly instead of queued into the void."""
    a = _spd(seed=8)
    sch = BatchScheduler(eng, max_batch=2, continuous=True)
    sch.start()
    with sch._cv:
        sch._stop_flag = True             # worker not yet exited
        with pytest.raises(RuntimeError, match="stopping"):
            sch.submit_async(a, _rhs(a), SolveOptions(cache_key="x"))
        sch._stop_flag = False
    sch.stop()


# ---------------------------------------------------------------------------
# SolveOptions redesign: deprecated aliases
# ---------------------------------------------------------------------------
def test_deprecated_kwargs_warn_and_work(eng):
    a = _spd(seed=9)
    b = _rhs(a)
    with pytest.warns(DeprecationWarning, match="SolveOptions"):
        x_old, info_old = eng.solve(a, b, target_digits=5.0,
                                    cache_key="dep")
    with warnings.catch_warnings():
        warnings.simplefilter("error")    # options path must be silent
        x_new, info_new = eng.solve(a, b, SolveOptions(
            target_digits=5.0, cache_key="dep"))
    assert torch.equal(x_old, x_new)
    assert info_old.sweeps == info_new.sweeps

    sch = BatchScheduler(eng, max_batch=4)
    with pytest.warns(DeprecationWarning):
        rid = sch.submit(a, b, target_digits=5.0, cache_key="dep")
    out = sch.drain()
    assert out[rid][1].converged


def test_unknown_kwarg_raises_typeerror(eng):
    a = _spd(seed=9)
    with pytest.raises(TypeError, match="SolveOptions"):
        eng.solve(a, _rhs(a), targets_digit=5.0)     # typo'd name


def test_options_validation():
    with pytest.raises(AssertionError):
        SolveOptions(method="qr")
    with pytest.raises(AssertionError):
        SolveOptions(shed_tier=3)
    with pytest.raises(AssertionError):
        SolveOptions(deadline_ms=-1.0)


# ---------------------------------------------------------------------------
# metrics layer
# ---------------------------------------------------------------------------
def test_metrics_protocol_and_emission():
    assert isinstance(InMemoryMetrics(), MetricsTracker)
    assert isinstance(NullMetrics(), MetricsTracker)

    a = _spd(seed=10)
    mt = InMemoryMetrics()
    eng2 = _engine(max_sweeps=8, metrics=mt)
    sch = BatchScheduler(eng2, max_batch=2, continuous=True)
    assert sch.metrics is mt              # tracker chains down the stack
    sch.start()
    futs = [sch.submit_async(a, _rhs(a, seed=i),
                             SolveOptions(target_digits=4.0,
                                          cache_key="m"))
            for i in range(3)]
    for f in futs:
        f.result(timeout=120)
    sch.stop()
    snap = mt.snapshot()
    c = snap["counters"]
    assert c["scheduler.requests"] == 3
    assert c["engine.factor_cache_miss"] >= 1
    assert c["scheduler.sweeps"] >= 1
    assert snap["observations"]["scheduler.queue_ms"]["count"] == 3
    assert 0 < snap["gauges"]["scheduler.slot_occupancy"] <= 1.0
    assert any(k.startswith("scheduler.requests") for k in snap["rates"])


# ---------------------------------------------------------------------------
# factor cache + windowed scheduler (tests/test_serve.py, solver half)
# ---------------------------------------------------------------------------
def _spd_u(n, seed=0):
    rng = np.random.default_rng(seed)
    m = rng.uniform(-1, 1, (n, n))
    return (m @ m.T + n * np.eye(n)).astype(np.float32)


def _rhs_u(a, seed):
    n = a.shape[0]
    return (a @ np.random.default_rng(seed).standard_normal(n)).astype(
        np.float32)


def _relres(a, x, b):
    x = np.asarray(x, np.float64)
    return np.linalg.norm(a @ x - b) / np.linalg.norm(b)


def test_solver_engine_targets():
    n = 384
    a = _spd_u(n, seed=21)
    b = _rhs_u(a, seed=21)
    e = _engine(max_sweeps=8)
    x, info = e.solve(a, b, SolveOptions(target_digits=6.0, cache_key="k"))
    assert info.converged and info.residual <= 1e-6
    assert not info.factor_cached
    _, info2 = e.solve(a, b, SolveOptions(target_digits=3.0, cache_key="k"))
    assert info2.factor_cached and info2.sweeps <= info.sweeps
    # targets beyond the residual precision clamp instead of spinning
    _, info3 = e.solve(a, b, SolveOptions(target_digits=99.0,
                                          cache_key="k"))
    assert info3.target_digits == 7.0 and info3.sweeps <= 8
    e64 = _engine(max_sweeps=8, residual_dtype="f64")
    x64, info4 = e64.solve(a, b, SolveOptions(target_digits=99.0))
    assert info4.target_digits == 14.0 and x64.dtype == torch.float64


def test_factor_cache_detects_stale_key():
    """A reused cache_key with DIFFERENT matrix data must refactorize."""
    n = 256
    a1, a2 = _spd_u(n, seed=1), _spd_u(n, seed=2)
    b2 = _rhs_u(a2, seed=3)
    e = _engine(max_sweeps=8)
    e.solve(a1, _rhs_u(a1, seed=4), SolveOptions(cache_key="shared"))
    x, info = e.solve(a2, b2, SolveOptions(target_digits=6.0,
                                           cache_key="shared"))
    assert not info.factor_cached
    assert _relres(a2, x, b2) <= 1e-6
    _, info2 = e.solve(a2, b2, SolveOptions(cache_key="shared"))
    assert info2.factor_cached


def test_factor_cache_lru_bound():
    n = 192
    mats = [_spd_u(n, seed=s) for s in range(4)]
    e = _engine(max_sweeps=6, max_cached_factors=2)
    for i, a in enumerate(mats[:3]):
        e.solve(a, _rhs_u(a, seed=i), SolveOptions(cache_key=f"k{i}"))
    assert e.cached_keys() == ["k1", "k2"]
    _, info = e.solve(mats[0], _rhs_u(mats[0], seed=9),
                      SolveOptions(cache_key="k0"))
    assert not info.factor_cached
    e.solve(mats[2], _rhs_u(mats[2], seed=10), SolveOptions(cache_key="k2"))
    e.solve(mats[3], _rhs_u(mats[3], seed=11), SolveOptions(cache_key="k3"))
    assert e.cached_keys() == ["k2", "k3"]


def test_scheduler_batches_requests_sharing_a_factor():
    n = 256
    a, a_other = _spd_u(n, seed=5), _spd_u(n, seed=6)
    sch = BatchScheduler(_engine(max_sweeps=8), max_batch=8)
    bs = [_rhs_u(a, seed=10 + i) for i in range(4)]
    opts = SolveOptions(target_digits=6.0, cache_key="k")
    ids = [sch.submit(a, b, opts) for b in bs]
    b_other = _rhs_u(a_other, seed=20)
    id_other = sch.submit(a_other, b_other, SolveOptions(cache_key="other"))
    assert len(sch) == 5
    out = sch.drain()
    assert len(sch) == 0 and set(out) == {*ids, id_other}
    for i, (rid, b) in enumerate(zip(ids, bs)):
        x, info = out[rid]
        assert _relres(a, x, b) <= 1e-6          # each request got ITS x
        assert info.batch_size == 4 and info.batch_index == i
        assert info.converged
    x, info = out[id_other]
    assert info.batch_size == 1 and _relres(a_other, x, b_other) <= 1e-6
    rid2 = sch.submit(a, bs[0], SolveOptions(cache_key="k"))
    assert out[ids[0]][1].factor_cached is False
    assert sch.drain()[rid2][1].factor_cached is True


def test_scheduler_never_batches_mismatched_matrices():
    n = 192
    a1, a2 = _spd_u(n, seed=7), _spd_u(n, seed=8)
    b1, b2 = _rhs_u(a1, seed=1), _rhs_u(a2, seed=2)
    sch = BatchScheduler(_engine(max_sweeps=8))
    i1 = sch.submit(a1, b1, SolveOptions(cache_key="k"))
    i2 = sch.submit(a2, b2, SolveOptions(cache_key="k"))
    out = sch.drain()
    assert out[i1][1].batch_size == 1 and out[i2][1].batch_size == 1
    for a, b, rid in [(a1, b1, i1), (a2, b2, i2)]:
        assert _relres(a, out[rid][0], b) <= 1e-6


def test_scheduler_respects_max_batch_and_mixed_targets():
    n = 256
    a = _spd_u(n, seed=11)
    sch = BatchScheduler(_engine(max_sweeps=8), max_batch=3)
    targets = [2.0, 6.0, 2.0, 6.0, 2.0]
    ids = [sch.submit(a, _rhs_u(a, seed=30 + i),
                      SolveOptions(target_digits=t, cache_key="k"))
           for i, t in enumerate(targets)]
    out = sch.drain()
    assert [out[r][1].batch_size for r in ids] == [3, 3, 3, 2, 2]
    for rid, t in zip(ids, targets):
        info = out[rid][1]
        assert info.converged and info.residual <= 10.0 ** -t
        assert info.target_digits == t


def test_scheduler_drain_failure_preserves_other_requests():
    n = 128
    a = _spd_u(n, seed=17)
    bad = -np.eye(n, dtype=np.float32)
    sch = BatchScheduler(_engine(max_sweeps=6))
    ok_id = sch.submit(a, _rhs_u(a, seed=1), SolveOptions(cache_key="good"))
    bad_id = sch.submit(bad, np.ones(n, np.float32),
                        SolveOptions(cache_key="bad"))
    later_id = sch.submit(a, _rhs_u(a, seed=2),
                          SolveOptions(cache_key="good2"))

    class Boom(RuntimeError):
        pass

    orig = sch.engine.solve_batched

    def exploding(a_, bs, **kw):
        if kw.get("cache_key") == "bad":
            raise Boom("not SPD")
        return orig(a_, bs, **kw)

    sch.engine.solve_batched = exploding
    with pytest.raises(Boom):
        sch.drain()
    assert [r.request_id for r in sch.failed] == [bad_id]
    assert [r.request_id for r in sch._queue] == [later_id]
    out = sch.drain()
    assert set(out) == {ok_id, later_id}
    for rid, seed in [(ok_id, 1), (later_id, 2)]:
        x, info = out[rid]
        assert _relres(a, x, _rhs_u(a, seed=seed)) <= 1e-6 and info.converged


def test_scheduler_multi_column_request():
    n = 192
    a = _spd_u(n, seed=13)
    blk = np.stack([_rhs_u(a, seed=40), _rhs_u(a, seed=41)], axis=1)
    vec = _rhs_u(a, seed=42)
    sch = BatchScheduler(_engine(max_sweeps=8))
    i_blk = sch.submit(a, blk, SolveOptions(cache_key="k"))
    i_vec = sch.submit(a, vec, SolveOptions(cache_key="k"))
    out = sch.drain()
    x_blk, info_blk = out[i_blk]
    x_vec, info_vec = out[i_vec]
    assert x_blk.shape == (n, 2) and x_vec.shape == (n,)
    assert info_blk.batch_size == info_vec.batch_size == 2
    assert _relres(a, x_blk, blk) <= 1e-5
    assert info_blk.converged and info_vec.converged


def test_unported_serving_raises():
    """Mesh mode and the tuner name their ROADMAP items (the decode half
    is ported: tests/test_torch_models.py)."""
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        SolverEngine(mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        SolverEngine(tuning_db=object())


def test_default_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = _spd_u(128, seed=1)
    with pytest.raises(RuntimeError, match="cuda"):
        SolverEngine().solve(a, _rhs_u(a, 1))
