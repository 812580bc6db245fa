"""The port's iterative refinement (``repro_torch.core.refine``) against
the JAX reference, on the CPU.

Inputs are made with numpy from a seed and fed to both packages. The
reference runs under ``jax.enable_x64(True)`` where the residual is f64;
the port asks for f64 with ``residual_dtype="f64"``. Per column, the two
must take the same number of sweeps and agree on ``converged`` and on
which sweeps ran; the residual values themselves go through f32 factors
whose GEMMs differ in the last bits between torch and XLA, so they are
held to the same digit (a factor of 2), and the solutions to the
tolerance each run converged to. Sweep counts are compared on cases
whose residuals stay more than that factor from their tolerance (the
test checks it): nearer, last bits decide a sweep in either package. The
contracts of tests/test_refine.py that need no reference run inside the
port.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch.core as tc
from repro_torch.convert import refine_config_from_fields

torch.set_num_threads(2)


def spd(n, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    m = rng.uniform(-1, 1, (n, n))
    return (m @ m.T + n * np.eye(n)).astype(dtype)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


#: (name, levels, n, k, method, tol: scalar or per column), all with f64
#: residuals; n = 300 is ragged (padded to 384 at leaf 128)
CASES = [
    ("ir-bf16-ragged", ("bf16", "f32"), 300, 3, "ir", 1e-9),
    ("ir-f16-coltol", ("f16", "f32"), 256, 3, "ir", (1e-2, 1e-6, 1e-11)),
    ("gmres-bf16-ragged", ("bf16", "f32"), 300, 2, "gmres", 1e-9),
]


def _off_the_edge(hist, tol):
    """No finite history entry within a factor 2 of its column's tolerance:
    there the two packages' last bits (f32 GEMMs in another order) could
    put one run above the tolerance and the other below, and their sweep
    counts apart. (At n = 200 and seed 12 GMRES-IR lands at 1.13e-10 in
    the reference and 8.8e-11 in the port against 1e-10.)"""
    ok = ~np.isnan(hist)
    ratio = np.abs(np.log10(hist / np.broadcast_to(tol, hist.shape)))
    return bool((ratio[ok] > np.log10(2.0)).all())


def _inputs(n, k, seed):
    a = spd(n, seed)
    return a, a @ np.random.default_rng(seed + 1).standard_normal((n, k))


@pytest.fixture(scope="module")
def runs():
    """Each case through the reference and the port (one reference
    compile per case, shared by the tests below)."""
    import jax
    out = {}
    for i, (name, levels, n, k, method, tol) in enumerate(CASES):
        a, b = _inputs(n, k, 10 + i)
        col_tol = None if np.isscalar(tol) else tol
        fields = dict(max_sweeps=8, tol=float(np.min(tol)), method=method,
                      gmres_restart=8)
        with jax.enable_x64(True):
            ref = rc.refine_solve(
                a, b, rc.PrecisionConfig(levels=levels, leaf=128),
                refine=rc.RefineConfig(**fields),
                col_tol=None if col_tol is None else np.asarray(col_tol))
            ref = {f: np.asarray(getattr(ref, f)) for f in ref._fields}
        port = tc.refine_solve(
            a, b, tc.PrecisionConfig(levels=levels, leaf=128),
            refine=refine_config_from_fields(**fields, residual_dtype="f64"),
            col_tol=col_tol, device="cpu")
        out[name] = (a, b, ref, port)
    return out


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_refine_matches_reference(runs, name):
    a, b, ref, port = runs[name]
    tol = dict((c[0], c[5]) for c in CASES)[name]
    assert _off_the_edge(ref["history"], tol)
    np.testing.assert_array_equal(port.iterations.numpy(), ref["iterations"])
    np.testing.assert_array_equal(port.converged.numpy(), ref["converged"])
    hp, hr = port.history.numpy(), ref["history"]
    np.testing.assert_array_equal(np.isnan(hp), np.isnan(hr))
    ok = ~np.isnan(hr)
    # same digit: f32 factors whose GEMMs differ in the last bits
    ratio = np.log10(hp[ok] / hr[ok])
    assert np.abs(ratio).max() < np.log10(2.0), hp
    # each run's x solves A x = b to its own history; the two agree to
    # the larger of their achieved relative residuals, times cond-ish 10
    xr, xp = ref["x"].astype(np.float64), port.x.numpy().astype(np.float64)
    scale = np.abs(xr).max(axis=0)
    tol = 10 * np.maximum(ref["residual"], port.residual.numpy())
    assert (np.abs(xp - xr).max(axis=0) <= tol * scale).all()


def test_refine_converges_in_f64(runs):
    """Every column reaches its tolerance, measured again in f64 here."""
    for name in ("ir-bf16-ragged", "gmres-bf16-ragged", "ir-f16-coltol"):
        a, b, _, port = runs[name]
        assert bool(port.converged.all()), name
        x = port.x.numpy()
        rr = np.linalg.norm(a @ x - b, axis=0) / np.linalg.norm(b, axis=0)
        tol = np.asarray(dict((c[0], c[5]) for c in CASES)[name])
        assert (rr <= tol * 1.01).all(), (name, rr)  # 1 % over: f64 sums


def test_per_column_tolerances_freeze_columns(runs):
    _, _, _, port = runs["ir-f16-coltol"]
    it = port.iterations.numpy()
    assert it[0] <= it[1] <= it[2] and it[0] < it[2]
    hist = port.history.numpy()
    assert np.isnan(hist[it[0] + 1:, 0]).all()      # col 0 froze early
    assert np.isfinite(hist[:it[2] + 1, 2]).all()   # col 2 kept going


def test_refine_result_contract():
    n = 256
    a = spd(n, 7, np.float32)
    b = (a @ np.random.default_rng(7).standard_normal(n)).astype(np.float32)
    res = tc.refine_solve(a, b, tc.PAPER_CONFIGS["pure_f16"],
                          refine=tc.RefineConfig(max_sweeps=4, tol=1e-6),
                          device="cpu")
    hist = res.history.numpy()
    k = int(res.iterations)
    assert hist.shape == (5,) and res.x.shape == (n,)
    assert res.x.dtype == torch.float32            # residual_dtype None
    assert np.isfinite(hist[:k + 1]).all()
    assert np.isnan(hist[k + 1:]).all()            # untaken sweeps stay nan
    assert float(res.residual) == np.nanmin(hist)  # best iterate wins
    assert hist[0] > float(res.residual)           # refinement helped


@pytest.mark.parametrize("n", [256, 300])
def test_zero_sweeps_is_cholesky_solve(n):
    a = spd(n, 5, np.float32)
    b = np.random.default_rng(5).standard_normal((n, 3)).astype(np.float32)
    cfg = tc.PrecisionConfig(levels=("f16", "f32"), leaf=128)
    plain = tc.cholesky_solve(a, b, cfg, device="cpu")
    res = tc.refine_solve(a, b, cfg, refine=0, device="cpu")
    assert torch.equal(res.x, plain)
    assert res.iterations.shape == (3,) and not res.iterations.any()


def test_refine_never_degrades_past_floor():
    """At the f32 residual floor the loop returns the BEST iterate: never
    worse than the unrefined solve, measured in f64."""
    n = 384
    a = spd(n, 23, np.float32)
    b = (a @ np.random.default_rng(23).standard_normal(n)).astype(np.float32)
    cfg = tc.PrecisionConfig(levels=("f32",), leaf=128)
    res = tc.refine_solve(a, b, cfg, refine=tc.RefineConfig(
        max_sweeps=8, tol=1e-12), device="cpu")
    x0 = tc.cholesky_solve(a, b, cfg, device="cpu").numpy()
    ad, bd = a.astype(np.float64), b.astype(np.float64)

    def rr(x):
        return np.linalg.norm(ad @ x.astype(np.float64) - bd) / \
            np.linalg.norm(bd)

    hist = res.history.numpy()
    assert float(res.residual) <= hist[0]
    assert not bool(res.converged)                 # 1e-12 is below f32
    assert rr(res.x.numpy()) <= rr(x0)


def _ill_conditioned_spd(n, cond, seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = (q * np.logspace(0, -np.log10(cond), n)) @ q.T
    return (a + a.T) / 2


def test_stall_tolerates_one_flat_sweep():
    """r -> N r with nilpotent N = 2 e0 e1^T: sweep 1 doubles the residual,
    sweep 2 lands exactly. One flat sweep must not end the run."""
    n = 64
    a = _ill_conditioned_spd(n, 1e6, seed=3)
    nmat = np.zeros((n, n))
    nmat[0, 1] = 2.0
    m = _t(np.linalg.inv(a) @ (np.eye(n) - nmat))
    at = _t(a)
    b = torch.zeros(n, dtype=torch.float64)
    b[1] = 1.0
    rcfg = tc.RefineConfig(max_sweeps=4, tol=1e-8, residual_dtype="f64")
    res = tc.refine_operator(lambda x: at @ x, lambda r: m @ r, b,
                             torch.zeros_like(b), rcfg)
    hist = res.history.numpy()
    assert hist[1] >= hist[0]
    assert bool(res.converged) and int(res.iterations) == 2
    assert float(res.residual) <= 1e-8


def test_stall_exits_diverging_run_with_best_iterate():
    n = 64
    a = _ill_conditioned_spd(n, 1e4, seed=5)
    m = _t(np.linalg.inv(a) @ (-np.eye(n)))       # r -> 2 r
    at = _t(a)
    b = _t(np.random.default_rng(5).standard_normal(n))
    x0 = torch.zeros(n, dtype=torch.float64)
    rcfg = tc.RefineConfig(max_sweeps=8, tol=1e-12, residual_dtype="f64")
    res = tc.refine_operator(lambda x: at @ x, lambda r: m @ r, b, x0, rcfg)
    assert int(res.iterations) == 2 and not bool(res.converged)
    assert float(res.residual) == res.history.numpy()[0]
    assert torch.equal(res.x, x0)


def test_slow_steady_convergence_is_not_stalled():
    b = _t(np.random.default_rng(3).standard_normal(32))
    rcfg = tc.RefineConfig(max_sweeps=20, tol=1e-4, residual_dtype="f64")
    res = tc.refine_operator(lambda x: x, lambda r: 0.375 * r, b,
                             torch.zeros_like(b), rcfg)
    assert bool(res.converged) and int(res.iterations) == 20


def test_multi_rhs_scaled_solve_is_per_column():
    """Columns whose residuals differ by ~1e6 each converge: a joint absmax
    would underflow the small one through the f16 correction path."""
    n = 256
    a = spd(n, 33, np.float32)
    rng = np.random.default_rng(33)
    b = np.stack([a @ rng.standard_normal(n),
                  1e6 * (a @ rng.standard_normal(n))], axis=1).astype(
                      np.float32)
    res = tc.refine_solve(a, b, tc.PAPER_CONFIGS["f16_f32"],
                          refine=tc.RefineConfig(max_sweeps=8, tol=1e-6),
                          device="cpu")
    assert bool(res.converged.all()), res.residual
    x = res.x.numpy().astype(np.float64)
    for j in range(2):
        rr = np.linalg.norm(a @ x[:, j] - b[:, j]) / np.linalg.norm(b[:, j])
        assert rr <= 2e-6, (j, rr)    # the reference test's bound


def test_cholesky_solve_refine_is_refine_solve():
    """cholesky_solve(refine=) returns refine_solve(...).x, bitwise, in the
    residual precision (not a bf16 RHS's dtype)."""
    n = 256
    a = spd(n, 29, np.float32)
    b = (a @ np.random.default_rng(29).standard_normal(n)).astype(np.float32)
    cfg = tc.PrecisionConfig(leaf=128)
    x = tc.cholesky_solve(a, b, cfg, refine=2, device="cpu")
    assert torch.equal(x, tc.refine_solve(a, b, cfg, refine=2,
                                          device="cpu").x)
    b16 = _t(b).to(torch.bfloat16)
    xr = tc.cholesky_solve(_t(a), b16, tc.PAPER_CONFIGS["bf16_f32"],
                           refine=4)
    assert xr.dtype == torch.float32
    bd = b16.double().numpy()
    rr = np.linalg.norm(a @ xr.double().numpy() - bd) / np.linalg.norm(bd)
    assert rr < 1e-5, rr          # far beyond bf16's 8e-3


def test_refine_steps_operator():
    """Fixed sweeps against a stale preconditioner contract the residual."""
    n = 128
    a = spd(n, 13, np.float32)
    stale = a + 0.05 * np.diag(np.abs(np.random.default_rng(13)
                                      .standard_normal(n))).astype(np.float32)
    linv = _t(np.linalg.inv(np.linalg.cholesky(stale.astype(np.float64))))
    at = _t(a)
    b = _t((a @ np.random.default_rng(14).standard_normal(n)).astype(
        np.float32))

    def correct(r):
        return (linv.T @ (linv @ r.double())).float()

    x0 = correct(b)
    x = tc.refine_steps(lambda v: at @ v, tc.scaled_solve(correct), b, x0,
                        sweeps=4)
    r0 = float(torch.linalg.vector_norm(at @ x0 - b))
    r4 = float(torch.linalg.vector_norm(at @ x - b))
    assert r4 < r0 / 50, (r0, r4)


def test_gmres_beats_ir_when_factor_is_poor():
    n = 256
    a = spd(n, 17)
    noise = np.random.default_rng(17).standard_normal((n, n))
    l = np.linalg.cholesky(a + 0.35 * (noise @ noise.T) / n)
    b = a @ np.random.default_rng(18).standard_normal(n)
    cfg = tc.PrecisionConfig(levels=("f32",), leaf=128)
    kw = dict(max_sweeps=6, gmres_restart=10, tol=1e-10,
              residual_dtype="f64")
    ir = tc.refine_solve(a, b, cfg, l=l, refine=tc.RefineConfig(**kw),
                         device="cpu")
    gm = tc.gmres_refine(a, b, cfg, l=l, refine=tc.RefineConfig(**kw),
                         device="cpu")
    assert float(gm.residual) < float(ir.residual) / 10
    assert bool(gm.converged)


def test_refine_config_from_fields():
    fields = dict(max_sweeps=7, tol=1e-9, method="gmres", gmres_restart=4)
    ref = rc.RefineConfig(**fields)
    port = refine_config_from_fields(**dataclasses.asdict(ref))
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.rdtype() == torch.float32
    assert refine_config_from_fields(residual_dtype="f64").rdtype() == \
        torch.float64


def test_default_device_without_gpu_raises(monkeypatch):
    """refine_solve's default device is the card: without one it raises
    rather than quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = spd(128, 1, np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        tc.refine_solve(a, np.ones(128, np.float32),
                        tc.PrecisionConfig(leaf=128))


def test_solver_engine_matches_reference():
    """The port's serving engine answers a mixed-target batch with the
    reference's sweeps, convergence, clamped target and history length per
    request (f64 residuals: the reference under x64); history values to
    the same digit as above."""
    import jax
    from repro import serve as rs
    from repro_torch import serve as ts
    n = 256
    a = spd(n, 3, np.float32)
    bs = [(a @ np.random.default_rng(i).standard_normal(n)).astype(np.float32)
          for i in range(3)]
    targets = [3.0, 8.0, 20.0]          # 20 clamps to the f64 floor, 14
    cfg = dict(levels=("f16", "f32"), leaf=128)
    with jax.enable_x64(True):
        _, want = rs.SolverEngine(rc.PrecisionConfig(**cfg),
                                  max_sweeps=8).solve_batched(
            a, bs, rs.SolveOptions(target_digits=targets, cache_key="k"))
    _, got = ts.SolverEngine(tc.PrecisionConfig(**cfg), max_sweeps=8,
                             residual_dtype="f64",
                             device="cpu").solve_batched(
        a, bs, ts.SolveOptions(target_digits=targets, cache_key="k"))
    for g, w in zip(got, want):
        assert _off_the_edge(np.asarray(w.history[0]),
                             10.0 ** -w.target_digits)
        assert (g.sweeps, g.converged, g.target_digits) == \
            (w.sweeps, w.converged, w.target_digits)
        assert len(g.history[0]) == len(w.history[0])
        ratio = np.log10(np.asarray(g.history[0]) / np.asarray(w.history[0]))
        assert np.abs(ratio).max() < np.log10(2.0)
