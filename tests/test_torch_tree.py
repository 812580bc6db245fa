"""The port's tree engine (``engine="tree"``: core/tree.py and the packed
storage of core/treematrix.py) against the JAX reference's, on the CPU
(leaf 128).

Each reference factor is computed once per ladder, at the ragged n = 600
(padded to 640: five leaf columns and recursion depth 3, so every level of
the x3 ladders occurs), and shared by the tests that need it. Tolerances
are the reference suite's own: ``_TOL`` of tests/test_blocked.py, keyed
by the ladder's coarsest level; the f64 ladder is held to 1e-12.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
from repro.core import treematrix as rtm
import repro_torch.core as tc
from repro_torch import convert
from repro_torch.serve import BatchScheduler, SolveOptions, SolverEngine

torch.set_num_threads(2)

_TOL = {"f16": 5e-3, "bf16": 4e-2, "int8": 4e-2, "f32": 5e-6, "f64": 1e-12}
CONFIGS = [k for k in tc.PAPER_CONFIGS if "f64" not in k]
LEAF = 128
N = 600
NPAD = 640


def spd(n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    m = rng.uniform(-1, 1, (n, n))
    return (m @ m.T + n * np.eye(n)).astype(dtype)


def _cfgs(name, engine="tree", leaf=LEAF):
    return (dataclasses.replace(rc.PAPER_CONFIGS[name], leaf=leaf,
                                engine=engine),
            dataclasses.replace(tc.PAPER_CONFIGS[name], leaf=leaf,
                                engine=engine))


def _tol(name):
    return _TOL[tc.PAPER_CONFIGS[name].levels[0]]


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The reference's padded tree factor of spd(N), as numpy."""
    return np.asarray(rc.cholesky_padded(spd(N, 1), _cfgs(name)[0]))


@functools.lru_cache(maxsize=None)
def _port(name, engine="tree"):
    return tc.cholesky_padded(spd(N, 1), _cfgs(name, engine)[1],
                              device="cpu")


# ---------------------------------------------------------------------------
# the factor
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", CONFIGS)
def test_tree_factor_matches_reference(name):
    lp = _port(name)
    assert lp.shape == (NPAD, NPAD)
    lt, lr = lp.double().numpy(), _reference(name).astype(np.float64)
    assert np.isfinite(lt).all()           # ragged int8 included
    rel = np.abs(lt - lr).max() / np.abs(lr).max()
    assert rel < _tol(name), (rel, name)
    assert np.abs(np.triu(lt, 1)).max() == 0.0
    tight = tc.cholesky(spd(N, 1), _cfgs(name)[1], device="cpu")
    assert torch.equal(tight, lp[:N, :N])


def test_tree_f64_ladder_matches_reference():
    a = spd(N, 5, np.float64)
    b = np.random.default_rng(2).standard_normal((N, 2))
    cr, ct = _cfgs("f32x3_f64")
    with jax.enable_x64():
        lr = np.asarray(rc.cholesky(jnp.asarray(a), cr))
        xr = np.asarray(rc.cholesky_solve(jnp.asarray(a), jnp.asarray(b),
                                          cr))
    assert lr.dtype == np.float64
    lt = tc.cholesky(a, ct, device="cpu")
    assert lt.dtype == torch.float64
    assert np.abs(lt.numpy() - lr).max() / np.abs(lr).max() < _TOL["f64"]
    xt = tc.cholesky_solve(a, b, ct, device="cpu").numpy()
    assert np.abs(xt - xr).max() / np.abs(xr).max() < _TOL["f64"]


@pytest.mark.parametrize("name", CONFIGS)
def test_tree_matches_blocked(name):
    """Inside the port, the two engines agree to the ladder's roundoff
    (tests/test_blocked.py:test_factor_equivalence)."""
    lt = _port(name).double()
    lb = _port(name, "blocked").double()
    rel = float((lb - lt).abs().max() / lt.abs().max())
    assert rel < _tol(name), (rel, name)


@pytest.mark.parametrize("name", CONFIGS)
def test_tree_bitwise_single_tile(name):
    """n <= leaf: both engines run the same leaf calls, so bitwise
    (tests/test_blocked.py:test_factor_bitwise_single_tile)."""
    a = spd(LEAF, 5)
    got = [tc.cholesky(a, _cfgs(name, e)[1], device="cpu")
           for e in ("tree", "blocked")]
    assert torch.equal(*got)


@pytest.mark.parametrize("name", ["int8_f32", "int8x3_f32"])
def test_tree_survives_padded_int8(name):
    """tests/test_blocked.py:test_tree_survives_padded_int8 in the port:
    the scaled padding tail keeps ragged int8 tree factors finite."""
    a = spd(384, 384)
    cfg = dataclasses.replace(tc.PAPER_CONFIGS[name], engine="tree")
    l = tc.cholesky(a, cfg, device="cpu").double().numpy()
    assert np.isfinite(l).all()
    ref = np.linalg.cholesky(a.astype(np.float64))
    assert np.abs(l - ref).max() / np.abs(ref).max() < 4e-2


# ---------------------------------------------------------------------------
# the solve
# ---------------------------------------------------------------------------
_RHS = np.random.default_rng(4).standard_normal((N, 5)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _reference_solve(name, nrhs):
    b = _RHS if nrhs > 1 else _RHS[:, 0]
    return np.asarray(rc.solve_factored(jnp.asarray(_reference(name)),
                                        jnp.asarray(b), _cfgs(name)[0]),
                      np.float64)


@pytest.mark.parametrize("name", ["pure_f32", "f16_f32", "bf16_f32",
                                  "f16x3_f32", "int8_f32"])
@pytest.mark.parametrize("nrhs", [1, 5])
def test_tree_solve_matches_reference(name, nrhs):
    """cholesky_solve through the tree engine, a vector and a 5-column
    block, against the reference's tree solve with its own factor."""
    ct = _cfgs(name)[1]
    b = _RHS if nrhs > 1 else _RHS[:, 0]
    xr = _reference_solve(name, nrhs)
    xt = tc.solve_factored(_port(name), b, ct, device="cpu")
    assert xt.shape == b.shape
    xt = xt.double().numpy()
    assert np.abs(xt - xr).max() / np.abs(xr).max() < _tol(name)
    a = spd(N, 1).astype(np.float64)
    res = np.abs(a @ xt - b).max() / np.abs(b).max()
    res_ref = np.abs(a @ xr - b).max() / np.abs(b).max()
    assert res <= 2 * res_ref + 8 * np.finfo(np.float32).eps, (res, res_ref)
    if nrhs == 1:      # the whole entry point, factor included
        x1 = tc.cholesky_solve(spd(N, 1), b, ct, device="cpu")
        assert torch.equal(x1, torch.from_numpy(xt).float())


def test_tree_trsm_vs_scipy():
    """tests/test_solver.py:test_tree_trsm_vs_scipy in the port."""
    import scipy.linalg as sla
    rng = np.random.default_rng(7)
    n, m = 512, 384
    l = np.tril(rng.standard_normal((n, n))).astype(np.float32)
    l[np.diag_indices(n)] += np.sqrt(n) * 4
    b = rng.standard_normal((m, n)).astype(np.float32)
    cfg = tc.PrecisionConfig(levels=("f32",), leaf=LEAF)
    got = tc.tree_trsm(torch.from_numpy(b), torch.from_numpy(l), cfg)
    want = sla.solve_triangular(l.astype(np.float64),
                                b.T.astype(np.float64), lower=True).T
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() < 1e-4


def test_tree_syrk_vs_dense():
    """tests/test_solver.py:test_tree_syrk_vs_dense in the port, and the
    reference's zeroed blocks above each split, bitwise."""
    rng = np.random.default_rng(8)
    n, k = 512, 320
    c = rng.standard_normal((n, n)).astype(np.float32)
    a = rng.standard_normal((n, k)).astype(np.float32)
    cfg = tc.PrecisionConfig(levels=("f32",), leaf=LEAF)
    got = tc.tree_syrk(torch.from_numpy(c), torch.from_numpy(a), alpha=-2.0,
                       beta=0.5, cfg=cfg).numpy()
    want = np.tril(0.5 * c - 2.0 * (a @ a.T))
    np.testing.assert_allclose(np.tril(got), want, rtol=1e-4, atol=1e-3)
    ref = np.asarray(rc.tree_syrk(jnp.asarray(c), jnp.asarray(a),
                                  alpha=-2.0, beta=0.5,
                                  cfg=rc.PrecisionConfig(levels=("f32",),
                                                         leaf=LEAF)))
    np.testing.assert_array_equal(got == 0, ref == 0)
    np.testing.assert_array_equal(np.triu(got, 1) == 0, np.triu(ref, 1) == 0)


# ---------------------------------------------------------------------------
# packed storage (TreeSPD)
# ---------------------------------------------------------------------------
def _walk(t):
    """(node, off panel rows/cols in the dense matrix) of every node."""
    out = []

    def rec(t, r0):
        if isinstance(t, (tc.TreeSPD, rtm.TreeSPD)):
            out.append((t, r0))
            rec(t.diag1, r0)
            rec(t.diag2, r0 + t.n1)
    rec(t, 0)
    return out


@pytest.mark.parametrize("levels", [("f16", "f16", "f32"),
                                    ("bf16", "f32"), ("int8", "f32")])
def test_treespd_roundtrip_matches_storage_round(levels):
    """to_dense(from_dense(a)): every off-diagonal panel is a's panel
    stored at its level (storage_round, bitwise), the leaves are exact,
    and the whole equals the reference's round trip bitwise."""
    n = 512
    a = spd(n, 6)
    cfg = tc.PrecisionConfig(levels=levels, leaf=LEAF)
    t = tc.TreeSPD.from_dense(torch.from_numpy(a), cfg)
    back = t.to_dense()
    at = torch.from_numpy(a)
    for node, r0 in _walk(t):
        r1, m = r0 + node.n1, r0 + node.n
        want = tc.storage_round(at[r1:m, r0:r1], cfg.name_at(node.level))
        assert torch.equal(back[r1:m, r0:r1], want)
    assert torch.equal(back.diagonal(), at.diagonal())
    ref = rtm.TreeSPD.from_dense(jnp.asarray(a),
                                 rc.PrecisionConfig(levels=levels,
                                                    leaf=LEAF))
    np.testing.assert_array_equal(back.numpy(), np.asarray(ref.to_dense()))


@pytest.mark.parametrize("name", ["f16x3_f32", "int8_f32"])
def test_packed_factor_matches_dense_api(name):
    """tree_potrf_packed on TreeSPD.from_dense against the dense tree
    factor of the same matrix, and against the reference's packed
    factor."""
    cr, ct = _cfgs(name)
    a = tc.pad_spd(torch.from_numpy(spd(N, 1)), LEAF)[0]
    lp = tc.tree_potrf_packed(tc.TreeSPD.from_dense(a, ct), ct)
    assert isinstance(lp, tc.TreeSPD)
    got = lp.to_dense().double().numpy()
    dense = _port(name).double().numpy()
    assert np.abs(np.tril(got) - dense).max() / np.abs(dense).max() \
        < _tol(name)
    ref = rtm.tree_potrf_packed(rtm.TreeSPD.from_dense(jnp.asarray(
        a.numpy()), cr), cr)
    want = np.asarray(ref.to_dense(), np.float64)
    assert np.abs(got - want).max() / np.abs(want).max() < _tol(name)
    assert lp.nbytes() == ref.nbytes()


@pytest.mark.parametrize("name", ["f16x3_f32", "int8x3_f32", "bf16_f32",
                                  "pure_f32", "f32x3_f64"])
def test_storage_ratio_and_nbytes_match_reference(name):
    """storage_ratio equals the reference's for the paper's sizes, and a
    packed matrix holds exactly those bytes plus 4 per panel scale."""
    for n, leaf in ((65536, 256), (16384, 256), (640, LEAF)):
        cr, ct = _cfgs(name, leaf=leaf)
        assert tc.storage_ratio(n, ct) == rtm.storage_ratio(n, cr)
    cr, ct = _cfgs(name)
    a = spd(NPAD, 9, np.float64 if "f64" in name else np.float32)
    t = tc.TreeSPD.from_dense(torch.from_numpy(a), ct)
    with jax.enable_x64("f64" in name):
        ref = rtm.TreeSPD.from_dense(jnp.asarray(a), cr)
        assert t.nbytes() == ref.nbytes()
    panels = len(_walk(t))
    assert t.nbytes() == tc.storage_ratio(NPAD, ct) * NPAD ** 2 * 4 \
        + 4 * panels


@pytest.mark.parametrize("name", ["f16x3_f32", "bf16x3_f32", "int8_f32"])
def test_treespd_carried_through_convert(name):
    """A reference TreeSPD (the packed factor) becomes the port's and goes
    back through numpy, bitwise and in its storage dtypes."""
    cr, ct = _cfgs(name)
    a = tc.pad_spd(torch.from_numpy(spd(N, 1)), LEAF)[0].numpy()
    ref = rtm.tree_potrf_packed(rtm.TreeSPD.from_dense(jnp.asarray(a), cr),
                                cr)
    port = convert.treespd_from_reference(ref, device="cpu")
    assert isinstance(port, tc.TreeSPD) and port.nbytes() == ref.nbytes()
    np.testing.assert_array_equal(port.to_dense().numpy(),
                                  np.asarray(ref.to_dense()))
    back = convert.treespd_to_numpy(port)

    def rebuild(t):
        if not isinstance(t, tc.TreeSPD):
            return jnp.asarray(t)
        return rtm.TreeSPD(rebuild(t.diag1), jnp.asarray(t.off),
                           jnp.asarray(t.off_scale), rebuild(t.diag2),
                           level=t.level, n1=t.n1, n=t.n)

    again = rebuild(back)
    for x, y in zip(jax.tree.leaves(again), jax.tree.leaves(ref)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert jax.tree.structure(again) == jax.tree.structure(ref)


# ---------------------------------------------------------------------------
# refinement and serving
# ---------------------------------------------------------------------------
def _off_the_edge(hist, tol):
    """No finite history entry within a factor 2 of its tolerance
    (tests/test_torch_refine.py says why)."""
    ok = ~np.isnan(hist)
    ratio = np.abs(np.log10(hist / np.broadcast_to(tol, hist.shape)))
    return bool((ratio[ok] > np.log10(2.0)).all())


def test_tree_refine_matches_reference():
    """refine_solve with engine="tree", f64 residuals (the reference under
    x64): per column the same sweeps, convergence and history pattern,
    history to the same digit."""
    n, k, tol = 300, 3, 1e-9
    a = spd(n, 10, np.float64)
    b = a @ np.random.default_rng(11).standard_normal((n, k))
    levels = ("bf16", "f32")
    fields = dict(max_sweeps=8, tol=tol, method="ir")
    with jax.enable_x64(True):
        ref = rc.refine_solve(a, b, rc.PrecisionConfig(
            levels=levels, leaf=LEAF, engine="tree"),
            refine=rc.RefineConfig(**fields))
        ref = {f: np.asarray(getattr(ref, f)) for f in ref._fields}
    port = tc.refine_solve(a, b, tc.PrecisionConfig(
        levels=levels, leaf=LEAF, engine="tree"),
        refine=tc.RefineConfig(**fields, residual_dtype="f64"), device="cpu")
    assert _off_the_edge(ref["history"], tol)
    np.testing.assert_array_equal(port.iterations.numpy(), ref["iterations"])
    np.testing.assert_array_equal(port.converged.numpy(), ref["converged"])
    hp, hr = port.history.numpy(), ref["history"]
    np.testing.assert_array_equal(np.isnan(hp), np.isnan(hr))
    ok = ~np.isnan(hr)
    assert np.abs(np.log10(hp[ok] / hr[ok])).max() < np.log10(2.0), hp
    assert bool(port.converged.all())


def test_tree_solver_engine_matches_reference():
    """SolverEngine on the tree engine (no cached linvs) answers a
    mixed-target batch with the reference's sweeps and convergence."""
    from repro import serve as rs
    n = 256
    a = spd(n, 3)
    bs = [(a @ np.random.default_rng(i).standard_normal(n)).astype(np.float32)
          for i in range(3)]
    # 12, not the clamped 20 of tests/test_torch_refine.py: the tree's
    # fourth sweep lands within a factor 2 of 1e-14 in the reference
    targets = [3.0, 8.0, 12.0]
    cfg = dict(levels=("f16", "f32"), leaf=LEAF, engine="tree")
    with jax.enable_x64(True):
        _, want = rs.SolverEngine(rc.PrecisionConfig(**cfg),
                                  max_sweeps=8).solve_batched(
            a, bs, rs.SolveOptions(target_digits=targets, cache_key="k"))
    eng = SolverEngine(tc.PrecisionConfig(**cfg), max_sweeps=8,
                       residual_dtype="f64", device="cpu")
    _, got = eng.solve_batched(
        a, bs, SolveOptions(target_digits=targets, cache_key="k"))
    assert eng.factor(a, "k")[1] is None            # the tree caches no linvs
    for g, w in zip(got, want):
        assert _off_the_edge(np.asarray(w.history[0]),
                             10.0 ** -w.target_digits)
        assert (g.sweeps, g.converged, g.target_digits) == \
            (w.sweeps, w.converged, w.target_digits)
        assert len(g.history[0]) == len(w.history[0])


@pytest.fixture(scope="module")
def tree_eng():
    return SolverEngine(tc.PrecisionConfig(levels=("f16", "f32"), leaf=LEAF,
                                           engine="tree"),
                        max_sweeps=8, device="cpu")


def test_tree_continuous_matches_window(tree_eng):
    """The serving determinism contract on the tree engine: 4 requests
    through a 2-slot continuous loop (two join mid-flight) and through one
    windowed call give the same x, bitwise, and the same sweeps and
    histories (n = 300: a ragged three-leaf recursion)."""
    a = spd(300, 1)
    rng = np.random.default_rng(5)
    bs = [(a @ rng.standard_normal(300)).astype(np.float32)
          for _ in range(4)]
    targets = [3.0, 6.0, 3.0, 6.0]
    xs_w, infos_w = tree_eng.solve_batched(
        a, bs, SolveOptions(target_digits=targets, cache_key="tree"))
    sch = BatchScheduler(tree_eng, max_batch=2, continuous=True)
    sch.start()
    futs = [sch.submit_async(a, b, SolveOptions(target_digits=t,
                                                cache_key="tree"))
            for b, t in zip(bs, targets)]
    outs = [f.result(timeout=120) for f in futs]
    sch.stop()
    for i, ((x_c, info_c), x_w, info_w) in enumerate(zip(outs, xs_w,
                                                         infos_w)):
        assert torch.equal(x_c, x_w), i
        assert info_c.sweeps == info_w.sweeps, i
        assert info_c.converged and info_w.converged, i
        assert info_c.history == info_w.history, i


def test_auto_engine_still_raises():
    cfg = tc.PrecisionConfig(leaf=LEAF, engine="auto")
    with pytest.raises(NotImplementedError, match="A8"):
        tc.cholesky(np.eye(LEAF, dtype=np.float32), cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="A8"):
        tc.refine_solve(np.eye(LEAF, dtype=np.float32),
                        np.ones(LEAF, np.float32), cfg, device="cpu")
