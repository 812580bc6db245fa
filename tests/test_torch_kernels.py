"""The port's kernels: plain versions against the JAX reference's oracles
(on the CPU), and the CUDA kernels against the plain versions (on a card).

Shapes and tolerances follow tests/test_kernels.py. The reference's
oracles (``repro.kernels.ref``) are what its own ``ops`` resolves to on
the CPU and are bitwise equal to its Pallas kernels in interpret mode
(tests/test_kernels.py pins that), so holding the port's plain versions
to them holds the port to the Pallas kernels.

The JAX reference is imported through the ``jx`` fixture only, so the
card-only cases (marker ``gpu``) also run on a machine that carries torch
and not jax: ``python -m pytest -m gpu tests/test_torch_kernels.py``.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.core.plan import build_plan
from repro_torch.core.precision import PrecisionConfig
from repro_torch.kernels import (ops, panel, potrf, qgemm, residual, syrk,
                                  trsm)
from repro_torch.kernels import ref as tref

torch.set_num_threads(2)

_TD = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}


@pytest.fixture(scope="module")
def jx():
    """jax.numpy and the reference's oracles (repro.kernels.ref)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref
    dt = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f16": jnp.float16}
    return types.SimpleNamespace(jnp=jnp, ref=ref, dt=dt)


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# plain versions vs the reference oracles (CPU)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 512, 128),
                                   (300, 200, 180), (64, 1000, 72)])
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
def test_qgemm_ref_shapes_dtypes(jx, m, k, n, dt):
    rng = np.random.default_rng(m + k + n)
    a, b = _rand(rng, (m, k)), _rand(rng, (k, n))
    want = jx.ref.qgemm_ref(jx.jnp.asarray(a, jx.dt[dt]),
                            jx.jnp.asarray(b, jx.dt[dt]), scale=1.7)
    got = ops.qgemm(torch.from_numpy(a).to(_TD[dt]),
                    torch.from_numpy(b).to(_TD[dt]), 1.7)
    # accumulation order differs between the two frameworks' GEMMs
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("beta", [0.0, 1.0, -0.5])
def test_qgemm_ref_epilogue(jx, trans_b, beta):
    rng = np.random.default_rng(5)
    a = _rand(rng, (192, 160))
    b = _rand(rng, (96, 160) if trans_b else (160, 96))
    c = _rand(rng, (192, 96))
    bf = jx.jnp.bfloat16
    want = jx.ref.qgemm_ref(jx.jnp.asarray(a, bf), jx.jnp.asarray(b, bf),
                            trans_b=trans_b, scale=0.3, c=jx.jnp.asarray(c),
                            beta=beta)
    got = ops.qgemm(torch.from_numpy(a).to(torch.bfloat16),
                    torch.from_numpy(b).to(torch.bfloat16), 0.3,
                    c=torch.from_numpy(c), beta=beta, trans_b=trans_b)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_qgemm_ref_int8_exact(jx):
    """int8 operands contract exactly in int32, as the reference does."""
    rng = np.random.default_rng(6)
    a = rng.integers(-127, 128, (200, 700)).astype(np.int8)
    b = rng.integers(-127, 128, (700, 90)).astype(np.int8)
    want = jx.ref.qgemm_ref(jx.jnp.asarray(a), jx.jnp.asarray(b),
                            scale=0.25)
    got = ops.qgemm(torch.from_numpy(a), torch.from_numpy(b), 0.25)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [128, 256, 384, 512])
def test_potrf_ref(jx, n):
    rng = np.random.default_rng(n)
    m = _rand(rng, (n, n))
    a = m @ m.T + n * np.eye(n, dtype=np.float32)
    want = jx.ref.potrf_ref(jx.jnp.asarray(a))
    got = ops.potrf(torch.from_numpy(a))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=3e-4, atol=3e-4 * n)
    assert (np.triu(got.numpy(), 1) == 0).all()


def test_potrf_ref_not_spd_is_nan(jx):
    """A matrix that is not SPD gives NaN on and below the diagonal, like
    the reference (torch.linalg.cholesky would raise instead)."""
    a = -np.eye(128, dtype=np.float32)
    want = np.asarray(jx.ref.potrf_ref(jx.jnp.asarray(a)))
    got = ops.potrf(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(np.tril(got)[np.tril_indices(128)]).all()


@pytest.mark.parametrize("n", [128, 256, 512])
def test_tri_inv_ref(jx, n):
    rng = np.random.default_rng(n + 1)
    l = np.tril(_rand(rng, (n, n))) + np.sqrt(n) * 4 * np.eye(
        n, dtype=np.float32)
    want = jx.ref.tri_inv_ref(jx.jnp.asarray(l))
    got = ops.tri_inv(torch.from_numpy(l))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the block order of the potrf_leaf and tri_inv_leaf kernels, emulated in
# plain torch (csrc/potrf.cu, csrc/tri_inv.cu; CPU)
# ---------------------------------------------------------------------------
_LB = 32


def _potrf_block_order(a):
    """Lower Cholesky factor in csrc/potrf.cu's order, in a's dtype:
    32-wide right-looking panels; each diagonal block factored column by
    column with r = rsqrt(pivot) (L[c][c] = pivot r, the column scaled by
    r); the rows below solved against it by multiplying with 1 / L[c][c];
    then the rank-32 update of every trailing block. NaN on and below the
    diagonal if a pivot is not positive."""
    b = a.shape[-1]
    w = torch.tril(a.clone())
    bad = False
    for p in range(b // _LB):
        s, below = slice(p * _LB, (p + 1) * _LB), slice((p + 1) * _LB, b)
        d = w[s, s]
        for c in range(_LB):
            piv = d[c, c].clone()
            bad |= not bool(piv > 0)
            r = torch.rsqrt(piv)
            d[c + 1:, c] *= r
            d[c, c] = piv * r
            d[c + 1:, c + 1:] -= torch.outer(d[c + 1:, c], d[c + 1:, c])
        d.copy_(torch.tril(d))
        x = w[below, s]
        for c in range(_LB):
            x[:, c] *= 1 / d[c, c]
            x[:, c + 1:] -= x[:, c:c + 1] * d[c + 1:, c][None, :]
        for j in range(p + 1, b // _LB):
            cj = slice(j * _LB, (j + 1) * _LB)
            w[j * _LB:, cj] -= w[j * _LB:, s] @ w[cj, s].T
        w[below, below] = torch.tril(w[below, below])
    return torch.full_like(w, float("nan")).tril() if bad else w


def _tri_inv_block_order(l):
    """Inverse of lower-triangular l in csrc/tri_inv.cu's order: each 32 x
    32 diagonal block inverted by substitution (a column a lane,
    multiplying by 1 / L[i][i]), then the doubling levels h = 1, 2, 4 ...
    blocks: [[A, 0], [C, B]]^-1 = [[A^-1, 0], [-B^-1 (C A^-1), B^-1]]."""
    b = l.shape[-1]
    nb = b // _LB
    x = torch.tril(l.clone())
    for i in range(nb):
        s = slice(i * _LB, (i + 1) * _LB)
        d, y = x[s, s].clone(), torch.eye(_LB, dtype=l.dtype)
        for r in range(_LB):
            y[r] *= 1 / d[r, r]
            y[r + 1:] -= d[r + 1:, r:r + 1] * y[r:r + 1]
        x[s, s] = torch.tril(y)
    h = 1
    while h < nb:
        for a0 in range(0, nb - h, 2 * h):
            b0 = a0 + h
            ab, bb = (slice(a0 * _LB, b0 * _LB),
                      slice(b0 * _LB, min(b0 + h, nb) * _LB))
            x[bb, ab] = -(x[bb, bb] @ (x[bb, ab] @ x[ab, ab]))
        h *= 2
    return x


def _leaf_tile(kind, b):
    """A diagonal tile of the paper's matrix at n = 16384 (symmetric
    uniform(-1, 1), + n on the diagonal), or an SPD tile with eigenvalues
    log-spaced over 1 .. 1e6 (condition number 1e6)."""
    rng = np.random.default_rng(b)
    if kind == "paper":
        m = rng.uniform(-1, 1, (b, b))
        return ((m + m.T) / 2 + 16384 * np.eye(b)).astype(np.float32)
    q, _ = np.linalg.qr(rng.standard_normal((b, b)))
    return ((q * np.logspace(0, 6, b)) @ q.T).astype(np.float32)


@pytest.mark.parametrize("kind", ["paper", "cond1e6"])
@pytest.mark.parametrize("b", [128, 256])
def test_potrf_block_order_matches_reference(jx, b, kind):
    """The kernel's order against the reference's plain potrf_ref at the
    kernel's tolerance (rtol 3e-4, atol 1e-6 max|L|). On the tile of
    condition 1e6 no f32 order meets that elementwise: the reference's own
    f32 factor lies 15-20 times outside it from the exact (f64) factor,
    so there the same rtol is taken normwise (both lie about 1.5e-5 from
    the exact factor)."""
    a = _leaf_tile(kind, b)
    want = np.asarray(jx.ref.potrf_ref(jx.jnp.asarray(a)))
    got = _potrf_block_order(torch.from_numpy(a)).numpy()
    assert (np.triu(got, 1) == 0).all()
    if kind == "paper":
        np.testing.assert_allclose(got, want, rtol=3e-4,
                                   atol=1e-6 * np.abs(want).max())
    else:
        assert np.linalg.norm(got - want) <= 3e-4 * np.linalg.norm(want)


def test_potrf_block_order_not_spd_is_nan(jx):
    a = _leaf_tile("paper", 128)
    a[100, 100] = -1.0
    want = np.asarray(jx.ref.potrf_ref(jx.jnp.asarray(a)))
    got = _potrf_block_order(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


@pytest.mark.parametrize("kind", ["paper", "cond1e6"])
@pytest.mark.parametrize("b", [128, 256])
def test_tri_inv_block_order_matches_reference(jx, b, kind):
    """The kernel's order against the reference's plain tri_inv_ref at the
    kernel's tolerance (rtol 1e-4, atol 1e-6 max|X|), on the factor of
    each tile (condition 1e3 for the tile of condition 1e6)."""
    l = np.array(jx.ref.potrf_ref(jx.jnp.asarray(_leaf_tile(kind, b))))
    want = np.asarray(jx.ref.tri_inv_ref(jx.jnp.asarray(l)))
    got = _tri_inv_block_order(torch.from_numpy(l)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-6 * np.abs(want).max())
    assert (np.triu(got, 1) == 0).all()


@pytest.mark.parametrize("name", ["pure_f32", "f32x3_f64"])
def test_diag_tri_inv_batched_cpu(jx, name):
    """diag_tri_inv (one batched call) on the CPU: bitwise the per-tile
    tri_inv_ref loop it replaced, read in place (f32) or converted tile by
    tile (f32 factor, f64 ladder); the f32 ladder also against the
    reference's diag_tri_inv at test_tri_inv_ref's tolerance."""
    import dataclasses

    from repro_torch.core import PAPER_CONFIGS, cholesky_padded, diag_tri_inv
    cfg = dataclasses.replace(PAPER_CONFIGS[name], leaf=128)
    rng = np.random.default_rng(21)
    m = rng.uniform(-1, 1, (512, 512))
    a = (m @ m.T + 512 * np.eye(512)).astype(np.float32)
    l = cholesky_padded(a, dataclasses.replace(cfg, levels=("f32",)),
                        device="cpu")
    got = diag_tri_inv(l, cfg)
    high = cfg.high_dtype
    want = torch.stack([tref.tri_inv_ref(l[i:i + 128, i:i + 128].to(high))
                        for i in range(0, 512, 128)])
    assert got.dtype == high and torch.equal(got, want)
    if name == "pure_f32":
        from repro.core import PAPER_CONFIGS as RCONFIGS
        from repro.core.blocked import diag_tri_inv as rdiag
        rcfg = dataclasses.replace(RCONFIGS[name], leaf=128)
        ref_inv = np.asarray(rdiag(jx.jnp.asarray(l.numpy()), rcfg))
        np.testing.assert_allclose(got.numpy(), ref_inv, rtol=1e-4,
                                   atol=1e-5)


def test_diag_tiles_is_a_view():
    l = torch.arange(512 * 512, dtype=torch.float32).reshape(512, 512)
    tiles = potrf.diag_tiles(l, 128)
    assert tiles.shape == (4, 128, 128)
    assert tiles.untyped_storage().data_ptr() == l.untyped_storage().data_ptr()
    for t in range(4):
        assert torch.equal(tiles[t], l[t * 128:(t + 1) * 128,
                                      t * 128:(t + 1) * 128])
    with pytest.raises(ValueError):
        potrf.diag_tiles(l[:, :500], 128)


def _panel_case(levels, nt, seed=3, b=128):
    meta = build_plan((nt + 1) * b,
                      PrecisionConfig(levels=levels, leaf=b)).panel_meta(0)
    rng = np.random.default_rng(seed)
    linv = np.tril(_rand(rng, (b, b)))
    linv[np.diag_indices(b)] += 3.0
    a21 = _rand(rng, (nt * b, b))
    c = _rand(rng, (nt * b, nt * b))
    kw = dict(store_names=meta.store_names, store_quants=meta.store_quants,
              pair_names=meta.pair_names, pair_quants=meta.pair_quants)
    return linv, a21, c, kw


#: one unit of the coarsest level's grid, relative to the tile's scale:
#: int8 steps by absmax/127, f16 and bf16 by their unit roundoff, f32 by a
#: few ulps of a GEMM sum
_GRID = {"int8": 1 / 127, "f16": 2.0 ** -10, "bf16": 2.0 ** -7, "f32": 1e-5}

_PANEL_CASES = [(("f32",), 2), (("f16", "f32"), 3), (("f16", "f16", "f32"), 4),
                (("bf16", "f32"), 2), (("int8", "f32"), 3)]


@pytest.mark.parametrize("rounding", [True, False])
@pytest.mark.parametrize("levels,nt", _PANEL_CASES)
def test_panel_update_ref(jx, levels, nt, rounding):
    """The port's fused panel update (in place) against the reference.
    Both go through f32 GEMMs that may differ in the last bit between
    torch and XLA, and a last-bit change can flip a rounding, so results
    are held to one unit of the coarsest level's grid. The strict upper
    triangle of c must pass through untouched."""
    linv, a21, c, kw = _panel_case(levels, nt)
    j = jx.jnp.asarray
    l21r, cr = jx.ref.panel_update_ref(j(linv), j(a21), j(c),
                                       rounding=rounding, **kw)
    a_t, c_t = torch.from_numpy(a21.copy()), torch.from_numpy(c.copy())
    ops.panel_update(torch.from_numpy(linv), a_t, c_t, rounding=rounding,
                     **kw)
    l21r, cr = np.asarray(l21r), np.asarray(cr)
    unit = _GRID[levels[0]]
    np.testing.assert_allclose(a_t.numpy(), l21r, rtol=0,
                               atol=unit * np.abs(l21r).max())
    np.testing.assert_allclose(c_t.numpy(), cr, rtol=0,
                               atol=unit * np.abs(cr).max())
    iu = np.triu_indices(nt * 128, 1)
    b = 128
    upper_tiles = (iu[0] // b) < (iu[1] // b)
    np.testing.assert_array_equal(c_t.numpy()[iu][upper_tiles],
                                  c[iu][upper_tiles])


def test_panel_round_tiles_matches_reference_f64(jx):
    """An "f32" tile in an f64 container rounds onto the f32 grid."""
    from jax import enable_x64
    rng = np.random.default_rng(4)
    x = rng.standard_normal((256, 256))
    with enable_x64():
        xj = jx.jnp.asarray(x)
        want = np.asarray(jx.ref._round_tiles(xj, "f32", False, 128))
        want8 = np.asarray(jx.ref._round_tiles(xj, "int8", True, 128))
    got = tref._round_tiles(torch.from_numpy(x), "f32", False, 128)
    got8 = tref._round_tiles(torch.from_numpy(x), "int8", True, 128)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got8.numpy(), want8)
    assert not np.array_equal(want, x)


_RESID_SHAPES = [(128, 1), (256, 4), (300, 3), (129, 130), (512, 8)]


@pytest.mark.parametrize("n,k", _RESID_SHAPES)
def test_residual_ref_shapes(jx, n, k):
    rng = np.random.default_rng(n + k)
    a, x, b = _rand(rng, (n, n)), _rand(rng, (n, k)), _rand(rng, (n, k))
    want = jx.ref.residual_ref(*(jx.jnp.asarray(v) for v in (a, x, b)))
    got = ops.residual(*(torch.from_numpy(v) for v in (a, x, b)))
    assert got.dtype == torch.float32
    # tests/test_kernels.py's tolerance: the two f32 sums run in other orders
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-3)


def test_residual_ref_vector_and_f64(jx):
    """A vector x gives a vector; f64 operands accumulate in f64 (the
    reference under x64), so the two agree to f64 roundoff."""
    import jax
    rng = np.random.default_rng(200)
    a, x, b = (rng.standard_normal(s) for s in ((200, 200), (200,), (200,)))
    with jax.enable_x64(True):
        want = np.asarray(jx.ref.residual_ref(
            *(jx.jnp.asarray(v) for v in (a, x, b))))
    got = ops.residual(*(torch.from_numpy(v) for v in (a, x, b)))
    assert got.shape == (200,) and got.dtype == torch.float64
    # 200-term f64 sums of O(10) entries in another order: 1e-12 absolute
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    got32 = ops.residual(*(torch.from_numpy(v.astype(np.float32))
                           for v in (a, x, b)))
    want32 = jx.ref.residual_ref(*(jx.jnp.asarray(v, jx.jnp.float32)
                                   for v in (a, x, b)))
    np.testing.assert_allclose(got32.numpy(), np.asarray(want32), rtol=2e-4,
                               atol=2e-3)


def test_plain_products_are_column_independent():
    """A column's residual and qgemm product are bitwise the same whatever
    the number of columns beside it and its position among them (torch's
    CPU GEMM alone is not: it changes kernels below 12 columns)."""
    rng = np.random.default_rng(7)
    n = 300
    a = torch.from_numpy(_rand(rng, (n, n)))
    x = torch.from_numpy(_rand(rng, (n, 32)))
    b = torch.from_numpy(_rand(rng, (n, 32)))
    full = ops.residual(a, x, b)
    prod = ops.qgemm(a, x)
    for cols in ([5], [5, 0], [31, 5, 9], list(range(5, 21))):
        got = ops.residual(a, x[:, cols], b[:, cols])
        assert torch.equal(got, full[:, cols]), cols
        assert torch.equal(ops.qgemm(a, x[:, cols]), prod[:, cols]), cols
    assert torch.equal(ops.residual(a, x[:, 5], b[:, 5]), full[:, 5])


# ---------------------------------------------------------------------------
# trsm / syrk, the tree engine's leaves (tests/test_kernels.py:176-228)
# ---------------------------------------------------------------------------
_TRSM_SHAPES = [(128, 128), (700, 256), (1024, 128), (65, 384)]
_SYRK_SHAPES = [(128, 128), (256, 1000), (256, 64)]
_PACKED_SHAPES = [(512, 256), (640, 300), (500, 513)]
#: the tree factor's trsm_leaf rows at n = 16384 (leaf 256)
_TREE_TRSM_M = (256, 512, 1024, 2048, 4096, 8192)


def _tri(rng, n):
    """A well-conditioned lower-triangular leaf (tests/test_kernels.py)."""
    return (np.tril(_rand(rng, (n, n)))
            + 4 * np.sqrt(n) * np.eye(n, dtype=np.float32))


@pytest.mark.parametrize("m,n", _TRSM_SHAPES)
def test_trsm_ref_right(jx, m, n):
    rng = np.random.default_rng(m + n)
    l, b = _tri(rng, n), _rand(rng, (m, n))
    want = jx.ref.trsm_ref(jx.jnp.asarray(b), jx.jnp.asarray(l))
    got = ops.trsm(torch.from_numpy(b), torch.from_numpy(l))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("trans", [False, True])
def test_trsm_ref_left(jx, trans):
    rng = np.random.default_rng(11)
    l, b = _tri(rng, 256), _rand(rng, (256, 192))
    want = jx.ref.trsm_ref(jx.jnp.asarray(b), jx.jnp.asarray(l),
                           side="left", trans=trans)
    got = ops.trsm(torch.from_numpy(b), torch.from_numpy(l), side="left",
                   trans=trans)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    # with a given inverse: the product the card runs, as the reference's
    # jnp path computes it
    linv = ops.tri_inv(torch.from_numpy(l))
    via = ops.trsm(torch.from_numpy(b), None, side="left", trans=trans,
                   linv=linv)
    np.testing.assert_allclose(via.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_trsm_ref_left_is_column_independent():
    """The left forms (the tree engine's solve sweeps on the CPU) give a
    column the same bits whatever columns share its block."""
    rng = np.random.default_rng(12)
    l = torch.from_numpy(_tri(rng, 256))
    b = torch.from_numpy(_rand(rng, (256, 16)))
    for trans in (False, True):
        full = ops.trsm(b, l, side="left", trans=trans)
        for cols in ([3], [3, 0], [15, 3, 7], list(range(2, 13))):
            got = ops.trsm(b[:, cols], l, side="left", trans=trans)
            assert torch.equal(got, full[:, cols]), (trans, cols)


@pytest.mark.parametrize("n,k", _SYRK_SHAPES)
@pytest.mark.parametrize("scale,beta", [(1.0, 1.0), (0.5, -0.25)])
def test_syrk_ref(jx, n, k, scale, beta):
    rng = np.random.default_rng(n + k)
    c, a = _rand(rng, (n, n)), _rand(rng, (n, k))
    want = np.asarray(jx.ref.syrk_ref(jx.jnp.asarray(c), jx.jnp.asarray(a),
                                      scale=scale, beta=beta))
    for packed in (False, True):
        got = ops.syrk(torch.from_numpy(c), torch.from_numpy(a), scale, beta,
                       packed=packed)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)
        iu = np.triu_indices(n, 1)
        np.testing.assert_array_equal(got.numpy()[iu], c[iu])


@pytest.mark.parametrize("dt", ["bf16", "f16", "int8"])
def test_syrk_ref_narrow_operands(jx, dt):
    """Narrow A: every product is exact in f32 and summed in f32 (int8
    through bf16, exact), with a 0-d tensor scale; the two packages sum
    in other orders, so they agree to f32 roundoff of the sums."""
    rng = np.random.default_rng(13)
    n, k = 256, 700
    c = _rand(rng, (n, n))
    if dt == "int8":
        a = rng.integers(-127, 128, (n, k)).astype(np.int8)
        aj, at = jx.jnp.asarray(a), torch.from_numpy(a)
    else:
        a = _rand(rng, (n, k))
        aj = jx.jnp.asarray(a, jx.dt[dt])
        at = torch.from_numpy(a).to(_TD[dt])
    scale = np.float32(0.37)
    want = np.asarray(jx.ref.syrk_ref(jx.jnp.asarray(c), aj,
                                      scale=jx.jnp.asarray(scale), beta=0.5))
    got = ops.syrk(torch.from_numpy(c), at, torch.tensor(scale), 0.5)
    assert got.dtype == torch.float32
    atol = 2 * k * 2.0 ** -24 * float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


def test_reference_interpret_kernels_match_port(jx):
    """One case each of the reference's Pallas trsm_leaf, syrk_leaf and
    syrk_packed in interpret mode (what the TPU kernels compute) against
    the port's dispatch on the CPU."""
    from repro.kernels import ops as rops
    rng = np.random.default_rng(14)
    l, b = _tri(rng, 256), _rand(rng, (700, 256))
    want = rops.trsm(b, l, impl="interpret")
    got = ops.trsm(torch.from_numpy(b), torch.from_numpy(l))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    for packed, (n, k) in ((False, (256, 1000)), (True, (500, 513))):
        c, a = _rand(rng, (n, n)), _rand(rng, (n, k))
        want = rops.syrk(c, a, 0.7, 0.9, packed=packed, impl="interpret")
        got = ops.syrk(torch.from_numpy(c), torch.from_numpy(a), 0.7, 0.9,
                       packed=packed)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-3)


def test_cpu_calls_count_no_launch():
    ops.reset_launches()
    ops.potrf(torch.eye(128))
    ops.qgemm(torch.eye(64), torch.eye(64))
    ops.residual(torch.eye(64), torch.ones(64), torch.ones(64))
    ops.trsm(torch.ones(64, 128), torch.eye(128))
    ops.trsm(torch.ones(128, 3), torch.eye(128), side="left")
    ops.syrk(torch.eye(128), torch.ones(128, 64), torch.tensor(0.5), 1.0)
    ops.syrk(torch.eye(100), torch.ones(100, 7), packed=True)
    got = ops.tri_inv_batched(potrf.diag_tiles(4 * torch.eye(256), 128))
    assert torch.equal(got, 0.25 * torch.eye(128).expand(2, 128, 128))
    assert set(ops.LAUNCHES.values()) == {0}
    assert set(ops.TILES.values()) == {0}


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch or raise; they never compute on the CPU."""
    with pytest.raises(ValueError):
        potrf.potrf_leaf(torch.eye(128))
    with pytest.raises(ValueError):
        potrf.tri_inv_leaf(torch.eye(128))
    with pytest.raises(ValueError):
        potrf.tri_inv_leaf_batched(torch.eye(128)[None])
    with pytest.raises(ValueError):
        qgemm.qgemm(torch.eye(64), torch.eye(64))
    with pytest.raises(ValueError):
        residual.residual_fused(torch.eye(64), torch.ones(64),
                                torch.ones(64))
    linv, a21, c, kw = _panel_case(("f32",), 2)
    with pytest.raises(ValueError):
        panel.panel_update(torch.from_numpy(linv), torch.from_numpy(a21),
                           torch.from_numpy(c), **kw)
    with pytest.raises(ValueError):
        trsm.trsm_leaf(torch.ones(64, 128), torch.eye(128))
    for fn in (syrk.syrk_leaf, syrk.syrk_packed):
        with pytest.raises(ValueError):
            fn(torch.eye(128), torch.ones(128, 64))


def test_ops_refuses_other_devices():
    with pytest.raises(ValueError):
        ops.potrf(torch.empty((128, 128), device="meta"))


# ---------------------------------------------------------------------------
# CUDA kernels vs plain versions (card only)
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
def test_qgemm_kernel(card, dt):
    rng = np.random.default_rng(1)
    a = torch.from_numpy(_rand(rng, (300, 200))).to(card, _TD[dt])
    b = torch.from_numpy(_rand(rng, (180, 200))).to(card, _TD[dt])
    c = torch.from_numpy(_rand(rng, (300, 180))).to(card)
    got = qgemm.qgemm(a, b, 0.3, c=c, beta=-0.5, trans_b=True)
    want = tref.qgemm_ref(a, b, trans_b=True, scale=0.3, c=c, beta=-0.5)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("n", [128, 256, 384, 512])
def test_potrf_tri_inv_kernels(card, n, dt):
    """Both leaf kernels against their plain versions on either route
    (shared-memory triangle or the tile in global memory), a strided view
    and out = a, repeated calls bitwise; the batched inverse bitwise equal
    to single launches, and a NaN tile in the batch leaving its
    neighbours' bits alone. f32 at the tolerances above; f64 at rtol 1e-10
    and atol 1e-12 of the result's largest entry."""
    dtype = {"f32": torch.float32, "f64": torch.float64}[dt]
    rng = np.random.default_rng(n)
    m = _rand(rng, (n, n)).astype(np.float64)
    a = torch.from_numpy(m @ m.T + n * np.eye(n)).to(card, dtype)
    l = potrf.potrf_leaf(a)
    want_l = tref.potrf_ref(a)

    def close(got, want, rtol32, atol32):
        if dt == "f32":
            torch.testing.assert_close(got, want, rtol=rtol32, atol=atol32)
        else:
            torch.testing.assert_close(
                got, want, rtol=1e-10,
                atol=1e-12 * float(want.abs().max()))

    close(l, want_l, 3e-4, 3e-4 * n)
    assert torch.equal(potrf.potrf_leaf(a), l)
    x = potrf.tri_inv_leaf(l)
    close(x, tref.tri_inv_ref(l), 1e-4, 1e-5)
    assert torch.equal(potrf.tri_inv_leaf(l), x)
    assert torch.equal(torch.triu(x, 1), torch.zeros_like(x))
    bad = potrf.potrf_leaf(-a)
    assert torch.equal(torch.isnan(bad), torch.isnan(tref.potrf_ref(-a)))
    # a strided view (lda = n + 9, unaligned start), and out = a
    big = torch.zeros((n + 5, n + 9), dtype=dtype, device=card)
    view = big[3:3 + n, 5:5 + n]
    view.copy_(a)
    lv = potrf.potrf_leaf(view)
    close(lv, want_l, 3e-4, 3e-4 * n)
    assert torch.equal(potrf.potrf_leaf(view, out=view), lv)
    assert torch.equal(big[3:3 + n, 5:5 + n], lv)
    # the batched inverse over the diagonal tiles of a (3n, 3n) matrix
    lbig = torch.zeros((3 * n, 3 * n), dtype=dtype, device=card)
    for t in range(3):
        lbig[t * n:(t + 1) * n, t * n:(t + 1) * n] = l * (t + 1)
    tiles = potrf.diag_tiles(lbig, n)
    got = potrf.tri_inv_leaf_batched(tiles)
    for t in range(3):
        assert torch.equal(got[t], potrf.tri_inv_leaf(tiles[t]))
    lbig[n:2 * n, n:2 * n] = float("nan")
    got_nan = potrf.tri_inv_leaf_batched(potrf.diag_tiles(lbig, n))
    assert torch.equal(got_nan[0], got[0]) and torch.equal(got_nan[2], got[2])
    assert bool(torch.isnan(got_nan[1].diagonal()).all())


@pytest.mark.gpu
@pytest.mark.parametrize("rounding", [True, False])
@pytest.mark.parametrize("levels,nt", _PANEL_CASES)
def test_panel_update_kernel(card, levels, nt, rounding):
    linv, a21, c, kw = _panel_case(levels, nt)
    lt = torch.from_numpy(linv).to(card)
    l21r, cr = tref.panel_update_ref(lt, torch.from_numpy(a21).to(card),
                                     torch.from_numpy(c).to(card),
                                     rounding=rounding, **kw)
    a_k = torch.from_numpy(a21).to(card)
    c_k = torch.from_numpy(c).to(card)
    panel.panel_update(lt, a_k, c_k, rounding=rounding, **kw)
    unit = _GRID[levels[0]]
    torch.testing.assert_close(a_k, l21r, rtol=0,
                               atol=unit * l21r.abs().max().item())
    torch.testing.assert_close(c_k, cr, rtol=0,
                               atol=unit * cr.abs().max().item())



@pytest.mark.gpu
@pytest.mark.parametrize("n,k", _RESID_SHAPES + [(16384, 16)])
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_residual_kernel(card, n, k, dt):
    dtype = torch.float32 if dt == "f32" else torch.float64
    g = torch.Generator(device=card).manual_seed(n + k)
    a, x, b = (torch.randn(s, generator=g, device=card, dtype=dtype)
               for s in ((n, n), (n, k), (n, k)))
    got = residual.residual_fused(a, x, b)
    want = tref.residual_ref(a, x, b)
    # n-term sums of N(0, 1) products in other orders: f32 at the
    # reference suite's tolerance, f64 at 1e-12 relative to sqrt(n)
    tol = (dict(rtol=2e-4, atol=2e-3) if dt == "f32"
           else dict(rtol=0, atol=1e-12 * n ** 0.5))
    torch.testing.assert_close(got, want, **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_residual_kernel_columns_bitwise(card, dt):
    """Column j's result does not depend on k, on its position, on its
    neighbours, on the strides of x/b or on the A load path (aligned 16-byte
    loads vs scalar loads for a ragged leading dimension)."""
    dtype = torch.float32 if dt == "f32" else torch.float64
    g = torch.Generator(device=card).manual_seed(3)
    n = 300
    big = torch.randn((304, 304), generator=g, device=card, dtype=dtype)
    a_view = big[:n, :n]                  # leading dimension 304: aligned
    a_tight = a_view.contiguous()         # leading dimension 300: scalar
    x = torch.randn((n, 32), generator=g, device=card, dtype=dtype)
    b = torch.randn((n, 32), generator=g, device=card, dtype=dtype)
    full = residual.residual_fused(a_view, x, b)
    assert torch.equal(residual.residual_fused(a_tight, x, b), full)
    other = torch.randn((n, 16), generator=g, device=card, dtype=dtype)
    x16, b16 = other.clone(), other.clone()
    x16[:, 7], b16[:, 7] = x[:, 5], b[:, 5]
    assert torch.equal(residual.residual_fused(a_view, x16, b16)[:, 7],
                       full[:, 5])
    for cols in ([5, 0], [5], [9, 31, 5]):
        got = residual.residual_fused(a_view, x[:, cols], b[:, cols])
        assert torch.equal(got, full[:, cols]), cols
    assert torch.equal(residual.residual_fused(a_view, x[:, 5], b[:, 5]),
                       full[:, 5])
    inplace = b.clone()
    residual.residual_fused(a_view, x, inplace, out=inplace)
    assert torch.equal(inplace, full)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [129, 300, 1000, 4097])
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_residual_kernel_ring_shapes(card, n, dt):
    """The shared-memory ring at ragged n (a partial last chunk of A and x,
    a partial last band of rows) and at k = 1, 3, 16 and 32 (f64 at k = 16
    splits a band's columns between two warps): within the tolerance of
    test_residual_kernel, and each column bitwise equal to the same column
    computed alone (k = 1)."""
    dtype = torch.float32 if dt == "f32" else torch.float64
    g = torch.Generator(device=card).manual_seed(n)
    a = torch.randn((n, n), generator=g, device=card, dtype=dtype)
    tol = (dict(rtol=2e-4, atol=2e-3) if dt == "f32"
           else dict(rtol=0, atol=1e-12 * n ** 0.5))
    for k in (1, 3, 16, 32):
        x = torch.randn((n, k), generator=g, device=card, dtype=dtype)
        b = torch.randn((n, k), generator=g, device=card, dtype=dtype)
        got = residual.residual_fused(a, x, b)
        torch.testing.assert_close(got, tref.residual_ref(a, x, b), **tol)
        for j in {0, k // 2, k - 1}:
            one = residual.residual_fused(a, x[:, j:j + 1], b[:, j:j + 1])
            assert torch.equal(one[:, 0], got[:, j]), (k, j)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_residual_kernel_row_block(card, dt):
    """A block row of A (m < n rows, what a rank of the distributed solver
    holds): each of its rows bitwise the same row of the square launch,
    since a row's n products are summed in an order fixed by n alone."""
    dtype = torch.float32 if dt == "f32" else torch.float64
    g = torch.Generator(device=card).manual_seed(7)
    n = 1000
    a = torch.randn((n, n), generator=g, device=card, dtype=dtype)
    for k in (1, 16):
        x = torch.randn((n, k), generator=g, device=card, dtype=dtype)
        b = torch.randn((n, k), generator=g, device=card, dtype=dtype)
        full = residual.residual_fused(a, x, b)
        for r0, r1 in ((0, 250), (750, 1000), (3, 300)):
            part = residual.residual_fused(a[r0:r1], x, b[r0:r1])
            assert part.shape == (r1 - r0, k)
            assert torch.equal(part, full[r0:r1]), (k, r0, r1)


def _syrk_atol(c, a, scale, beta):
    """A bound on |kernel - plain| for two sums of k products in other
    orders: each is within k u sum|a_i a_j| of the exact sum (plus one
    rounding of beta c), and sum|a_i a_j| <= max_i (A A^T)_ii (Cauchy-
    Schwarz). u is the accumulator's unit roundoff; the int8 kernel sums
    exactly in s32, so its whole difference is the plain version's."""
    wide = torch.float64 in (c.dtype, a.dtype)
    u = 2.0 ** -53 if wide else 2.0 ** -24
    aw = a.to(torch.float64)
    diag = float((aw * aw).sum(dim=1).max())
    k = a.shape[1]
    return 2 * (k + 2) * u * (abs(float(scale)) * diag
                              + abs(float(beta)) * float(c.abs().max()))


#: A's type; "f32-c64" is f32 A with an f64 C (ladder f32x3_f64)
_SYRK_TYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
               "f16": torch.float16, "int8": torch.int8,
               "f64": torch.float64, "f32-c64": torch.float32}


def _syrk_operands(card, n, k, dt, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    cdt = torch.float64 if "64" in dt else torch.float32
    c = torch.randn((n, n), generator=g, device=card, dtype=cdt)
    if dt == "int8":
        a = torch.randint(-127, 128, (n, k), generator=g, device=card,
                          dtype=torch.int8)
    else:
        a = torch.randn((n, k), generator=g, device=card).to(_SYRK_TYPES[dt])
    return c, a


@pytest.mark.gpu
@pytest.mark.parametrize("m,n", _TRSM_SHAPES
                         + [(m, 256) for m in _TREE_TRSM_M])
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_trsm_leaf_kernel(card, m, n, dt):
    dtype = torch.float32 if dt == "f32" else torch.float64
    rng = np.random.default_rng(m + n)
    l = torch.from_numpy(_tri(rng, n)).to(card, dtype)
    big = torch.from_numpy(_rand(rng, (m, n + 32))).to(card, dtype)
    # torch's triangular solve may return a column-major inverse
    linv = tref.tri_inv_ref(l).contiguous()
    u = 2.0 ** -24 if dt == "f32" else 2.0 ** -53
    dirty = linv + torch.triu(torch.full_like(linv, 1e3), 1)
    route = trsm.plan(m, n, dtype).route
    # rows read through the leading dim: on the 16-byte grid, and off it
    # (one element a load)
    for b in (big[:, 16:16 + n], big[:, 1:1 + n]):
        got = trsm.trsm_leaf(b, linv)
        want = tref.qgemm_ref(b, linv, trans_b=True, out_dtype=dtype)
        atol = 2 * (n + 1) * u * float((b.abs() @ linv.abs().T).max())
        torch.testing.assert_close(got, want, rtol=0, atol=atol)
        # only the lower triangle of linv is read; the same bits again
        assert torch.equal(trsm.trsm_leaf(b, dirty), got)
        assert torch.equal(trsm.trsm_leaf(b, linv), got)
    # the dispatch: tri_inv_leaf + trsm_leaf against the solve, on the
    # plan's route
    before = dict(ops.TRSM_ROUTES)
    torch.testing.assert_close(ops.trsm(b, l), tref.trsm_ref(b, l),
                               rtol=2e-4, atol=2e-4)
    assert ops.TRSM_ROUTES[route] == before[route] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("n,k", _SYRK_SHAPES + [(256, 8192)])
@pytest.mark.parametrize("dt", list(_SYRK_TYPES))
def test_syrk_leaf_kernel(card, n, k, dt):
    c, a = _syrk_operands(card, n, k, dt, n + k)
    scale = torch.tensor(0.37, device=card)       # read on the card
    got = syrk.syrk_leaf(c, a, scale, -0.25)
    want = tref.syrk_ref(c, a, scale=scale, beta=-0.25)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=_syrk_atol(c, a, 0.37, -0.25))
    assert torch.equal(torch.triu(got, 1), torch.triu(c, 1))
    # in place, and the same bits run to run (fixed split, no atomics)
    inplace = c.clone()
    syrk.syrk_leaf(inplace, a, scale, -0.25, out=inplace)
    assert torch.equal(inplace, got)


@pytest.mark.gpu
@pytest.mark.parametrize("n,k", _PACKED_SHAPES
                         + [(1000, 512), (2048, 192), (300, 256)])
@pytest.mark.parametrize("dt", list(_SYRK_TYPES))
def test_syrk_packed_kernel(card, n, k, dt):
    c, a = _syrk_operands(card, n, k, dt, n * k)
    scale = torch.tensor(0.7, device=card)        # read on the card
    before = dict(ops.SYRK_PACKED_ROUTES)
    got = ops.syrk(c, a, scale, 0.9, packed=True)
    major = qgemm.layout(n, k, *a.stride(), a.element_size(),
                         a.data_ptr() % qgemm.ALIGN)[0]
    route = syrk.packed_plan(n, k, a.dtype, c.dtype, major).route
    assert ops.SYRK_PACKED_ROUTES[route] == before[route] + 1
    if a.dtype in syrk.TC_DTYPES:
        assert route == ("tc" if major == "k" else "tc_staged")
    want = tref.syrk_ref(c, a, scale=scale, beta=0.9)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=_syrk_atol(c, a, 0.7, 0.9))
    assert torch.equal(torch.triu(got, 1), torch.triu(c, 1))
    if dt == "int8":
        # exact s32 sums: only the epilogue rounds, (s * scale) + (beta c)
        s = (a.double() @ a.double().T).float()
        exact = torch.where(torch.ones_like(c, dtype=torch.bool).tril(),
                            s * scale + 0.9 * c, c)
        assert torch.equal(got, exact)
    # in place, and the same bits run to run
    inplace = c.clone()
    syrk.syrk_packed(inplace, a, scale, 0.9, out=inplace)
    assert torch.equal(inplace, got)
    assert torch.equal(syrk.syrk_packed(c, a, scale, 0.9), got)


@pytest.mark.gpu
def test_tri_decode_exact(card):
    """The decode the kernels run (tests/test_kernels.py:
    test_tri_decode_exact, for csrc/common.cuh:tri_decode)."""
    i, j = (t.cpu().numpy().astype(np.int64)
            for t in syrk.tri_decode(200000, card))
    np.testing.assert_array_equal(i * (i + 1) // 2 + j, np.arange(200000))
    assert (j <= i).all() and (j >= 0).all()


@pytest.mark.gpu
def test_qgemm_device_scale(card):
    """A 0-d tensor scale is read on the card and gives the float scale's
    bits; f32 operands with an f64 accumulator run in f64."""
    g = torch.Generator(device=card).manual_seed(4)
    a = torch.randn((300, 200), generator=g, device=card)
    b = torch.randn((180, 200), generator=g, device=card)
    c = torch.randn((300, 180), generator=g, device=card)
    s = torch.tensor(-0.3, device=card)
    assert torch.equal(qgemm.qgemm(a, b, s, c=c, beta=1.0, trans_b=True),
                       qgemm.qgemm(a, b, float(s), c=c, beta=1.0,
                                   trans_b=True))
    c64 = c.double()
    got = qgemm.qgemm(a, b, s, c=c64, beta=1.0, trans_b=True,
                      out_dtype=torch.float64)
    want = tref.qgemm_ref(a, b, trans_b=True, scale=s, c=c64, beta=1.0,
                          out_dtype=torch.float64)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# batched forms (K-FAC's refactor and whitening): the plain versions on the
# CPU against the reference's oracles under jax.vmap, the kernels on the
# card against one launch a matrix (bitwise) and the plain versions
# ---------------------------------------------------------------------------
def _spd_stack(rng, nb, n, scales):
    m = rng.uniform(-1, 1, (nb, n, n))
    a = (m + m.transpose(0, 2, 1)) / 2 + n * np.eye(n)
    return (a * np.asarray(scales)[:, None, None]).astype(np.float32)


@pytest.mark.parametrize("kernel", ["potrf", "tri_inv", "qgemm", "panel"])
def test_batched_plain_versions(jx, kernel):
    """Each *_batched_ref is its unbatched plain version a matrix (bitwise)
    and agrees with the reference's oracle under jax.vmap at the unbatched
    tests' tolerances (potrf/tri_inv: test_potrf_ref's and
    test_tri_inv_ref's; qgemm with a per-matrix scale: rtol 2e-5; panel:
    one unit of the coarsest level's grid, as test_panel_update_ref)."""
    import functools

    import jax
    rng = np.random.default_rng(7)
    j = jx.jnp.asarray
    if kernel in ("potrf", "tri_inv"):
        a = _spd_stack(rng, 3, 128, [1.0, 1e3, 1e-3])
        if kernel == "tri_inv":
            a = np.stack([np.linalg.cholesky(x.astype(np.float64))
                          for x in a]).astype(np.float32)
        fn = tref.potrf_batched_ref if kernel == "potrf" else \
            tref.tri_inv_batched_ref
        one = tref.potrf_ref if kernel == "potrf" else tref.tri_inv_ref
        rfn = jx.ref.potrf_ref if kernel == "potrf" else jx.ref.tri_inv_ref
        got = fn(torch.from_numpy(a))
        for i in range(3):
            assert torch.equal(got[i], one(torch.from_numpy(a[i])))
        want = np.asarray(jax.vmap(rfn)(j(a)))
        scale = np.abs(want).reshape(3, -1).max(axis=1)[:, None, None]
        np.testing.assert_allclose(got.numpy() / scale, want / scale,
                                   rtol=0, atol=2e-5)
        return
    if kernel == "qgemm":
        a = _rand(rng, (4, 64, 96))
        b = _rand(rng, (4, 80, 96))
        c = _rand(rng, (4, 64, 80))
        s = np.array([0.5, -2.0, 1e-3, 7.0], np.float32)
        got = tref.qgemm_batched_ref(
            torch.from_numpy(a), torch.from_numpy(b), trans_b=True,
            scale=torch.from_numpy(s), c=torch.from_numpy(c), beta=-1.0)
        for i in range(4):
            assert torch.equal(got[i], tref.qgemm_ref(
                torch.from_numpy(a[i]), torch.from_numpy(b[i]), trans_b=True,
                scale=float(s[i]), c=torch.from_numpy(c[i]), beta=-1.0))
        want = jax.vmap(lambda x, y, z, w: jx.ref.qgemm_ref(
            x, y, trans_b=True, scale=w, c=z, beta=-1.0))(
                j(a), j(b), j(c), j(s))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)
        return
    linv, a21, c, kw = _panel_case(("int8", "f32"), 2)
    sc = np.array([1.0, 1e3, 1e-3], np.float32)[:, None, None]
    linvs = np.stack([linv] * 3)
    a21s, cs = a21[None] * sc, c[None] * sc
    got = tref.panel_update_batched_ref(
        torch.from_numpy(linvs), torch.from_numpy(a21s),
        torch.from_numpy(cs), **kw)
    for i in range(3):
        one = tref.panel_update_ref(
            torch.from_numpy(linv), torch.from_numpy(a21s[i]),
            torch.from_numpy(cs[i]), **kw)
        assert torch.equal(got[0][i], one[0]) and torch.equal(got[1][i],
                                                              one[1])
    fn = functools.partial(jx.ref.panel_update_ref, **kw)
    wl, wc = jax.vmap(fn)(j(linvs), j(a21s), j(cs))
    for g, w in ((got[0], wl), (got[1], wc)):
        w = np.asarray(w)
        scale = np.abs(w).reshape(3, -1).max(axis=1)[:, None, None]
        np.testing.assert_allclose(g.numpy() / scale, w / scale, rtol=0,
                                   atol=1 / 127)


def test_batched_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError):
        potrf.potrf_leaf_batched(torch.eye(128)[None])
    with pytest.raises(ValueError):
        qgemm.qgemm(torch.eye(64)[None], torch.eye(64)[None])
    linv, a21, c, kw = _panel_case(("f32",), 2)
    with pytest.raises(ValueError):
        panel.panel_update(torch.from_numpy(linv)[None],
                           torch.from_numpy(a21)[None],
                           torch.from_numpy(c)[None], **kw)


def test_ops_stacks_run_the_batched_plain_versions():
    """On the CPU, ops given a stack (3-D operands) runs the batched plain
    version (bitwise) and counts no launch; the right trsm takes no
    stack."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(_spd_stack(rng, 3, 128, [1.0, 1e3, 1e-3]))
    ops.reset_launches()
    l = ops.potrf(a)
    assert torch.equal(l, tref.potrf_batched_ref(a))
    assert torch.equal(ops.tri_inv(l), tref.tri_inv_batched_ref(l))
    x = torch.from_numpy(_rand(rng, (3, 128, 40)))
    s = torch.tensor([0.5, -2.0, 3.0])
    assert torch.equal(ops.qgemm(l, x, s, c=x, beta=1.0),
                       tref.qgemm_batched_ref(l, x, scale=s, c=x, beta=1.0))
    for trans in (False, True):
        assert torch.equal(ops.trsm(x, l, side="left", trans=trans),
                           tref.trsm_batched_ref(x, l, trans=trans))
    with pytest.raises(NotImplementedError):
        ops.trsm(x.mT, l)
    linv, a21, c, kw = _panel_case(("int8", "f32"), 2)
    stack = [torch.from_numpy(np.stack([v] * 2)) for v in (linv, a21, c)]
    want = tref.panel_update_batched_ref(*stack, **kw)
    got = ops.panel_update(*stack, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for counts in (ops.LAUNCHES, ops.BATCHED, ops.TILES):
        assert set(counts.values()) == {0}


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("b", [64, 128, 256, 512])
def test_potrf_leaf_batched_kernel(card, b, dt):
    """potrf_leaf_batched over the diagonal tiles of a stack, read in
    place: each tile bitwise one potrf_leaf launch on it, a NaN tile
    (not SPD) leaving the others alone, and within test_potrf_tri_inv_
    kernels' tolerance of the plain version."""
    dtype = {"f32": torch.float32, "f64": torch.float64}[dt]
    rng = np.random.default_rng(b)
    a = torch.from_numpy(_spd_stack(rng, 5, b, [1, 1e3, 1e-3, 1, 7])).to(
        card, dtype)
    big = torch.zeros((5, b + 64, b + 64), dtype=dtype, device=card)
    big[:, 32:32 + b, 64:64 + b] = a
    tiles = big[:, 32:32 + b, 64:64 + b]
    got = potrf.potrf_leaf_batched(tiles)
    for i in range(5):
        assert torch.equal(got[i], potrf.potrf_leaf(tiles[i]))
    want = tref.potrf_batched_ref(a)
    for i in range(5):
        s = float(want[i].abs().max())
        tol = 3e-4 if dt == "f32" else 1e-12
        torch.testing.assert_close(got[i] / s, want[i] / s, rtol=0, atol=tol)
    tiles[2] = -tiles[2]
    bad = potrf.potrf_leaf_batched(tiles)
    assert bool(torch.isnan(bad[2].diagonal()).all())
    for i in (0, 1, 3, 4):
        assert torch.equal(bad[i], got[i])


_BATCHED_PANEL = [(("bf16", "f32"), 3, 128), (("f16", "f16", "f32"), 3, 128),
                  (("int8", "f32"), 2, 256), (("f32",), 2, 128),
                  (("f16", "f32"), 2, 384)]


@pytest.mark.gpu
@pytest.mark.parametrize("levels,nt,b", _BATCHED_PANEL)
def test_panel_update_batched_kernel(card, levels, nt, b):
    """panel_update on panel 0 of a (N, n, n) working stack
    (blocks at scales 1, 1e3, 1e-3: a scale taken across the batch would
    move the small blocks' grids): each matrix bitwise the one-matrix
    launch on a copy, within one grid unit of the plain version, and
    PANEL_ROUTES counting every matrix's pairs."""
    cfg = PrecisionConfig(levels=levels, leaf=b)
    meta = build_plan((nt + 1) * b, cfg).panel_meta(0)
    kw = dict(store_names=meta.store_names, store_quants=meta.store_quants,
              pair_names=meta.pair_names, pair_quants=meta.pair_quants)
    rng = np.random.default_rng(nt * b)
    n = (nt + 1) * b
    w = torch.from_numpy(_spd_stack(rng, 3, n, [1, 1e3, 1e-3])).to(card)
    lpp = torch.stack([tref.potrf_ref(w[i, :b, :b]) for i in range(3)])
    linv = torch.stack([tref.tri_inv_ref(x) for x in lpp])
    singles = []
    for i in range(3):
        wi = w[i].clone()
        panel.panel_update(linv[i], wi[b:, :b], wi[b:, b:], **kw)
        singles.append(wi)
    ref_l, ref_c = tref.panel_update_batched_ref(linv, w[:, b:, :b],
                                                 w[:, b:, b:], **kw)
    ops.reset_launches()
    ops.panel_update(linv, w[:, b:, :b], w[:, b:, b:], **kw)
    assert ops.LAUNCHES["panel_update"] == 1 == ops.BATCHED["panel_update"]
    pairs = nt * (nt + 1) // 2
    assert sum(ops.PANEL_ROUTES.values()) == 3 * pairs
    unit = _GRID[levels[0]]
    for i in range(3):
        assert torch.equal(w[i], singles[i])
        for got, want in ((w[i, b:, :b], ref_l[i]), (w[i, b:, b:], ref_c[i])):
            s = float(want.abs().max())
            torch.testing.assert_close(got, want, rtol=0, atol=unit * s)


@pytest.mark.gpu
@pytest.mark.parametrize("dt,trans_b,n,a_mn", [
    ("f32", False, 256, False), ("f32", True, 2048, False),
    ("f32", False, 16, False), ("bf16", False, 256, False),
    ("bf16", True, 300, False), ("f16", False, 2048, False),
    ("int8", True, 256, False), ("int8", False, 256, False),
    ("f32", True, 40, False), ("f32", False, 256, True),
    ("f32", False, 2048, True), ("f32", False, 16, True),
    ("bf16", False, 256, True), ("f16", True, 2048, True),
    ("int8", False, 256, True)])
def test_qgemm_batched_kernel(card, dt, trans_b, n, a_mn):
    """qgemm over a stack of N = 5 products with a per-matrix scale, on
    the route each layout takes (MN-major int8 operands staged; ``a_mn``:
    A the transpose of a K-major stack, as the whitening's back sweep
    passes its inverses and L21^T): each product bitwise the one-matrix
    call (with its scale as a float) and within test_qgemm_kernel's
    tolerance of the plain version (int8 bitwise)."""
    td = {"f32": torch.float32, "bf16": torch.bfloat16,
          "f16": torch.float16, "int8": torch.int8}[dt]
    g = torch.Generator(device=card).manual_seed(n)
    N, M, K = 5, 256, 256 if dt != "f32" or n > 16 else 1024

    def operand(shape):
        x = torch.randn(shape, generator=g, device=card)
        return (x * 40).round().clamp(-127, 127).to(td) if dt == "int8" \
            else x.to(td)
    a = operand((N, K, M)).mT if a_mn else operand((N, M, K))
    b = operand((N, n, K) if trans_b else (N, K, n))
    c = torch.randn((N, M, n), generator=g, device=card)
    s = torch.tensor([0.5, -2.0, 1e-3, 7.0, 1.0], device=card)
    ops.reset_launches()
    got = ops.qgemm(a, b, s, c=c, beta=-1.0, trans_b=trans_b)
    assert ops.LAUNCHES["qgemm"] == 1 == ops.BATCHED["qgemm"]
    if a_mn:
        route = "tc_staged" if dt == "int8" else "tc" if td in \
            qgemm.TC_DTYPES else None
        assert route is None or ops.QGEMM_ROUTES[route] == 1
    for i in range(N):
        one = qgemm.qgemm(a[i], b[i], float(s[i]), c=c[i], beta=-1.0,
                          trans_b=trans_b)
        assert torch.equal(got[i], one)
    want = tref.qgemm_batched_ref(a, b, trans_b=trans_b, scale=s, c=c,
                                  beta=-1.0)
    if dt == "int8":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=1e-4 * K ** .5)
