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
from repro_torch.kernels import ops, panel, potrf, qgemm, residual
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


def test_cpu_calls_count_no_launch():
    ops.reset_launches()
    ops.potrf(torch.eye(128))
    ops.qgemm(torch.eye(64), torch.eye(64))
    ops.residual(torch.eye(64), torch.ones(64), torch.ones(64))
    assert set(ops.LAUNCHES.values()) == {0}


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch or raise; they never compute on the CPU."""
    with pytest.raises(ValueError):
        potrf.potrf_leaf(torch.eye(128))
    with pytest.raises(ValueError):
        potrf.tri_inv_leaf(torch.eye(128))
    with pytest.raises(ValueError):
        qgemm.qgemm(torch.eye(64), torch.eye(64))
    with pytest.raises(ValueError):
        residual.residual_fused(torch.eye(64), torch.ones(64),
                                torch.ones(64))
    linv, a21, c, kw = _panel_case(("f32",), 2)
    with pytest.raises(ValueError):
        panel.panel_update(torch.from_numpy(linv), torch.from_numpy(a21),
                           torch.from_numpy(c), **kw)


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
@pytest.mark.parametrize("n", [128, 256, 512])
def test_potrf_tri_inv_kernels(card, n):
    rng = np.random.default_rng(n)
    m = _rand(rng, (n, n))
    a = torch.from_numpy(m @ m.T + n * np.eye(n, dtype=np.float32)).to(card)
    l = potrf.potrf_leaf(a)
    torch.testing.assert_close(l, tref.potrf_ref(a), rtol=3e-4,
                               atol=3e-4 * n)
    torch.testing.assert_close(potrf.tri_inv_leaf(l), tref.tri_inv_ref(l),
                               rtol=1e-4, atol=1e-5)
    bad = potrf.potrf_leaf(-a)
    assert torch.equal(torch.isnan(bad), torch.isnan(tref.potrf_ref(-a)))


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
