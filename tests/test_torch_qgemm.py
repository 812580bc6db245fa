"""The qgemm routes: the planner (plain Python), a plain-torch emulation of
the fixed-order k-split against both packages' plain versions (CPU), and
each route of the CUDA kernel against the plain version (card only).

The planner's contract (``kernels/qgemm.py``): the order in which a
column's products are summed, the kernel family (tensor cores or CUDA
cores) and its k-split, follows M, K, the dtypes and the operands'
layouts, never N; the chunks cover k exactly, in order; the tensor-core
stage is whole ``wgmma`` k-steps; an operand the kernel cannot read (an
MN-major int8 operand, or one off TMA's 16-byte grid) is staged, not
read wrongly. The card cases mirror ``chip_smoke.py:kernel_qgemm`` at
small shapes: ``python -m pytest -m gpu tests/test_torch_qgemm.py``.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, qgemm, syrk
from repro_torch.kernels import ref as tref

torch.set_num_threads(2)

_FAMILY = {"tc": "tc", "tc_staged": "tc", "simt_ksplit": "simt",
           "simt_tile": "simt", "simt_narrow": "simt"}
_DT = {"f32": torch.float32, "f64": torch.float64, "f16": torch.float16,
       "bf16": torch.bfloat16, "int8": torch.int8}


@pytest.fixture(scope="module")
def jx():
    """jax.numpy and the reference's oracles (repro.kernels.ref)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref
    return types.SimpleNamespace(jnp=jnp, ref=ref)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _chunk_bounds(K, p):
    """The k-ranges of a plan's chunks, in the order the kernel's second
    pass adds them (chunk z is [z kc, min(K, (z + 1) kc)), csrc/qgemm.cu)."""
    return [(q * p.kc, min(K, (q + 1) * p.kc)) for q in range(p.chunks)]


def _order(p):
    """What fixes a column's summation: family, k-chunk and chunk count
    (the tensor-core tile is fixed, so its whole plan bar staging)."""
    return (_FAMILY[p.route], p.kc, p.chunks, p.tile if
            _FAMILY[p.route] == "tc" else None)


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------
# the tree factor's and the sweeps' shapes at n = 16384, and ragged ones
_SHAPES = [(256, 8192), (512, 8192), (1024, 8192), (4096, 8192), (8192, 256),
           (16128, 256), (256, 256), (300, 1000), (1, 7), (7, 1)]


@pytest.mark.parametrize("dt", ["f32", "f64", "f16", "bf16", "int8"])
@pytest.mark.parametrize("majors", [("k", "k"), ("mn", "mn"), ("k", None)])
def test_plan_order_is_independent_of_n(dt, majors):
    for M, K in _SHAPES:
        orders = {_order(qgemm.plan(M, n, K, _DT[dt], *majors))
                  for n in (1, 7, 16, 48, 49, 256, 1000)}
        assert len(orders) == 1, (dt, M, K, orders)


@pytest.mark.parametrize("M,K", _SHAPES + [(0, 5), (64, 0), (128, 100003)])
def test_plan_chunks_cover_k_in_order(M, K):
    for acc in (torch.float32, torch.float64):
        p = qgemm.plan(M, 16, K, acc, "k", "k")
        assert p.kc % qgemm.SIMT_BK == 0 and p.kc > 0
        bounds = _chunk_bounds(K, p)
        assert bounds[0][0] == 0 and bounds[-1][1] == max(K, 0) or K == 0
        for (lo, hi), (lo2, _) in zip(bounds, bounds[1:]):
            assert hi == lo2 and hi > lo
        assert all(hi > lo for lo, hi in bounds) or K == 0
        assert (p.route == "simt_ksplit") == (p.chunks > 1)


def test_plan_splits_the_tree_shapes():
    """The tree factor's narrow long-k f32 products split k in chunks of
    at least MIN_CHUNK; the sweeps' (m x 256) (256 x 16) stream A once."""
    p = qgemm.plan(256, 256, 8192, torch.float32, "k", "k")
    assert (p.route, p.kc, p.chunks) == ("simt_ksplit", 256, 32)
    for m in (256, 8192, 16128):
        p = qgemm.plan(m, 16, 256, torch.float32, "mn", "mn")
        assert (p.route, p.tile, p.chunks) == ("simt_narrow", (64, 16), 1)
    assert qgemm.plan(4096, 4096, 8192, torch.float32, "k", "k").chunks == 1
    # one pass: 128 x 128 tiles where they fill a wave, else 64 x 64
    p = qgemm.plan(4096, 256, 256, torch.float32, "k", "k")
    assert (p.route, p.tile) == ("simt_tile", qgemm.SIMT_MID)
    p = qgemm.plan(8192, 2048, 2048, torch.float32, "k", "k")
    assert (p.route, p.tile) == ("simt_tile", (128, 128))


@pytest.mark.parametrize("M,K,acc", [(256, 8192, "f32"), (512, 8192, "f32"),
                                    (1024, 8192, "f32"),
                                    (300, 100003, "f64")])
def test_ksplit_scratch_is_capped_in_column_blocks(M, K, acc):
    """A wide output's k-split goes in blocks of columns whose partial sums
    fit KSPLIT_SCRATCH_BYTES; the split itself does not follow N."""
    t = _DT[acc]
    esz = torch.empty((), dtype=t).element_size()
    narrow = qgemm.plan(M, 16, K, t, "k", "k")
    assert narrow.chunks > 1 and narrow.cols == 16
    for N in (256, 2049, 16384, 100000):
        p = qgemm.plan(M, N, K, t, "k", "k")
        assert (p.route, p.kc, p.chunks) == (narrow.route, narrow.kc,
                                             narrow.chunks)
        assert p.chunks * M * p.cols * esz <= qgemm.KSPLIT_SCRATCH_BYTES
        assert p.cols == N or p.cols % qgemm.SIMT_WIDE[t][1] == 0
    # a wide output: 32 chunks of (256 x 16384) would be 512 MiB
    assert qgemm.plan(256, 16384, 8192, torch.float32, "k", "k").cols == 2048


@pytest.mark.parametrize("block", [64, 128])
def test_syrk_leaf_chunks_are_the_shared_k_split(block):
    """syrk_leaf's chunks come from qgemm.k_split over the triangle's
    blocks: they cover k in order, each a multiple of 16, at most
    ceil(k / min_chunk) of them."""
    target, min_chunk = syrk._SPLIT[block]
    for n in (128, 256, 300):
        nt = -(-n // block)
        for k in (1, 256, 257, 8192):
            kc, chunks = syrk.leaf_chunk(n, k, block)
            assert (kc, chunks) == qgemm.k_split(k, nt * (nt + 1) // 2,
                                                 target, min_chunk)
            assert kc % 16 == 0 and (chunks - 1) * kc < k <= chunks * kc
            assert chunks <= max(1, -(-k // min_chunk))


def test_tc_stage_is_whole_wgmma_steps():
    for dt in qgemm.TC_DTYPES:
        esz = torch.empty((), dtype=dt).element_size()
        kt = qgemm.TC_STAGE_K_BYTES // esz
        assert kt % qgemm.TC_WGMMA_K[dt] == 0
        assert kt // qgemm.TC_WGMMA_K[dt] == 4      # four wgmmas a stage
        assert qgemm.TC_WGMMA_K[dt] * esz == 32     # 32 bytes of k each
    assert qgemm.TC_TILE == (128, 256)


@pytest.mark.parametrize("dt", ["f16", "bf16", "int8"])
def test_tc_staging_rules(dt):
    t = _DT[dt]
    for am in ("k", "mn", None):
        for bm in ("k", "mn", None):
            p = qgemm.plan(300, 7, 200, t, am, bm)
            assert _FAMILY[p.route] == "tc" and p.chunks == 1
            # s8 wgmma reads K-major operands only
            ok = ("k",) if t == torch.int8 else ("k", "mn")
            assert p.stage_a == (am not in ok)
            assert p.stage_b == (bm not in ok)
            assert (p.route == "tc_staged") == (p.stage_a or p.stage_b)


def test_layout_alignment_rules():
    lay = qgemm.layout
    assert lay(256, 8192, 16384, 1, 2) == ("k", 16384)
    assert lay(256, 8192, 1, 16384, 2) == ("mn", 16384)
    assert lay(256, 16, 1, 7, 2) == (None, 0)          # 14-byte rows
    assert lay(256, 16, 16, 1, 2, offset_bytes=8) == (None, 0)
    assert lay(256, 16, 3, 5, 4) == (None, 0)          # no unit stride
    assert lay(1, 512, 1, 1, 2) == ("k", 512)          # one row: either
    assert lay(7, 1, 1, 7, 2) == ("mn", 8)             # one k: MN-major
    assert lay(7, 333, 1, 7, 4)[0] is None
    assert lay(128, 64, 64, 1, 1) == ("k", 64)


def test_k_major_copy_keeps_values_and_aligns_rows():
    x = torch.arange(7 * 333, dtype=torch.float32).reshape(333, 7).T
    y = qgemm._k_major_copy(x.to(torch.float16))
    assert torch.equal(y.float(), x.to(torch.float16).float())
    assert y.stride(1) == 1 and (y.stride(0) * 2) % 16 == 0


# ---------------------------------------------------------------------------
# the k-split's arithmetic, emulated in plain torch (CPU)
# ---------------------------------------------------------------------------
def _ksplit_emulation(a, b, scale, c, beta, plan):
    """Partial sums of each chunk in f32, added in chunk order, then the
    epilogue rounded as the kernel rounds it."""
    K = a.shape[1]
    parts = [a[:, lo:hi] @ b[lo:hi] for lo, hi in
             _chunk_bounds(K, plan)]
    s = parts[0]
    for p in parts[1:]:
        s = s + p
    return s * scale + beta * c


@pytest.mark.parametrize("M,N,K", [(256, 48, 8192), (64, 40, 3000)])
def test_ksplit_emulation_matches_both_plain_versions(jx, M, N, K):
    rng = np.random.default_rng(M + K)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((N, K)).astype(np.float32)
    c = rng.standard_normal((M, N)).astype(np.float32)
    p = qgemm.plan(M, N, K, torch.float32, "k", "k")
    assert p.chunks > 1
    ta, tb, tc = (torch.from_numpy(x) for x in (a, b, c))
    got = _ksplit_emulation(ta, tb.T, -0.75, tc, 0.5, p)
    port = tref.qgemm_ref(ta, tb, trans_b=True, scale=-0.75, c=tc, beta=0.5)
    want = np.asarray(jx.ref.qgemm_ref(jx.jnp.asarray(a), jx.jnp.asarray(b),
                                       trans_b=True, scale=-0.75,
                                       c=jx.jnp.asarray(c), beta=0.5))
    # two f32 sums of K products in other orders: each within K u sum|ab|
    # of the exact one, plus the epilogue's roundings
    bound = 0.75 * (np.abs(a) @ np.abs(b).T).max() + 0.5 * np.abs(c).max()
    atol = 2 * (K + 2) * 2.0 ** -24 * bound
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    np.testing.assert_allclose(got.numpy(), port.numpy(), rtol=0, atol=atol)


def test_cpu_qgemm_counts_no_route():
    ops.reset_launches()
    ops.qgemm(torch.eye(64), torch.eye(64))
    assert set(ops.QGEMM_ROUTES.values()) == {0}
    assert set(ops.QGEMM_ROUTES) == set(qgemm.ROUTES)


# ---------------------------------------------------------------------------
# the kernel's routes against the plain version (card only)
# ---------------------------------------------------------------------------
def _operand(gen, shape, dt, major, device):
    """A (rows, k) operand stored K-major or MN-major."""
    if dt == torch.int8:
        mk = lambda s: torch.randint(-127, 128, s, generator=gen,  # noqa
                                     dtype=torch.int8).to(device)
    else:
        mk = lambda s: torch.randn(s, generator=gen).to(device, dt)  # noqa
    return mk(shape) if major == "k" else mk(shape[::-1]).T


_CARD_CASES = [  # (M, N, K, dtype, a major, b major, route)
    (300, 180, 200, "f16", "k", "k", "tc"),
    (320, 176, 200, "bf16", "mn", "mn", "tc"),
    (300, 180, 200, "bf16", "mn", "mn", "tc_staged"),   # 600-byte rows
    (129, 7, 70, "f16", "k", "mn", "tc_staged"),
    (200, 90, 704, "int8", "k", "k", "tc"),
    (200, 90, 700, "int8", "mn", "k", "tc_staged"),
    (256, 256, 2048, "f32", "k", "k", "simt_ksplit"),
    (300, 180, 200, "f32", "mn", "k", "simt_tile"),
    (1000, 16, 256, "f32", "mn", "mn", "simt_narrow"),
    (300, 180, 200, "f64", "k", "k", "simt_tile"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,K,dt,am,bm,route", _CARD_CASES)
def test_qgemm_routes_on_card(card, M, N, K, dt, am, bm, route):
    """Each route against qgemm_ref (int8 bitwise, the rest at the
    data-scaled gamma tolerance: a wgmma's f32 accumulation need not round
    to nearest), a repeat bitwise, columns bitwise independent of N and of
    their position, and the launch counted on its route."""
    gen = torch.Generator().manual_seed(M + N + K)
    t = _DT[dt]
    a = _operand(gen, (M, K), t, am, card)
    bn = _operand(gen, (N, K), t, bm, card)       # B as its (N, K) view
    od = qgemm.acc_dtype(t)
    c = torch.randn((M, N), generator=gen).to(card, od)
    ops.reset_launches()
    got = ops.qgemm(a, bn.T, 0.75, c=c, beta=-0.5, out_dtype=od)
    assert ops.QGEMM_ROUTES[route] == 1
    want = tref.qgemm_ref(a, bn.T, scale=0.75, c=c, beta=-0.5, out_dtype=od)
    if t == torch.int8:
        assert torch.equal(got, want)
    else:
        u = 2.0 ** -53 if od == torch.float64 else 2.0 ** -24
        bound = (0.75 * float((a.double().abs() @ bn.double().abs().T).max())
                 + 0.5 * float(c.abs().max()))
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=2 * (K + 2) * u * bound)
    assert torch.equal(ops.qgemm(a, bn.T, 0.75, c=c, beta=-0.5,
                                 out_dtype=od), got)
    perm = torch.randperm(N, generator=gen)
    for n in (1, 7, 16, 48):
        cols = perm[:min(n, N)].to(card)
        sub = ops.qgemm(a, bn.T[:, cols].contiguous(), 0.75,
                        c=c[:, cols].contiguous(), beta=-0.5, out_dtype=od)
        assert torch.equal(sub, got[:, cols]), n


@pytest.mark.gpu
def test_ksplit_column_blocks_move_no_bit(card, monkeypatch):
    """A k-split done in blocks of columns (a small scratch cap) gives the
    bits of the one-block call."""
    gen = torch.Generator().manual_seed(5)
    a = _operand(gen, (256, 2048), torch.float32, "k", card)
    bn = _operand(gen, (600, 2048), torch.float32, "k", card)
    c = torch.randn((256, 600), generator=gen).to(card)
    qgemm.plan.cache_clear()
    one = qgemm.launch(a, bn, 0.75, c=c, beta=-0.5, trans_b=True)
    assert one[1].route == "simt_ksplit" and one[1].cols == 600
    monkeypatch.setattr(qgemm, "KSPLIT_SCRATCH_BYTES",
                        one[1].chunks * 256 * 4 * 128)
    qgemm.plan.cache_clear()
    try:
        got, p = qgemm.launch(a, bn, 0.75, c=c, beta=-0.5, trans_b=True)
    finally:
        qgemm.plan.cache_clear()
    assert p.cols == 128 and (p.kc, p.chunks) == (one[1].kc, one[1].chunks)
    assert torch.equal(got, one[0])


@pytest.mark.gpu
def test_qgemm_in_place_and_device_scale(card):
    gen = torch.Generator().manual_seed(3)
    for dt in ("f16", "int8", "f32"):
        t = _DT[dt]
        a = _operand(gen, (256, 512), t, "k", card)
        b = _operand(gen, (192, 512), t, "k", card)
        c = torch.randn((256, 192), generator=gen).to(card)
        s = torch.tensor(-0.3, device=card)
        want = qgemm.qgemm(a, b, float(s), c=c, beta=1.0, trans_b=True)
        inplace = c.clone()
        qgemm.qgemm(a, b, s, c=inplace, beta=1.0, trans_b=True, out=inplace)
        assert torch.equal(inplace, want), dt
