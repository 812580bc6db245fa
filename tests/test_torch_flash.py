"""The port's flash attention: its plain version against the JAX
reference's Pallas kernel (interpret mode, on the CPU) and the models'
scan oracle, the tensor-core kernel's arithmetic (an emulation in plain
torch) against both, and the CUDA kernels against the plain version (on a
card): ``csrc/flash_tc.cuh`` for bf16 and f16, ``csrc/flash.cu`` for f32.

Tolerances: f32 at the reference suite's rtol = atol = 2e-4
(tests/test_flash.py), which covers two f32 sums of hd products in other
orders and an online softmax over other block boundaries; bf16 adds one
rounding of the output to bf16, a relative 2^-7 (the reference suite's
2e-2 where the two sides are a bf16 and an f32 computation), f16 one
rounding to f16, a relative 2^-10.

The JAX reference is imported through the ``jx`` fixture only, so the
card-only cases (marker ``gpu``) also run where torch is installed and
jax is not: ``python -m pytest -m gpu tests/test_torch_flash.py``.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash, ops
from repro_torch.kernels import ref as tref

torch.set_num_threads(2)

F32_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=2.0 ** -7, atol=2e-4)
F16_TOL = dict(rtol=2.0 ** -10, atol=2e-4)
#: the data-scaled atol of the split p (chip_smoke.py's): 256 u max|v|
DATA_ULPS, U32 = 256, 2.0 ** -24
# tests/test_flash.py:29-30
SHAPES = [(4, 4, 256, 64), (8, 2, 256, 128), (4, 1, 300, 64),
          (2, 2, 512, 32)]


@pytest.fixture(scope="module")
def jx():
    """jax.numpy and the reference's flash kernel and scan oracle."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import flash as rflash
    from repro.models import attention as rattn
    return types.SimpleNamespace(jnp=jnp, flash=rflash, attn=rattn)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _qkv(seed, H, KV, S, hd, T=None):
    rng = np.random.default_rng(seed)
    T = S if T is None else T
    return (rng.standard_normal((H, S, hd)).astype(np.float32),
            rng.standard_normal((KV, T, hd)).astype(np.float32),
            rng.standard_normal((KV, T, hd)).astype(np.float32))


def _naive(q, k, v, causal=True):
    """Softmax attention in f64, q [H, S, hd], k/v [KV, T, hd], the causal
    mask top-left aligned."""
    H, S, hd = q.shape
    KV, T, _ = k.shape
    kr = np.repeat(k, H // KV, 0).astype(np.float64)
    vr = np.repeat(v, H // KV, 0).astype(np.float64)
    s = np.einsum("hsd,htd->hst", q.astype(np.float64), kr) * hd ** -0.5
    if causal:
        s = np.where(np.arange(S)[:, None] >= np.arange(T)[None, :], s,
                     -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("hst,htd->hsd", p / p.sum(-1, keepdims=True), vr)


def _t(*xs, dtype=torch.float32, device="cpu"):
    """[H, S, hd] arrays -> [1, S, H, hd] tensors, the batched layout of
    the plain version and the kernel."""
    return [torch.from_numpy(x).to(device, dtype).transpose(0, 1)[None]
            for x in xs]


def _hsd(out):
    """[1, S, H, hd] -> an [H, S, hd] f32 array."""
    return out[0].transpose(0, 1).float().cpu().numpy()


# ---------------------------------------------------------------------------
# plain version vs the reference (CPU)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("H,KV,S,hd", SHAPES)
def test_flash_ref_matches_pallas(jx, H, KV, S, hd):
    q, k, v = _qkv(S + hd, H, KV, S, hd)
    want = jx.flash.flash_attention(jx.jnp.asarray(q), jx.jnp.asarray(k),
                                    jx.jnp.asarray(v), bq=128, bk=128,
                                    interpret=True)
    got = tref.flash_ref(*_t(q, k, v), bq=128, bk=128)
    np.testing.assert_allclose(_hsd(got), np.asarray(want), **F32_TOL)


def test_flash_ref_matches_pallas_bf16(jx):
    q, k, v = _qkv(3, 4, 2, 256, 64)
    jb = [jx.jnp.asarray(x, jx.jnp.bfloat16) for x in (q, k, v)]
    want = jx.flash.flash_attention(*jb, bq=128, bk=128, interpret=True)
    got = tref.flash_ref(*_t(q, k, v, dtype=torch.bfloat16), bq=128, bk=128)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_hsd(got),
                               np.asarray(want, np.float32), **BF16_TOL)


def test_flash_bshd_matches_model_oracle(jx):
    """ops.flash_attention_bshd (the plain version on the CPU) against the
    scan the reference's models run, models/attention.py:_chunked_causal."""
    B, S, KV, G, hd = 2, 256, 2, 2, 64
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, S, KV, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    want = jx.attn._chunked_causal(jx.jnp.asarray(q), jx.jnp.asarray(k),
                                   jx.jnp.asarray(v), q_pos0=0, chunk=128)
    got = ops.flash_attention_bshd(
        *[torch.from_numpy(x) for x in (q.reshape(B, S, KV * G, hd), k, v)],
        bq=128, bk=128)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want).reshape(B, S, KV * G, hd), **F32_TOL)


@pytest.mark.parametrize("S,T", [(128, 256), (300, 300), (256, 100)])
def test_flash_ref_s_ne_t_top_left(S, T):
    """S != T: the causal mask is q_index >= k_index from 0 for both."""
    q, k, v = _qkv(S + T, 4, 2, S, 32, T)
    got = tref.flash_ref(*_t(q, k, v), bq=64, bk=64)
    np.testing.assert_allclose(_hsd(got), _naive(q, k, v), **F32_TOL)


def test_reference_fault_padded_keys(jx):
    """ROADMAP.md section C: with S > T and T no multiple of bk, the Pallas
    kernel lets the rows past T attend to its zero-padded keys (score 0);
    the port masks them. The rows below T agree."""
    S, T = 300, 200
    q, k, v = _qkv(9, 2, 1, S, 32, T)
    want = np.asarray(jx.flash.flash_attention(
        jx.jnp.asarray(q), jx.jnp.asarray(k), jx.jnp.asarray(v), bq=128,
        bk=128, interpret=True))
    got = _hsd(tref.flash_ref(*_t(q, k, v), bq=128, bk=128))
    naive = _naive(q, k, v)
    np.testing.assert_allclose(got, naive, **F32_TOL)
    np.testing.assert_allclose(got[:, :T], want[:, :T], **F32_TOL)
    assert np.abs(want[:, T:] - naive[:, T:]).max() > 1e-2


def test_flash_ref_non_causal():
    q, k, v = _qkv(4, 4, 4, 128, 16, 256)
    got = tref.flash_ref(*_t(q, k, v), causal=False, bq=64, bk=128)
    np.testing.assert_allclose(_hsd(got), _naive(q, k, v, causal=False),
                               **F32_TOL)
    with pytest.raises(ValueError, match="T % bk"):
        tref.flash_ref(*_t(q, k, v), causal=False, bk=96)


def test_ops_flash_on_cpu_adds_no_launches():
    """ops.flash_attention, the [H, S, hd] form, is the batched form with
    B = 1; on the CPU neither adds a launch."""
    qkv = _qkv(1, 2, 1, 64, 16)
    q, k, v = [torch.from_numpy(x) for x in qkv]
    ops.reset_launches()
    got = ops.flash_attention(q, k, v)
    np.testing.assert_allclose(got.numpy(), _naive(*qkv), **F32_TOL)
    ops.flash_attention_bshd(*_t(*qkv))
    assert ops.LAUNCHES["flash_attention"] == 0
    with pytest.raises(ValueError):
        ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


def test_flash_wrapper_refuses_cpu_tensors():
    q, k, v = _t(*_qkv(1, 2, 1, 64, 16))
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_attention_bshd(q, k, v)


# ---------------------------------------------------------------------------
# CUDA kernel vs plain version (card only)
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("hd", flash.HEAD_DIMS)
def test_flash_kernel_head_dims(card, hd, dt):
    """Every head dim of the dense configs, GQA (G = 3), ragged S = 300,
    on both routes (f32: the SIMT kernel; bf16, f16: flash_tc)."""
    dtype, tol = {"f32": (torch.float32, F32_TOL),
                  "bf16": (torch.bfloat16, BF16_TOL),
                  "f16": (torch.float16, F16_TOL)}[dt]
    q, k, v = _t(*_qkv(hd, 6, 2, 300, hd), dtype=dtype, device=card)
    got = flash.flash_attention_bshd(q, k, v)
    want = tref.flash_ref(q, k, v)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("S,T,causal", [(128, 256, True), (256, 100, True),
                                        (200, 256, False)])
def test_flash_kernel_s_ne_t(card, S, T, causal):
    q, k, v = _qkv(S + T, 4, 2, S, 64, T)
    got = flash.flash_attention_bshd(*_t(q, k, v, device=card),
                                     causal=causal)
    np.testing.assert_allclose(_hsd(got), _naive(q, k, v, causal),
                               **F32_TOL)


@pytest.mark.gpu
def test_flash_kernel_bshd_strides(card):
    """[B, S, H, hd] read through its strides (a slice of a wider tensor)
    equals the plain version on the same views."""
    rng = np.random.default_rng(7)
    wide = torch.from_numpy(
        rng.standard_normal((2, 200, 8, 160)).astype(np.float32)).to(card)
    q = wide[:, :, :, :128]
    k = wide[:, :, :2, 16:144]
    v = wide[:, :, 2:4, 32:160]
    got = flash.flash_attention_bshd(q, k, v)
    want = tref.flash_ref(q, k, v)
    torch.testing.assert_close(got, want, **F32_TOL)
    ops.reset_launches()
    ops.flash_attention_bshd(q, k, v)
    assert ops.LAUNCHES["flash_attention"] == 1


# ---------------------------------------------------------------------------
# the tensor-core kernel's arithmetic (CPU)
# ---------------------------------------------------------------------------
def _tc_emulation(q, k, v, *, causal=True, one_pass=False):
    """flash_tc's arithmetic in plain torch: q [B, S, H, hd], k/v
    [B, T, KV, hd] in bf16 or f16, on any device -> the f32 output before
    its rounding.

    s = q k^T in f32 (the products of 16-bit values are exact), scaled by
    hd^-0.5 after the product; kv blocks of the kernel's width (128 for
    hd <= 128, else 64) with m, l and acc in f32; p split into 16-bit
    p_hi + p_lo (of p 2^15 for f16, scaled back at the end), each
    multiplied by v and summed in f32; l sums the f32 p. ``one_pass``
    drops p_lo: p rounded once to 16 bits."""
    dt, f32 = q.dtype, torch.float32
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    bkv = 128 if hd <= 128 else 64
    ps = 1.0 if dt == torch.bfloat16 else 2.0 ** 15
    qf = q.permute(0, 2, 1, 3).to(f32)
    kf, vf = (x.permute(0, 2, 1, 3).to(f32).repeat_interleave(H // KV, 1)
              for x in (k, v))
    dev = q.device
    scale = torch.tensor(hd ** -0.5, dtype=f32, device=dev)
    m = torch.full((B, H, S, 1), -1e30, dtype=f32, device=dev)
    l = torch.zeros((B, H, S, 1), dtype=f32, device=dev)
    acc = torch.zeros((B, H, S, hd), dtype=f32, device=dev)
    iq = torch.arange(S, device=dev)[:, None]
    for k0 in range(0, T, bkv):
        blk = slice(k0, min(k0 + bkv, T))
        s = (qf @ kf[:, :, blk].transpose(-1, -2)) * scale
        if causal:
            s = torch.where(iq >= torch.arange(k0, blk.stop,
                                               device=dev)[None, :], s, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        hi = (p * ps).to(dt).to(f32)
        lo = torch.zeros_like(hi) if one_pass else (p * ps - hi).to(dt).to(f32)
        acc = acc * corr + hi @ vf[:, :, blk] + lo @ vf[:, :, blk]
        m = m_new
    return (acc * (1.0 / ps) / l.clamp_min(1e-30)).permute(0, 2, 1, 3)


#: hd = 64 (a power-of-2 scale) and 128 (not one), ragged S = 300, G = 3
TC_SHAPES = [(6, 2, 300, 64), (6, 2, 300, 128)]

#: The gate that tells the split p from a one-pass one in a kernel's 16-bit
#: output (chip_smoke.py holds every 16-bit flash case to it, with this
#: emulation's one-pass p as the control): the share of output elements
#: whose rounded value differs from the plain version's. A one-pass p
#: moves an output by about 2^-10 of itself, a fair share of its ulp, and
#: changes the rounding of about 0.4 of the elements; the split moves it
#: by about 2^-18, and with the f32-level differences of the two sides it
#: changes 0.0014-0.0071 of them here and 0.0018-0.0105 for the kernel
#: on an H100 (chip_smoke.py's 16-bit cases, the most f16 at 4 x 2048).
MISMATCH_SHARE = 0.04


def mismatch_share(got, want):
    """The share of elements of got and want, tensors of one 16-bit
    dtype, that differ."""
    return float((got != want).float().mean())


def _tc_case(jx, H, KV, S, hd, dt):
    """16-bit operands (as numpy f32 values on dt's grid), the emulation's
    f32 output, the JAX reference's and flash_ref's on the same values in
    f32, and the data-scaled atol 256 u max|v|."""
    q, k, v = (torch.from_numpy(x).to(dt).float().numpy()
               for x in _qkv(S + hd, H, KV, S, hd))
    want = np.asarray(jx.flash.flash_attention(
        jx.jnp.asarray(q), jx.jnp.asarray(k), jx.jnp.asarray(v), bq=128,
        bk=128, interpret=True))
    plain = _hsd(tref.flash_ref(*_t(q, k, v), bq=128, bk=128))
    qkv16 = _t(q, k, v, dtype=dt)
    return qkv16, want, plain, DATA_ULPS * U32 * float(np.abs(v).max())


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("H,KV,S,hd", TC_SHAPES)
def test_flash_tc_split_arithmetic_matches_reference(jx, H, KV, S, hd, dt):
    """The split p keeps the kernel within 256 u max|v| of the JAX
    reference and of flash_ref: the scale after the product moves a score
    by a few f32 ulps, and p_hi + p_lo carries p to 2^-16 (bf16) or 2^-22
    (f16) of itself."""
    qkv16, want, plain, atol = _tc_case(jx, H, KV, S, hd, dt)
    got = _hsd(_tc_emulation(*qkv16))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    np.testing.assert_allclose(got, plain, rtol=0, atol=atol)


@pytest.mark.parametrize("H,KV,S,hd", TC_SHAPES)
def test_flash_tc_one_pass_p_misses_the_tolerance(jx, H, KV, S, hd):
    """Why p is split: rounded once to bf16 (2^-8 of itself), p moves the
    output by far more than 256 u max|v|."""
    qkv16, want, _, atol = _tc_case(jx, H, KV, S, hd, torch.bfloat16)
    err = np.abs(_hsd(_tc_emulation(*qkv16, one_pass=True)) - want).max()
    assert err > 8 * atol


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("H,KV,S,hd", TC_SHAPES)
def test_flash_tc_mismatch_share_tells_split_from_one_pass(jx, H, KV, S, hd,
                                                          dt):
    """chip_smoke.py's card gate on the rounded output: with the split p
    under MISMATCH_SHARE of the elements differ from the JAX reference's
    output rounded to dt, with p rounded once to dt over it."""
    qkv16, want, _, _ = _tc_case(jx, H, KV, S, hd, dt)
    want16 = torch.tensor(want).to(dt)

    def share(one_pass):
        got = _tc_emulation(*qkv16, one_pass=one_pass)[0].transpose(0, 1)
        return mismatch_share(got.to(dt), want16)

    assert share(False) <= MISMATCH_SHARE < share(True)


def test_flash_tc_tma_strides():
    """The TMA route's checks run on the tensors' metadata: an aligned
    view passes (a dimension of extent 1 gets an aligned stride), a base
    address or a head stride off 16 bytes raises naming it."""
    bf = torch.bfloat16
    wide = torch.zeros((2, 10, 5, 80), dtype=bf)
    assert flash._tma_strides("q", wide[:, 1:, 1:, 8:72]) == [4000, 400, 80]
    assert flash._tma_strides("q", wide[:1, :, :1, :64]) == [64, 400, 64]
    with pytest.raises(ValueError, match="base address"):
        flash._tma_strides("q", wide[:, :, :, 1:65])
    odd = torch.zeros((1, 8, 16, 65), dtype=bf)[:, :, :2, :64]
    with pytest.raises(ValueError, match="head stride of 65 elements"):
        flash._tma_strides("k", odd)


def test_flash_route_by_dtype():
    """bf16 and f16 go to the tensor-core kernel, f32 to the SIMT one; a
    dtype neither takes has no route."""
    assert flash.route(torch.bfloat16) == "flash_tc"
    assert flash.route(torch.float16) == "flash_tc"
    assert flash.route(torch.float32) == "flash_simt"
    with pytest.raises(TypeError, match="no route"):
        flash.route(torch.float64)


def test_flash_routes_count_only_card_launches():
    """FLASH_ROUTES splits the card's flash_attention launches by route;
    the plain version on the CPU adds to neither, and reset_launches
    clears both counts."""
    qkv = _t(*_qkv(2, 2, 1, 64, 16), dtype=torch.bfloat16)
    ops.FLASH_ROUTES["flash_tc"] = 3
    ops.reset_launches()
    ops.flash_attention_bshd(*qkv)
    assert ops.FLASH_ROUTES == {"flash_tc": 0, "flash_simt": 0}


# ---------------------------------------------------------------------------
# the tensor-core route on the card
# ---------------------------------------------------------------------------
_DT = {"bf16": (torch.bfloat16, BF16_TOL), "f16": (torch.float16, F16_TOL)}


@pytest.mark.gpu
@pytest.mark.parametrize("dt", sorted(_DT))
@pytest.mark.parametrize("S,T,causal", [(128, 256, True), (256, 100, True),
                                        (200, 256, False), (300, 77, True)])
def test_flash_tc_s_ne_t(card, dt, S, T, causal):
    """The top-left causal mask and the keys past T, and a full call."""
    dtype, tol = _DT[dt]
    q, k, v = _t(*_qkv(S + T, 4, 2, S, 64, T), dtype=dtype, device=card)
    got = flash.flash_attention_bshd(q, k, v, causal=causal)
    want = tref.flash_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", sorted(_DT))
def test_flash_tc_strided_view(card, dt):
    """Operands cut from wider tensors, every stride and base a multiple of
    16 bytes, go through TMA as they are: rows past S and T are zero-filled
    by the copy, not read from the next row or batch."""
    dtype, tol = _DT[dt]
    rng = np.random.default_rng(11)
    wide = torch.from_numpy(rng.standard_normal((2, 203, 9, 144))
                            .astype(np.float32)).to(card, dtype)
    q = wide[:, 2:-1, 1:, 8:136]
    k = wide[:, 2:-1, 1:3, :128]
    v = wide[:, 2:-1, 3:5, 16:144]
    got = flash.flash_attention_bshd(q, k, v)
    torch.testing.assert_close(got.float(), tref.flash_ref(q, k, v).float(),
                               **tol)


@pytest.mark.gpu
def test_flash_tc_refuses_misaligned(card):
    """A base address or a head stride off 16 bytes raises ValueError and
    launches nothing: no fallback to the SIMT kernel."""
    bf = torch.bfloat16
    ok = torch.zeros((1, 128, 2, 64), dtype=bf, device=card)
    off = torch.zeros((1, 128, 2, 65), dtype=bf, device=card)[..., 1:]
    odd = torch.zeros((1, 128, 16, 65), dtype=bf, device=card)[:, :, :2, :64]
    ops.reset_launches()
    with pytest.raises(ValueError, match="base address"):
        ops.flash_attention_bshd(off, ok, ok)
    with pytest.raises(ValueError, match="head stride"):
        ops.flash_attention_bshd(ok, odd, ok)
    assert ops.LAUNCHES["flash_attention"] == 0
    assert ops.FLASH_ROUTES == {"flash_tc": 0, "flash_simt": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("dt", sorted(_DT))
def test_flash_tc_matches_its_emulation(card, dt):
    """The kernel against the emulation of its own arithmetic, both
    rounded to the operands' type once: one unit of the last place."""
    dtype, tol = _DT[dt]
    q, k, v = _t(*_qkv(21, 6, 2, 300, 128), dtype=dtype)
    want = _tc_emulation(q, k, v).to(dtype)
    got = flash.flash_attention_bshd(q.to(card), k.to(card), v.to(card))
    torch.testing.assert_close(got.cpu().float(), want.float(), **tol)
