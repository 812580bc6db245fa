"""The port's flash attention: its plain version against the JAX
reference's Pallas kernel (interpret mode, on the CPU) and the models'
scan oracle, and the CUDA kernel against the plain version (on a card).

Tolerances: f32 at the reference suite's rtol = atol = 2e-4
(tests/test_flash.py), which covers two f32 sums of hd products in other
orders and an online softmax over other block boundaries; bf16 adds one
rounding of the output to bf16, a relative 2^-7 (the reference suite's
2e-2 where the two sides are a bf16 and an f32 computation).

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
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("hd", flash.HEAD_DIMS)
def test_flash_kernel_head_dims(card, hd, dt):
    """Every head dim of the dense configs, GQA (G = 3), ragged S = 300."""
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
    q, k, v = _t(*_qkv(hd, 6, 2, 300, hd), dtype=dtype, device=card)
    got = flash.flash_attention_bshd(q, k, v)
    want = tref.flash_ref(q, k, v)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(),
                               **(F32_TOL if dt == "f32" else BF16_TOL))


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
