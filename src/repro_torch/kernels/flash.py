"""Wrapper of the flash-attention CUDA kernel (``csrc/flash.cu``).

Replaces ``repro/kernels/flash.py:flash_attention`` (q [H, S, hd], k/v
[KV, T, hd]) and its batched wrapper ``flash_attention_bshd`` (q
[B, S, H, hd], k/v [B, T, KV, hd]): causal (or full) GQA attention with
an online softmax, f32 scores and state, the output in q's dtype. The
kernel reads every operand through its strides (unit head-dim stride), so
the batched form is one launch over ``B * H`` with no transposed copy;
``ops.flash_attention`` gives the [H, S, hd] form as a view with B = 1.

The kernel walks 64 x 64 blocks of its own, so the reference's kv block
size ``bk`` only keeps the reference's restriction on a full (non-causal)
call, ``T % min(bk, T) == 0``; the plain version
(:func:`repro_torch.kernels.ref.flash_ref`) walks the blocks its
``bq`` / ``bk`` name.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import FLASH_BK

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16",
           torch.float16: "f16"}
#: the head dims the kernel is built for: every dense config's
HEAD_DIMS = (16, 32, 64, 128, 192, 256)
_FNS: dict = {}
_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGS = (_P, _L, _L, _L) * 4 + (_I,) * 6 + (ctypes.c_float, _I, _P)


def _fn(dtype):
    if dtype not in _FNS:
        _FNS[dtype] = _build.function(
            "flash", f"flash_attention_{_SUFFIX[dtype]}", _ARGS)
    return _FNS[dtype]


def _launch(q, k, v, out, causal, bk):
    """q/out [B, S, H, hd], k/v [B, T, KV, hd], any strides with a unit
    last one."""
    what = "flash_attention"
    ts = (q, k, v, out)
    if q.device.type != "cuda" or any(t.device != q.device for t in ts):
        raise ValueError(f"{what}: needs CUDA operands on one device, got "
                         f"{[str(t.device) for t in ts]}")
    if q.dtype not in _SUFFIX or any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"{what}: f32, bf16 or f16 operands of one dtype, "
                        f"got {[t.dtype for t in ts]}")
    B, S, H, hd = q.shape
    _, T, KV, _ = k.shape
    if (k.shape != (B, T, KV, hd) or v.shape != k.shape
            or out.shape != q.shape or KV == 0 or H % KV):
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {hd} not in {HEAD_DIMS}")
    if any(t.stride(3) != 1 for t in ts):
        raise ValueError(f"{what}: operands need a unit head-dim stride")
    if not causal and T % min(bk, T):
        raise ValueError(f"{what}: the non-causal path requires T % bk == 0")
    if B * H > 65535:
        raise ValueError(f"{what}: B * H = {B * H} exceeds the grid")
    if B == 0 or S == 0:
        return out
    if T == 0:
        raise ValueError(f"{what}: no keys")
    args = []
    for t in ts:
        args += [t.data_ptr(), t.stride(0), t.stride(1), t.stride(2)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn(q.dtype)(*args, B, H, KV, S, T, hd, hd ** -0.5,
                           int(bool(causal)), stream)
    _build.check(err, what)
    return out


def flash_attention_bshd(q, k, v, *, causal=True, bk=FLASH_BK):
    """q [B, S, H, hd], k/v [B, T, KV, hd] on one CUDA device ->
    [B, S, H, hd] in q's dtype."""
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    return _launch(q, k, v, out, causal, bk)

