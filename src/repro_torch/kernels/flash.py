"""Wrapper of the flash-attention CUDA kernels.

Replaces ``repro/kernels/flash.py:flash_attention`` (q [H, S, hd], k/v
[KV, T, hd]) and its batched wrapper ``flash_attention_bshd`` (q
[B, S, H, hd], k/v [B, T, KV, hd]): causal (or full) GQA attention with
an online softmax, f32 scores and state, the output in q's dtype. Both
kernels read every operand through its strides (unit head-dim stride), so
the batched form is one launch over ``B * H`` with no transposed copy;
``ops.flash_attention`` gives the [H, S, hd] form as a view with B = 1.

The route is by dtype (:func:`route`), with no fallback between the
two:

- bf16 and f16 go to ``csrc/flash_tc.cuh`` (``flash_tc_bf16.cu``,
  ``flash_tc_f16.cu``): wgmma on the tensor cores, K/V loaded by TMA into
  an mbarrier ring, ``p`` split into two 16-bit terms for ``p v``. TMA
  reads q, k and v as tensors of rank 4 with their real strides, so each
  base address and each batch, sequence and head stride must be a
  multiple of 16 bytes; an operand that is not raises ``ValueError``.
- f32 goes to ``csrc/flash.cu``: IEEE f32 FMAs on the CUDA cores.

Each kernel walks blocks of its own, so the reference's kv block size
``bk`` only keeps the reference's restriction on a full (non-causal)
call, ``T % min(bk, T) == 0``; the plain version
(:func:`repro_torch.kernels.ref.flash_ref`) walks the blocks its
``bq`` / ``bk`` name.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.precision import DTYPES
from repro_torch.kernels import _build
from repro_torch.kernels.ref import FLASH_BK

_SUFFIX = {torch.float32: "f32", DTYPES["bf16"]: "bf16",
           DTYPES["f16"]: "f16"}
#: the head dims the kernel is built for: every dense config's, and
#: zamba2's 80 (its shared attention block: d 2560 over 32 heads)
HEAD_DIMS = (16, 32, 64, 80, 128, 192, 256)
_FNS: dict = {}
_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGS = (_P, _L, _L, _L) * 4 + (_I,) * 6 + (ctypes.c_float, _I, _P)


def route(dtype) -> str:
    """The kernel that takes operands of dtype: ``"flash_simt"`` for f32,
    ``"flash_tc"`` for bf16 and f16."""
    if dtype not in _SUFFIX:
        raise TypeError(f"flash_attention: no route for {dtype}")
    return "flash_simt" if dtype == torch.float32 else "flash_tc"


def _fn(dtype):
    """The entry point of dtype's route."""
    if dtype not in _FNS:
        if route(dtype) == "flash_simt":
            lib, name = "flash", "flash_attention_f32"
        else:
            lib = name = f"flash_tc_{_SUFFIX[dtype]}"
        _FNS[dtype] = _build.function(lib, name, _ARGS)
    return _FNS[dtype]


def _tma_strides(what, t):
    """(batch, seq, head) strides of a bf16/f16 operand for its TMA map,
    in elements: each, and the base address, a multiple of 16 bytes. A
    dimension of extent 1 is never stepped, so its stride is replaced by
    one that is aligned."""
    esz = t.element_size()
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: base address {t.data_ptr():#x} is no "
                         "multiple of 16 bytes, which TMA needs")
    strides = []
    for dim, name in ((0, "batch"), (1, "sequence"), (2, "head")):
        st = t.stride(dim) if t.shape[dim] > 1 else t.shape[3]
        if (st * esz) % 16 or st <= 0:
            raise ValueError(f"{what}: {name} stride of {st} elements "
                             f"({st * esz} bytes) is no positive multiple "
                             "of 16 bytes, which TMA needs")
        strides.append(st)
    return strides


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
    tc = route(q.dtype) == "flash_tc"
    if not tc and B * H > 65535:
        raise ValueError(f"{what}: B * H = {B * H} exceeds the grid")
    if B == 0 or S == 0:
        return out
    if T == 0:
        raise ValueError(f"{what}: no keys")
    args = []
    for name, t in zip("qkvo", ts):
        if tc and name != "o":
            args += [t.data_ptr(), *_tma_strides(f"{what} {name}", t)]
        else:
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

