"""Wrapper of the fused residual CUDA kernel (``csrc/residual.cu``).

Replaces ``repro/kernels/residual.py:residual_fused``: ``r = b - a @ x``
with f32 accumulation for f32 operands and f64 for f64 operands, returned
in ``b``'s dtype, as :func:`repro_torch.kernels.ref.residual_ref` computes
it. ``x`` and ``b`` are (n,) or (n, k) and are read through their strides
(a slot block's column view needs no copy); ``a`` needs unit column
stride. Each result column is summed in an order fixed by n alone, so a
column's residual does not depend on k or on the columns beside it
(``csrc/residual.cu`` says how).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_FNS: dict = {}
_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGS = (_P, _L, _P, _L, _L, _P, _L, _L, _P, _L, _L, _I, _I, _I, _P)


def _fn(dtype):
    if dtype not in _FNS:
        _FNS[dtype] = _build.function("residual", f"residual_{_SUFFIX[dtype]}",
                                      _ARGS)
    return _FNS[dtype]


def residual_fused(a, x, b, *, out=None):
    """``b - a @ x`` on the card; ``out`` (same shape and dtype as ``b``)
    may be ``b`` itself, never ``a`` or ``x``."""
    if a.device.type != "cuda" or {x.device, b.device} != {a.device}:
        raise ValueError(f"residual_fused: needs CUDA operands on one device, "
                         f"got {a.device}, {x.device}, {b.device}")
    if a.dtype not in _SUFFIX or {x.dtype, b.dtype} != {a.dtype}:
        raise TypeError(f"residual_fused: f32 or f64 operands of one dtype, "
                        f"got {a.dtype}, {x.dtype}, {b.dtype}")
    n = a.shape[0]
    if (a.dim() != 2 or a.shape != (n, n) or x.shape != b.shape
            or x.dim() not in (1, 2) or x.shape[0] != n):
        raise ValueError(f"residual_fused: shapes {tuple(a.shape)}, "
                         f"{tuple(x.shape)}, {tuple(b.shape)}")
    if a.stride(1) != 1 and n > 1:
        raise ValueError("residual_fused: a needs unit column stride")
    if out is None:
        out = torch.empty(b.shape, dtype=b.dtype, device=b.device)
    elif out.shape != b.shape or out.dtype != b.dtype or out.device != b.device:
        raise ValueError(f"residual_fused: bad out {tuple(out.shape)} "
                         f"{out.dtype}")
    for t in (a, x):
        if out.data_ptr() == t.data_ptr():
            raise ValueError("residual_fused: out must not alias a or x")
    x2, b2, o2 = ((t[:, None] if t.dim() == 1 else t) for t in (x, b, out))
    k = x2.shape[1]
    if n == 0 or k == 0:
        return out
    vec = 16 // a.element_size()
    aligned = int(a.data_ptr() % 16 == 0 and a.stride(0) % vec == 0)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _fn(a.dtype)(
            a.data_ptr(), a.stride(0), x2.data_ptr(), x2.stride(0),
            x2.stride(1), b2.data_ptr(), b2.stride(0), b2.stride(1),
            o2.data_ptr(), o2.stride(0), o2.stride(1), n, k, aligned, stream)
    _build.check(err, "residual_fused")
    return out
