"""Wrapper of the mixed-precision GEMM CUDA kernel (``csrc/qgemm.cu``).

Replaces ``repro/kernels/qgemm.py:qgemm``:
``out = scale * (a @ b[.T]) + beta * c`` with f32 accumulation for f32,
f16 and bf16 operands, f64 for f64 operands or f32 operands with an f64
``c``, and exact s32 for int8 operands, as
:func:`repro_torch.kernels.ref.qgemm_ref` computes it. The
operands are read through their strides, so a transposed or sliced view
(``l[r0:r1, :r0].T`` in the back substitution) is passed without a copy;
``c`` and ``out`` need unit column stride, and ``out`` may be ``c``
itself for an in-place update.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.float16: "f16",
           torch.bfloat16: "bf16", torch.int8: "s8"}
_FNS: dict = {}
_P, _L, _I, _D = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                  ctypes.c_double)
_ARGS = (_P, _L, _L, _P, _L, _L, _P, _L, _P, _L, _I, _I, _I, _D, _D, _P, _I,
         _P)


def _fn(dtype, od):
    key = (dtype, od)
    if key not in _FNS:
        sfx = _SUFFIX[dtype]
        if od != acc_dtype(dtype):
            sfx += "_f64"
        _FNS[key] = _build.function("qgemm", f"qgemm_{sfx}", _ARGS)
    return _FNS[key]


def acc_dtype(dtype, c_dtype=None):
    """The output/epilogue dtype the kernel computes for operand ``dtype``
    (and accumulator ``c_dtype``): f64 if either is f64, else f32."""
    return (torch.float64 if torch.float64 in (dtype, c_dtype)
            else torch.float32)


def qgemm(a, b, scale=1.0, *, c=None, beta=0.0, trans_b=False,
          out_dtype=torch.float32, out=None):
    """``scale`` is a float, or a 0-d f32 tensor on the operands' device
    that the kernel reads from device memory (no host sync)."""
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"qgemm: needs CUDA operands on one device, got "
                         f"{a.device}, {b.device}")
    if a.dtype != b.dtype or a.dtype not in _SUFFIX:
        raise TypeError(f"qgemm: operands {a.dtype}, {b.dtype}")
    od = acc_dtype(a.dtype, None if c is None else c.dtype)
    if od != acc_dtype(a.dtype) and a.dtype != torch.float32:
        raise TypeError(f"qgemm: {a.dtype} operands take no {od} c")
    if out_dtype != od:
        raise TypeError(f"qgemm: {a.dtype} operands give {od}, not "
                        f"{out_dtype}")
    bt = b.T if trans_b else b
    if a.dim() != 2 or bt.dim() != 2 or a.shape[1] != bt.shape[0]:
        raise ValueError(f"qgemm: shapes {tuple(a.shape)} @ "
                         f"{tuple(bt.shape)}")
    M, K = a.shape
    N = bt.shape[1]
    for name, t in (("c", c), ("out", out)):
        if t is not None and (t.shape != (M, N) or t.dtype != od
                              or t.stride(1) != 1 or t.device != a.device):
            raise ValueError(f"qgemm: {name} must be ({M}, {N}) {od} with "
                             f"unit column stride")
    if out is None:
        out = torch.empty((M, N), dtype=od, device=a.device)
    for t in (a, b):
        if out.data_ptr() == t.data_ptr():
            raise ValueError("qgemm: out must not alias an operand")
    has_c = c is not None
    scale_dev, scale = _build.scalar_arg(scale, a.device, "qgemm")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _fn(a.dtype, od)(
            a.data_ptr(), a.stride(0), a.stride(1),
            bt.data_ptr(), bt.stride(0), bt.stride(1),
            c.data_ptr() if has_c else None, c.stride(0) if has_c else 0,
            out.data_ptr(), out.stride(0), M, N, K,
            scale, float(beta), scale_dev, int(has_c), stream)
    _build.check(err, "qgemm")
    return out
