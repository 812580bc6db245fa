"""Wrapper of the leaf triangular-solve CUDA kernel (``csrc/trsm.cu``).

Replaces ``repro/kernels/trsm.py:trsm_leaf``: ``X = B L^-T`` for a
leaf-sized lower-triangular ``L``, computed as ``B @ Linv.T`` from the
leaf's inverse ``Linv`` (``tri_inv_leaf``), as the TPU kernel does. Only
the lower triangle of ``Linv`` is read. ``B`` is read and ``X`` written
through their leading dimensions; ragged row counts need no padding. The
plain version is the same product,
``repro_torch.kernels.ref.qgemm_ref(b, linv, trans_b=True,
out_dtype=b.dtype)``; the solve itself is
:func:`repro_torch.kernels.ref.trsm_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_FNS: dict = {}
_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGS = (_P, _L, _P, _L, _P, _L, _I, _I, _P)


def _fn(dtype):
    if dtype not in _FNS:
        _FNS[dtype] = _build.function("trsm", f"trsm_leaf_{_SUFFIX[dtype]}",
                                      _ARGS)
    return _FNS[dtype]


def trsm_leaf(b, linv, *, out=None):
    """``b @ linv.T`` with ``linv`` lower-triangular: b (M, n), linv
    (n, n), both f32 or both f64 on one CUDA device with unit column
    stride; ``out`` (M, n) must not overlap ``b``."""
    if b.device.type != "cuda" or linv.device != b.device:
        raise ValueError(f"trsm_leaf: needs CUDA operands on one device, got "
                         f"{b.device}, {linv.device}")
    if b.dtype not in _SUFFIX or linv.dtype != b.dtype:
        raise TypeError(f"trsm_leaf: f32 or f64 operands of one dtype, got "
                        f"{b.dtype}, {linv.dtype}")
    if b.dim() != 2 or linv.shape != (b.shape[1], b.shape[1]):
        raise ValueError(f"trsm_leaf: shapes {tuple(b.shape)}, "
                         f"{tuple(linv.shape)}")
    M, n = b.shape
    if out is None:
        out = torch.empty((M, n), dtype=b.dtype, device=b.device)
    elif out.shape != b.shape or out.dtype != b.dtype \
            or out.device != b.device:
        raise ValueError(f"trsm_leaf: bad out {tuple(out.shape)}")
    if any(t.stride(1) != 1 for t in (b, linv, out)):
        raise ValueError("trsm_leaf: operands need unit column stride")
    if out.data_ptr() == b.data_ptr():
        raise ValueError("trsm_leaf: out must not alias b")
    if M == 0:
        return out
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        err = _fn(b.dtype)(b.data_ptr(), b.stride(0), linv.data_ptr(),
                           linv.stride(0), out.data_ptr(), out.stride(0),
                           M, n, stream)
    _build.check(err, "trsm_leaf")
    return out
