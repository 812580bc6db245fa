"""Wrappers of the leaf Cholesky and leaf triangular-inverse CUDA kernels.

``potrf_leaf`` replaces ``repro/kernels/potrf.py:potrf_leaf`` and
``tri_inv_leaf`` replaces ``repro/kernels/potrf.py:tri_inv_leaf``; the
kernels are ``csrc/potrf.cu`` and ``csrc/tri_inv.cu``, whose headers say
what bounds them on the card. Both take f32 or f64 tiles on a CUDA
device, read their input through its leading dimension (a slice of a
larger matrix needs no copy) and write a fresh or given ``out`` tile.
Their plain versions are :func:`repro_torch.kernels.ref.potrf_ref` and
:func:`~repro_torch.kernels.ref.tri_inv_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_FNS: dict = {}
_ARGS = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p)


def _fn(lib: str, dtype):
    key = (lib, dtype)
    if key not in _FNS:
        _FNS[key] = _build.function(lib, f"{lib}_{_SUFFIX[dtype]}", _ARGS)
    return _FNS[key]


def _check_tile(x, out, what):
    if x.device.type != "cuda":
        raise ValueError(f"{what}: needs a CUDA tensor, got {x.device}")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"{what}: f32 or f64 only, got {x.dtype}")
    b = x.shape[-1]
    if x.shape != (b, b) or x.stride(1) != 1 or b % 32 or b > 512:
        raise ValueError(f"{what}: needs a (b, b) tile with unit column "
                         f"stride, b a multiple of 32 <= 512; got "
                         f"{tuple(x.shape)} strides {x.stride()}")
    if out is None:
        return torch.empty((b, b), dtype=x.dtype, device=x.device)
    if (out.shape != x.shape or out.dtype != x.dtype or out.stride(1) != 1
            or out.device != x.device):
        raise ValueError(f"{what}: bad out tile {tuple(out.shape)}")
    return out


def _launch(lib, x, out):
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _fn(lib, x.dtype)(x.data_ptr(), x.stride(0), out.data_ptr(),
                                out.stride(0), x.shape[-1], stream)
    _build.check(err, lib)
    return out


def potrf_leaf(a, *, out=None):
    """Lower Cholesky factor of one SPD tile, upper triangle zeroed; a
    tile that is not SPD gives NaN on and below the diagonal. ``out`` may
    be ``a``."""
    return _launch("potrf", a, _check_tile(a, out, "potrf_leaf"))


def tri_inv_leaf(l, *, out=None):
    """Inverse of a lower-triangular tile (``out`` must not be ``l``)."""
    out = _check_tile(l, out, "tri_inv_leaf")
    if out.data_ptr() == l.data_ptr():
        raise ValueError("tri_inv_leaf: out must not alias its input")
    return _launch("tri_inv", l, out)
