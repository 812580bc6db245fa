"""Wrappers of the leaf Cholesky and leaf triangular-inverse CUDA kernels.

``potrf_leaf`` replaces ``repro/kernels/potrf.py:potrf_leaf`` and
``tri_inv_leaf`` replaces ``repro/kernels/potrf.py:tri_inv_leaf``; the
kernels are ``csrc/potrf.cu`` and ``csrc/tri_inv.cu``, whose headers say
what bounds them on the card. Both take f32 or f64 tiles on a CUDA
device, read their input through its leading dimension (a slice of a
larger matrix needs no copy) and write a fresh or given ``out`` tile.
Their plain versions are :func:`repro_torch.kernels.ref.potrf_ref` and
:func:`~repro_torch.kernels.ref.tri_inv_ref`. ``tri_inv_leaf_batched``
inverts a stack of tiles (such as :func:`diag_tiles` of a factor, read in
place) in one launch, one CTA a tile, through the same kernel, and
``potrf_leaf_batched`` factors a stack of tiles the same way (the K-FAC
refactor's diagonal tiles of all its blocks at once).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_FNS: dict = {}
_LL, _PTR, _INT = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
#: (A, lda, tile stride, O, ldo, tile stride, b, tiles, stream), the same
#: for both
_ARGS = {"potrf": (_PTR, _LL, _LL, _PTR, _LL, _LL, _INT, _INT, _PTR),
         "tri_inv": (_PTR, _LL, _LL, _PTR, _LL, _LL, _INT, _INT, _PTR)}


def _fn(lib: str, dtype):
    key = (lib, dtype)
    if key not in _FNS:
        _FNS[key] = _build.function(lib, f"{lib}_{_SUFFIX[dtype]}",
                                    _ARGS[lib])
    return _FNS[key]


def _check_input(x, what):
    if x.device.type != "cuda":
        raise ValueError(f"{what}: needs a CUDA tensor, got {x.device}")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"{what}: f32 or f64 only, got {x.dtype}")
    b = x.shape[-1]
    if x.shape != (b, b) or x.stride(1) != 1 or b % 32 or b > 512:
        raise ValueError(f"{what}: needs a (b, b) tile with unit column "
                         f"stride, b a multiple of 32 <= 512; got "
                         f"{tuple(x.shape)} strides {x.stride()}")
    return b


def _check_tile(x, out, what):
    b = _check_input(x, what)
    if out is None:
        return torch.empty((b, b), dtype=x.dtype, device=x.device)
    if (out.shape != x.shape or out.dtype != x.dtype or out.stride(1) != 1
            or out.device != x.device):
        raise ValueError(f"{what}: bad out tile {tuple(out.shape)}")
    return out


def _launch(lib, x, *args):
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _fn(lib, x.dtype)(*args, stream)
    _build.check(err, lib)


def potrf_leaf(a, *, out=None):
    """Lower Cholesky factor of one SPD tile, upper triangle zeroed; a
    tile that is not SPD gives NaN on and below the diagonal. ``out`` may
    be ``a``."""
    out = _check_tile(a, out, "potrf_leaf")
    _launch("potrf", a, a.data_ptr(), a.stride(0), 0, out.data_ptr(),
            out.stride(0), 0, a.shape[-1], 1)
    return out


def tri_inv_leaf(l, *, out=None):
    """Inverse of a lower-triangular tile (``out`` must not be ``l``)."""
    out = _check_tile(l, out, "tri_inv_leaf")
    if out.data_ptr() == l.data_ptr():
        raise ValueError("tri_inv_leaf: out must not alias its input")
    _launch("tri_inv", l, l.data_ptr(), l.stride(0), 0, out.data_ptr(),
            out.stride(0), 0, l.shape[-1], 1)
    return out


def diag_tiles(l, b: int):
    """The (T, b, b) view of the diagonal (b, b) tiles of a square matrix
    ``l`` with unit column stride: tile t starts b (ld + 1) elements after
    tile t - 1. No copy."""
    n = l.shape[-1]
    if l.shape != (n, n) or n % b or l.stride(1) != 1:
        raise ValueError(f"diag_tiles: needs an (n, n) matrix with unit "
                         f"column stride, n a multiple of {b}; got "
                         f"{tuple(l.shape)} strides {l.stride()}")
    ld = l.stride(0)
    return l.as_strided((n // b, b, b), (b * (ld + 1), ld, 1))


def _check_stack(tiles, what):
    if tiles.dim() != 3 or tiles.shape[0] == 0:
        raise ValueError(f"{what}: needs (T, b, b) tiles, T > 0, got "
                         f"{tuple(tiles.shape)}")
    return _check_input(tiles[0], what)


def potrf_leaf_batched(tiles):
    """Lower Cholesky factors of a (T, b, b) stack of SPD tiles in ONE
    launch, one CTA a tile, into a new contiguous (T, b, b) stack; the
    tiles are read in place through their strides (row stride and tile
    stride, unit column stride). Each tile's bits equal those of
    :func:`potrf_leaf` on it; a tile that is not SPD gives NaN on and below
    its diagonal and leaves the others alone."""
    b = _check_stack(tiles, "potrf_leaf_batched")
    ntiles = tiles.shape[0]
    out = torch.empty((ntiles, b, b), dtype=tiles.dtype, device=tiles.device)
    _launch("potrf", tiles, tiles.data_ptr(), tiles.stride(1),
            tiles.stride(0), out.data_ptr(), b, b * b, b, ntiles)
    return out


def tri_inv_leaf_batched(tiles):
    """Inverses of a (T, b, b) stack of lower-triangular tiles in ONE
    launch, one CTA a tile, into a new contiguous (T, b, b) stack. The
    tiles are read in place through their strides (row stride and tile
    stride, unit column stride), so :func:`diag_tiles` of a factor needs
    no copy. Each tile's bits equal those of :func:`tri_inv_leaf` on it."""
    b = _check_stack(tiles, "tri_inv_leaf_batched")
    ntiles = tiles.shape[0]
    out = torch.empty((ntiles, b, b), dtype=tiles.dtype, device=tiles.device)
    _launch("tri_inv", tiles, tiles.data_ptr(), tiles.stride(1),
            tiles.stride(0), out.data_ptr(), b, b * b, b, ntiles)
    return out
