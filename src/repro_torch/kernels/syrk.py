"""Wrappers of the SYRK CUDA kernels (``csrc/syrk.cu``).

``syrk_leaf`` replaces ``repro/kernels/syrk.py:syrk_leaf`` (the tree
engine's diagonal leaf) and ``syrk_packed`` replaces
``repro/kernels/syrk.py:syrk_packed`` (the whole lower triangle on a
triangular tile grid). Both compute ``C <- beta C + scale A A^T`` on the
lower triangle of ``C`` (f32 or f64) for ``A`` in f32, bf16, f16, int8
(summed exactly in s32) or f64, and keep ``C``'s strict upper triangle as
it was; their plain version is
:func:`repro_torch.kernels.ref.syrk_ref`. ``syrk_leaf`` splits k across
thread blocks in chunks fixed by the shape (:func:`leaf_chunk`), so its
sums are the same from run to run; its f32 first pass (every leaf of the
tree factor) runs on the register-blocked core of ``csrc/simt_gemm.cuh``
in 128 x 128 blocks, the other types on the 64 x 64 core of
``csrc/common.cuh``.

``syrk_packed`` is bound by its n^2 k products: at the CUDA cores' rate
for f32 (67 TFLOP/s) and f64, at the tensor cores' for 16-bit and int8 A,
which the TPU kernel's MXU takes natively. :func:`packed_plan` picks its
route from the shape, the types and A's layout, in plain Python (so the
CPU tests reach it), and ``ops.SYRK_PACKED_ROUTES`` counts them:

- ``tc``: bf16, f16 and int8 A on ``wgmma`` (``csrc/tc_gemm.cuh``, the
  main loop of qgemm's tensor-core route) over a triangular grid of
  128 x 256 tiles, the epilogue on the lower triangle only; int8 sums are
  exact. ``tc_staged``: the same after copying A into a K-major buffer on
  TMA's 16-byte grid, where A's base or row stride is off it.
- ``simt``: f32, f64 and f32 A with an f64 C on ``csrc/simt_gemm.cuh``
  over a triangular grid of lower blocks, one pass over all of k: 128 x 128
  blocks of 8 x 8 micro-tiles where they fill a wave (f32), else 64 x 64;
  each element is fma in k order from +0 whatever the block.

``scale`` and ``beta`` may be Python numbers or 0-d f32 tensors on the
card; a tensor is read by the kernel from device memory, so the per-block
quantization scales of the tree engine never cross to the host.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build, qgemm

#: (A dtype, C dtype) -> kernel suffix
_SUFFIX = {(torch.float32, torch.float32): "f32",
           (torch.bfloat16, torch.float32): "bf16",
           (torch.float16, torch.float32): "f16",
           (torch.int8, torch.float32): "s8",
           (torch.float32, torch.float64): "f32_f64",
           (torch.float64, torch.float64): "f64"}
_FNS: dict = {}
_P, _L, _I, _D = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                  ctypes.c_double)
_LEAF_ARGS = (_P, _L, _P, _L, _P, _I, _I, _I, _P, _D, _P, _D, _P)
_PACKED_ARGS = (_P, _L, _P, _L, _I, _I, _I, _I, _P, _D, _P, _D, _P)
#: pass-1 output block -> (about this many thread blocks, the shortest
#: k-chunk a split may make): two waves of the H100's 132 SMs for the 64 x 64
#: blocks of csrc/common.cuh, one wave (one CTA an SM) for the 128 x 128
#: blocks of the f32 leaf (csrc/syrk.cu: SW_B)
_SPLIT = {64: (320, 256), 128: (132, 64)}

#: A's types on the tensor cores (syrk_packed's tc route)
TC_DTYPES = (torch.bfloat16, torch.float16, torch.int8)
#: syrk_packed's output tiles: the tensor cores' (csrc/tc_gemm.cuh: QTC_BM,
#: QTC_BN) and the SIMT blocks (csrc/syrk.cu: syrk_packed_simt)
TC_TILE = (128, 256)
SIMT_WIDE, SIMT_MID = 128, 64
#: the H100's SMs: a grid of fewer 128 x 128 blocks takes 64 x 64 ones
WAVE = 132
PACKED_ROUTES = ("tc", "tc_staged", "simt")


@dataclasses.dataclass(frozen=True)
class PackedPlan:
    route: str          # a key of ops.SYRK_PACKED_ROUTES
    tile: tuple         # output tile (rows, columns)
    ctas: int           # thread blocks of the launch
    stage: bool = False     # tc: copy A into an aligned K-major buffer
    async_: bool = False    # simt: A's rows through the cp.async ring


@functools.lru_cache(maxsize=1024)
def packed_plan(n: int, k: int, a_dtype, c_dtype, a_layout) -> PackedPlan:
    """The route of ``syrk_packed`` for A (n, k) of ``a_dtype`` into C of
    ``c_dtype``; ``a_layout`` is :func:`repro_torch.kernels.qgemm.layout`'s
    verdict on A (``"k"``: K-major on the 16-byte grid)."""
    del k  # one pass over all of k on every route
    aligned = a_layout == "k"
    if a_dtype in TC_DTYPES:
        t = _cdiv(n, TC_TILE[1])
        return PackedPlan("tc" if aligned else "tc_staged", TC_TILE,
                          t * (t + 1), stage=not aligned)
    block = SIMT_MID
    if (a_dtype, c_dtype) == (torch.float32, torch.float32):
        t = _cdiv(n, SIMT_WIDE)
        if t * (t + 1) // 2 >= WAVE:
            block = SIMT_WIDE
    t = _cdiv(n, block)
    return PackedPlan("simt", (block, block), t * (t + 1) // 2,
                      async_=aligned)


def _fn(kind, key):
    if (kind, key) not in _FNS:
        _FNS[(kind, key)] = _build.function(
            "syrk", f"syrk_{kind}_{_SUFFIX[key]}",
            _LEAF_ARGS if kind == "leaf" else _PACKED_ARGS)
    return _FNS[(kind, key)]


def leaf_block(a_dtype, c_dtype) -> int:
    """The output block of syrk_leaf's first pass for these types."""
    return 128 if (a_dtype, c_dtype) == (torch.float32, torch.float32) else 64


def leaf_chunk(n: int, k: int, block: int = 64) -> tuple[int, int]:
    """``(kc, chunks)``: the k-chunk of syrk_leaf's first pass and their
    number, from the shape and the block of :func:`leaf_block` alone:
    qgemm's k-split over the triangle's blocks, aiming at about
    ``_SPLIT[block][0]`` thread blocks, at most ``ceil(k / _SPLIT[block][1])``
    chunks, each a multiple of 16."""
    nt = _cdiv(n, block)
    return qgemm.k_split(k, nt * (nt + 1) // 2, *_SPLIT[block])


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _prepare(c, a, out, scale, beta, what):
    dev = c.device
    if dev.type != "cuda" or a.device != dev:
        raise ValueError(f"{what}: needs CUDA operands on one device, got "
                         f"{c.device}, {a.device}")
    key = (a.dtype, c.dtype)
    if key not in _SUFFIX:
        raise TypeError(f"{what}: A {a.dtype} with C {c.dtype}")
    n = c.shape[-1]
    if c.shape != (n, n) or a.dim() != 2 or a.shape[0] != n:
        raise ValueError(f"{what}: shapes c {tuple(c.shape)}, a "
                         f"{tuple(a.shape)}")
    if out is None:
        out = c.clone()
    elif out is not c:
        if out.shape != c.shape or out.dtype != c.dtype or out.device != dev:
            raise ValueError(f"{what}: bad out {tuple(out.shape)}")
        out.copy_(c)
    if a.stride(1) != 1 or out.stride(1) != 1:
        raise ValueError(f"{what}: a and out need unit column stride")
    return (key, out, _build.scalar_arg(scale, dev, what),
            _build.scalar_arg(beta, dev, what))


def syrk_leaf(c, a, scale=1.0, beta=1.0, *, out=None):
    """Lower triangle of ``beta c + scale a a^T`` over ``c``'s upper
    triangle, into ``out`` (a copy of ``c`` unless given; ``out`` may be
    ``c`` itself)."""
    key, out, (sp, sh), (bp, bh) = _prepare(c, a, out, scale, beta,
                                            "syrk_leaf")
    n, k = a.shape
    block = leaf_block(a.dtype, c.dtype)
    kc, chunks = leaf_chunk(n, k, block)
    part = None
    if chunks > 1:
        acc = {torch.int8: torch.int32, torch.float64: torch.float64}.get(
            a.dtype, torch.float64 if c.dtype == torch.float64
            else torch.float32)
        nt = _cdiv(n, block)
        part = torch.empty((chunks, nt * (nt + 1) // 2, block, block),
                           dtype=acc, device=c.device)
    with _build.on_device(c.device):
        err = _fn("leaf", key)(
            a.data_ptr(), a.stride(0), out.data_ptr(), out.stride(0),
            None if part is None else part.data_ptr(), n, k, kc, sp, sh,
            bp, bh, _build.raw_stream(c.device))
    _build.check(err, "syrk_leaf")
    return out


def syrk_packed(c, a, scale=1.0, beta=1.0, *, out=None):
    """As :func:`syrk_leaf`, in one pass over all of k, for any (n, k)."""
    return packed_launch(c, a, scale, beta, out=out)[0]


def packed_launch(c, a, scale=1.0, beta=1.0, *, out=None):
    """:func:`syrk_packed`, returning ``(out, plan)``."""
    key, out, (sp, sh), (bp, bh) = _prepare(c, a, out, scale, beta,
                                            "syrk_packed")
    n, k = a.shape
    major, lda = qgemm.layout(n, k, *a.stride(), a.element_size(),
                              a.data_ptr() % qgemm.ALIGN)
    p = packed_plan(n, k, a.dtype, c.dtype, major)
    if p.stage:
        a = qgemm._k_major_copy(a)
        lda = a.stride(0)
    elif major != "k":
        lda = a.stride(0)
    with _build.on_device(c.device):
        err = _fn("packed", key)(
            a.data_ptr(), lda, out.data_ptr(), out.stride(0), n, k,
            p.tile[0], int(p.async_), sp, sh, bp, bh,
            _build.raw_stream(c.device))
    _build.check(err, "syrk_packed")
    return out, p


def tri_decode(count: int, device="cuda"):
    """``(i, j)`` int32 tensors of the lower-triangular decode the kernels
    run (``csrc/common.cuh:tri_decode``) for t = 0 .. count - 1."""
    i = torch.empty(count, dtype=torch.int32, device=device)
    j = torch.empty(count, dtype=torch.int32, device=device)
    fn = _build.function("syrk", "tri_decode_check", (_P, _P, _I, _P))
    with _build.on_device(i.device):
        err = fn(i.data_ptr(), j.data_ptr(), count,
                 _build.raw_stream(i.device))
    _build.check(err, "tri_decode")
    return i, j
