"""Wrapper of the leaf triangular-solve CUDA kernel (``csrc/trsm.cu``).

Replaces ``repro/kernels/trsm.py:trsm_leaf``: ``X = B L^-T`` for a
leaf-sized lower-triangular ``L``, computed as ``B @ Linv.T`` from the
leaf's inverse ``Linv`` (``tri_inv_leaf``), as the TPU kernel does. The
tree factor calls it 32 times at each M = 256, 512, ..., 8192 (n = 256 at
n = 16384): M n^2 operations, bound by the CUDA cores' f32 rate at
M = 8192 and by the launch itself at the small M. The kernel runs on the
register-blocked core of ``csrc/simt_gemm.cuh`` with ``Linv`` as a
lower-triangular operand: each block of output columns stops its k-range
at the diagonal, only the k-steps that cross it mask k > j, and the strict
upper triangle of ``Linv`` is never read.

:func:`plan` picks the grid from ``(M, n, dtype)`` alone, in plain Python
(so the CPU tests reach it), so that every M fills about a wave of the
H100's SMs: ``simt_wide`` (128 x 64 blocks, f32), ``simt_mid`` (64 x 64)
or ``simt_ksplit`` (64 x 64 with k split into chunks, summed in chunk
order by a second pass: no atomics, the same bits from run to run). A
CTA walks its k-range one step after another, so at the small M the
time is the heaviest CTA's chain of steps; a split shortens it. A
split's order is :func:`work_items`'; :func:`split_model` is its plain
version. ``B`` is read and ``X`` written through their leading
dimensions; rows off the 16-byte grid are read one element at a time.
The plain version is the same product,
``repro_torch.kernels.ref.qgemm_ref(b, linv, trans_b=True,
out_dtype=b.dtype)``; the solve itself is
:func:`repro_torch.kernels.ref.trsm_ref`.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build, qgemm

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_FNS: dict = {}
_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGS = (_P, _L, _I, _P, _L, _I, _P, _L, _P, _I, _I, _I, _I, _P)

#: output blocks (csrc/trsm.cu: tile codes 0 and 1); the wide one is f32 only
WIDE, MID = (128, 64), (64, 64)
_TILE_CODE = {WIDE: 0, MID: 1}
#: the H100's SMs; a plan with fewer CTAs states its reason
WAVE = 132
#: a grid of this many CTAs counts as a wave (the 64 x 64 grid at
#: M = 2048, n = 256: 4 SMs idle); the wide block takes two (two CTAs an SM)
FILL = 128
#: k-chunks a split may take, longest first: multiples and divisors of the
#: 64-column block, so each chunk of a block is as long as the next; 32 is
#: one step of the kernel's cp.async ring
SPLIT_CHUNKS = (128, 64, 32)
SIMT_BK = 16
_LAY_K, _LAY_ANY = 1, 0

ROUTES = ("simt_wide", "simt_mid", "simt_ksplit")


@dataclasses.dataclass(frozen=True)
class Plan:
    route: str          # a key of ops.TRSM_ROUTES
    tile: tuple         # (BM, BN)
    kc: int             # k-chunk, a multiple of 16; >= n is one pass
    chunks: int         # the scratch's depth: chunks of the longest block
    ctas: int           # thread blocks of the first launch
    reason: str = ""    # why ctas < WAVE, where it is


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def work_items(n: int, bn: int, kc: int) -> list[tuple[int, int, int, int]]:
    """``(n0, n1, k0, k1)`` of each item in the kernel's grid.y order: the
    column blocks ``[n0, n1)`` from the right (the longest k-range
    ``[0, n1)``) to the left, each block's k-chunks of ``kc`` in order."""
    items = []
    for j in reversed(range(_cdiv(n, bn))):
        n0, n1 = j * bn, min(n, (j + 1) * bn)
        items += [(n0, n1, k0, min(n1, k0 + kc)) for k0 in range(0, n1, kc)]
    return items


@functools.lru_cache(maxsize=1024)
def plan(M: int, n: int, dtype) -> Plan:
    """The grid of ``trsm_leaf`` for B (M, n) in ``dtype``: one pass in
    128 x 64 blocks (f32) where they make ``2 FILL`` CTAs, else in 64 x 64
    blocks where they make ``FILL``, else 64 x 64 blocks with the longest
    k-chunk of ``SPLIT_CHUNKS`` that reaches ``FILL`` (the shortest where
    none does). A grid under ``WAVE`` CTAs says why."""
    one = _cdiv(max(n, 1), SIMT_BK) * SIMT_BK
    rows = _cdiv(M, MID[0])
    wide = _cdiv(M, WIDE[0]) * _cdiv(n, WIDE[1])
    if dtype == torch.float32 and wide >= 2 * FILL:
        return Plan("simt_wide", WIDE, one, 1, wide)
    mid = rows * _cdiv(n, MID[1])
    if mid >= FILL:
        return Plan("simt_mid", MID, one, 1, mid, _short(mid, "one pass"))
    for kc in SPLIT_CHUNKS:
        if kc >= n:
            continue
        ctas = rows * len(work_items(n, MID[1], kc))
        if ctas >= FILL or kc == SPLIT_CHUNKS[-1]:
            last = ", the shortest" if kc == SPLIT_CHUNKS[-1] else ""
            return Plan("simt_ksplit", MID, kc, _cdiv(n, kc), ctas,
                        _short(ctas, f"k-chunks of {kc}{last}"))
    return Plan("simt_mid", MID, one, 1, rows * _cdiv(n, MID[1]),
                "n too small to split")


def _short(ctas: int, how: str) -> str:
    if ctas >= WAVE:
        return ""
    if ctas >= FILL:
        return f"{ctas} CTAs in {how}: one wave, {WAVE - ctas} SMs idle"
    return (f"{ctas} CTAs in {how}: each CTA's chain is one step of the "
            "cp.async ring, the shortest a split makes; the rest is the two "
            "launches' latency")


def split_model(b, linv, p: Plan):
    """Plain torch with the plan's chunking: each item's product of B's
    k-chunk and the lower triangle of Linv's, the chunks of a column block
    added in order (within a chunk the order is torch's)."""
    lt = torch.tril(linv)
    x = torch.zeros_like(b)
    for n0, n1, k0, k1 in work_items(b.shape[1], p.tile[1], p.kc):
        part = b[:, k0:k1] @ lt[n0:n1, k0:k1].T
        x[:, n0:n1] = part if k0 == 0 else x[:, n0:n1] + part
    return x


def _fn(dtype):
    if dtype not in _FNS:
        _FNS[dtype] = _build.function("trsm", f"trsm_leaf_{_SUFFIX[dtype]}",
                                      _ARGS)
    return _FNS[dtype]


def _lay(t):
    """``(layout code, leading dimension)`` of a (rows, k) operand with unit
    k stride: LAY_K where its base and rows are on the 16-byte grid."""
    major, ld = qgemm.layout(*t.shape, *t.stride(), t.element_size(),
                             t.data_ptr() % qgemm.ALIGN)
    return (_LAY_K, ld) if major == "k" else (_LAY_ANY, t.stride(0))


def trsm_leaf(b, linv, *, out=None):
    """``b @ linv.T`` with ``linv`` lower-triangular: b (M, n), linv
    (n, n), both f32 or both f64 on one CUDA device with unit column
    stride; ``out`` (M, n) must not overlap ``b``."""
    return launch(b, linv, out=out)[0]


def launch(b, linv, *, out=None):
    """:func:`trsm_leaf`, returning ``(out, plan)``."""
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
    p = plan(M, n, b.dtype)
    if M == 0:
        return out, p
    (blay, ldb), (llay, ldl) = _lay(b), _lay(linv)
    part = (torch.empty((p.chunks, M, n), dtype=b.dtype, device=b.device)
            if p.chunks > 1 else None)
    with _build.on_device(b.device):
        err = _fn(b.dtype)(b.data_ptr(), ldb, blay, linv.data_ptr(), ldl,
                           llay, out.data_ptr(), out.stride(0),
                           None if part is None else part.data_ptr(), M, n,
                           _TILE_CODE[p.tile], p.kc,
                           _build.raw_stream(b.device))
    _build.check(err, "trsm_leaf")
    return out, p
