"""Wrapper of the mixed-precision GEMM CUDA kernels (``csrc/qgemm.cu``).

Replaces ``repro/kernels/qgemm.py:qgemm``:
``out = scale * (a @ b[.T]) + beta * c`` with f32 accumulation for f32,
f16 and bf16 operands, f64 for f64 operands or f32 operands with an f64
``c``, and exact s32 for int8 operands, as
:func:`repro_torch.kernels.ref.qgemm_ref` computes it. The
operands are read through their strides, so a transposed or sliced view
(``l[r0:r1, :r0].T`` in the back substitution) is passed without a copy;
``c`` and ``out`` need unit column stride, and ``out`` may be ``c``
itself for an in-place update.

:func:`plan` picks the route from the shape, the dtypes and the operands'
layouts, in plain Python (so the CPU tests reach it):

- ``tc``: f16, bf16 and int8 operands on the tensor cores (``wgmma`` fed by
  TMA), 128 x 256 tiles, one pass over k. ``tc_staged``: the same kernel
  after the wrapper has copied an operand into a K-major buffer, because
  s8 ``wgmma`` takes K-major operands only, or because TMA cannot address
  the operand (a base or a row stride that is not a multiple of 16 bytes).
- ``simt_ksplit``: f32/f64 on the CUDA cores with k split into chunks fixed
  by (M, K), summed in chunk order by a second pass (narrow outputs with a
  long k: the tree factor's (256 x 8192) (256 x 8192)^T). The partial sums
  of a launch pair take at most ``KSPLIT_SCRATCH_BYTES``: a wider output is
  done in blocks of columns, which moves no bit.
- ``simt_tile``: f32/f64, one pass in 128 x 128 tiles (64 x 64 with an f64
  accumulator, or where 128 x 128 tiles would not fill half the SMs).
- ``simt_narrow``: f32/f64, a 64 x 16 tile streaming A once, for up to
  ``NARROW_MAX_N`` columns (the sweeps' right-hand sides).

A column's summation order depends on M, K and the dtypes only: the
tensor-core tile is fixed, and every SIMT tile sums a chunk's products in
the same sequential order (``csrc/simt_gemm.cuh``), so the SIMT tile and
the k-split's column blocks, the only choices that follow N, move no bit.
Which route ran is returned by :func:`launch` and counted by
``ops.QGEMM_ROUTES``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build

_SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.float16: "f16",
           torch.bfloat16: "bf16", torch.int8: "s8"}
_FNS: dict = {}
_P, _L, _I, _D = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                  ctypes.c_double)
_TC_ARGS = (_P, _L, _I, _P, _L, _I, _P, _L, _P, _L, _I, _I, _I, _D, _D, _P,
            _I, _P)
_SIMT_ARGS = (_P, _L, _L, _I, _P, _L, _L, _I, _P, _L, _P, _L, _P, _I, _I,
              _I, _I, _I, _D, _D, _P, _I, _P)

#: operand dtypes of the tensor-core route
TC_DTYPES = (torch.float16, torch.bfloat16, torch.int8)
#: output tile of the tensor-core kernel (csrc/qgemm.cu: QTC_BM, QTC_BN)
TC_TILE = (128, 256)
#: bytes of k a stage holds: one 128-byte swizzle row (64 16-bit values or
#: 128 int8), four wgmma k-steps of 32 bytes
TC_STAGE_K_BYTES = 128
#: k of one wgmma: 32 bytes of the operand type
TC_WGMMA_K = {torch.float16: 16, torch.bfloat16: 16, torch.int8: 32}
#: TMA's alignment of bases and row strides, and of the SIMT 16-byte loads
ALIGN = 16
#: SIMT tiles (csrc/qgemm.cu entries): wide by accumulator, narrow, and mid
#: for one-pass f32 outputs whose wide tiles would not fill one wave
SIMT_WIDE = {torch.float32: (128, 128), torch.float64: (64, 64)}
SIMT_NARROW = (64, 16)
SIMT_MID = (64, 64)
#: half the H100's 132 SMs: a one-pass grid of at most this many wide tiles
#: takes the mid tile (four times the CTAs)
HALF_WAVE = 66
#: the widest N the narrow tile takes (three 16-column groups)
NARROW_MAX_N = 48
#: k of one SIMT step (csrc/simt_gemm.cuh: SG_BK); chunks are multiples
SIMT_BK = 16
#: a k-split aims at about this many CTAs (two waves of the H100's 132 SMs)
TARGET_CTAS = 264
#: the shortest k-chunk a split may make
MIN_CHUNK = 256
#: the most scratch a k-split's partial sums take; wider outputs go in
#: blocks of columns (a column's sums do not depend on its block)
KSPLIT_SCRATCH_BYTES = 64 << 20

ROUTES = ("tc", "tc_staged", "simt_ksplit", "simt_tile", "simt_narrow")


@dataclasses.dataclass(frozen=True)
class Plan:
    route: str          # a key of ops.QGEMM_ROUTES
    tile: tuple         # (BM, BN) of the launch
    kc: int             # k-chunk; chunks == 1 means one pass over k
    chunks: int
    stage_a: bool = False   # tc: copy A into a K-major buffer first
    stage_b: bool = False
    cols: int = 0       # columns a SIMT launch takes (the k-split's cap)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=4096)
def layout(rows: int, k: int, s_rows: int, s_k: int, esz: int,
           offset_bytes: int = 0):
    """``(major, ld)`` of a (rows, k) operand with strides (s_rows, s_k)
    whose base lies ``offset_bytes`` past a 16-byte boundary: ``"k"``
    (unit k stride, rows ld apart), ``"mn"`` (unit row stride, k-rows ld
    apart) or ``None`` (neither, or a base or ld off the 16-byte grid).
    A dimension of size 1 takes either role; its stride is then free and
    ld is the other's extent rounded up to the grid."""
    vw = ALIGN // esz
    if offset_bytes % ALIGN:
        return None, 0
    for major, unit, n_unit, ld, n_other in (("k", s_k, k, s_rows, rows),
                                             ("mn", s_rows, rows, s_k, k)):
        if unit != 1 and n_unit != 1:
            continue
        if n_other == 1:
            ld = _cdiv(max(n_unit, 1), vw) * vw
        if (ld * esz) % ALIGN == 0 and ld >= 1:
            return major, ld
    return None, 0


def k_split(K: int, tiles: int, target: int = TARGET_CTAS,
            min_chunk: int = MIN_CHUNK) -> tuple[int, int]:
    """``(kc, chunks)`` of a k-split over ``tiles`` output tiles: about
    ``target`` CTAs, at most ``ceil(K / min_chunk)`` chunks, each a
    multiple of ``SIMT_BK``. qgemm's SIMT routes and syrk_leaf's first pass
    both split k by it, from a tile count that does not follow N."""
    s = max(1, min(_cdiv(K, min_chunk), target // max(tiles, 1)))
    kc = max(SIMT_BK, _cdiv(_cdiv(max(K, 1), s), SIMT_BK) * SIMT_BK)
    return kc, (_cdiv(K, kc) if K > kc else 1)


@functools.lru_cache(maxsize=4096)
def plan(M: int, N: int, K: int, dtype, a_major, b_major,
         acc=None) -> Plan:
    """The route of ``(M x K) @ (K x N)`` in ``dtype`` (accumulating in
    ``acc``, default :func:`acc_dtype` of ``dtype``); ``a_major`` /
    ``b_major`` are :func:`layout`'s verdicts on A and on B's (N, K)
    view."""
    if dtype in TC_DTYPES:
        ok = ("k",) if dtype == torch.int8 else ("k", "mn")
        sa, sb = a_major not in ok, b_major not in ok
        return Plan("tc_staged" if sa or sb else "tc", TC_TILE, max(K, 1),
                    1, sa, sb)
    acc = acc or acc_dtype(dtype)
    wide = SIMT_WIDE[acc]
    # chunks as if the output were M x M: the split must not follow N
    kc, chunks = k_split(K, _cdiv(max(M, 1), wide[0]) ** 2)
    if N <= NARROW_MAX_N:
        tile = SIMT_NARROW
    elif chunks == 1 and _cdiv(M, wide[0]) * _cdiv(N, wide[1]) <= HALF_WAVE:
        tile = SIMT_MID
    else:
        tile = wide
    route = ("simt_ksplit" if chunks > 1 else
             "simt_narrow" if tile == SIMT_NARROW else "simt_tile")
    cols = N
    if chunks > 1:
        per_col = chunks * max(M, 1) * (8 if acc == torch.float64 else 4)
        cols = min(N, max(wide[1], KSPLIT_SCRATCH_BYTES // per_col
                          // wide[1] * wide[1]))
    return Plan(route, tile, kc, chunks, cols=cols)


def acc_dtype(dtype, c_dtype=None):
    """The output/epilogue dtype the kernel computes for operand ``dtype``
    (and accumulator ``c_dtype``): f64 if either is f64, else f32."""
    return (torch.float64 if torch.float64 in (dtype, c_dtype)
            else torch.float32)


def _fn(dtype, od):
    key = (dtype, od)
    if key not in _FNS:
        sfx = _SUFFIX[dtype]
        if od != acc_dtype(dtype):
            sfx += "_f64"
        _FNS[key] = _build.function(
            "qgemm", f"qgemm_{sfx}",
            _TC_ARGS if dtype in TC_DTYPES else _SIMT_ARGS)
    return _FNS[key]


def _major(t):
    """:func:`layout` of a 2-D operand view (rows, k)."""
    return layout(*t.shape, *t.stride(), t.element_size(),
                  t.data_ptr() % ALIGN)


def _k_major_copy(t):
    """``t`` (rows, k) copied into a K-major buffer whose row stride is a
    multiple of 16 bytes (the kernel's tensor map stops at k, so the
    padding is never read)."""
    rows, k = t.shape
    vw = ALIGN // t.element_size()
    buf = torch.empty((rows, _cdiv(max(k, 1), vw) * vw), dtype=t.dtype,
                      device=t.device)
    buf[:, :k].copy_(t)
    return buf[:, :k]


_LAY = {"k": 1, "mn": 2, None: 0}
#: csrc/qgemm.cu's tile codes; anything else is the accumulator's wide tile
#: (with an f64 accumulator that is SIMT_MID: one kernel either way)
_TILE_CODE = {SIMT_NARROW: 1, SIMT_MID: 2}


def qgemm(a, b, scale=1.0, *, c=None, beta=0.0, trans_b=False,
          out_dtype=torch.float32, out=None):
    """``scale`` is a float, or a 0-d f32 tensor on the operands' device
    that the kernel reads from device memory (no host sync)."""
    return launch(a, b, scale, c=c, beta=beta, trans_b=trans_b,
                  out_dtype=out_dtype, out=out)[0]


def launch(a, b, scale=1.0, *, c=None, beta=0.0, trans_b=False,
           out_dtype=torch.float32, out=None):
    """:func:`qgemm`, returning ``(out, plan)``."""
    dev, dt = a.device, a.dtype
    if dev.type != "cuda" or b.device != dev:
        raise ValueError(f"qgemm: needs CUDA operands on one device, got "
                         f"{dev}, {b.device}")
    if b.dtype != dt or dt not in _SUFFIX:
        raise TypeError(f"qgemm: operands {dt}, {b.dtype}")
    od = acc_dtype(dt, None if c is None else c.dtype)
    if od != acc_dtype(dt) and dt != torch.float32:
        raise TypeError(f"qgemm: {dt} operands take no {od} c")
    if out_dtype != od:
        raise TypeError(f"qgemm: {dt} operands give {od}, not {out_dtype}")
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"qgemm: operands of shapes {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    bn = b if trans_b else b.T              # B as its (N, K) view
    M, K = a.shape
    N, Kb = bn.shape
    if K != Kb:
        raise ValueError(f"qgemm: shapes {tuple(a.shape)} @ "
                         f"{tuple(bn.T.shape)}")
    for name, t in (("c", c), ("out", out)):
        if t is not None and (t.shape != (M, N) or t.dtype != od
                              or t.stride(1) != 1 or t.device != dev):
            raise ValueError(f"qgemm: {name} must be ({M}, {N}) {od} with "
                             f"unit column stride")
    if out is None:
        out = torch.empty((M, N), dtype=od, device=dev)
    elif out.data_ptr() in (a.data_ptr(), b.data_ptr()):
        raise ValueError("qgemm: out must not alias an operand")
    has_c = c is not None
    scale_dev, scale = _build.scalar_arg(scale, dev, "qgemm")
    (am, lda), (bm, ldb) = _major(a), _major(bn)
    p = plan(M, N, K, dt, am, bm, od)
    with _build.on_device(dev):
        stream = _build.raw_stream(dev)
        cargs = (c.data_ptr() if has_c else None, c.stride(0) if has_c else 0,
                 out.data_ptr(), out.stride(0))
        if dt in TC_DTYPES:
            if p.stage_a:
                a = _k_major_copy(a)
                am, lda = "k", a.stride(0)
            if p.stage_b:
                bn = _k_major_copy(bn)
                bm, ldb = "k", bn.stride(0)
            err = _fn(dt, od)(
                a.data_ptr(), lda, int(am == "mn"), bn.data_ptr(), ldb,
                int(bm == "mn"), *cargs, M, N, K, scale, float(beta),
                scale_dev, int(has_c), stream)
        else:
            part = (torch.empty((p.chunks, M, p.cols), dtype=od, device=dev)
                    if p.chunks > 1 else None)
            # one launch pair, or one a block of p.cols columns (offsets a
            # multiple of the wide tile keep every operand's alignment)
            esz, osz = a.element_size(), out.element_size()
            cp, ldc, op, ldo = cargs
            for n0 in range(0, max(N, 1), max(p.cols, 1)):
                err = _fn(dt, od)(
                    a.data_ptr(), a.stride(0), a.stride(1), _LAY[am],
                    bn.data_ptr() + n0 * bn.stride(0) * esz, bn.stride(0),
                    bn.stride(1), _LAY[bm], cp and cp + n0 * osz, ldc,
                    op + n0 * osz, ldo,
                    None if part is None else part.data_ptr(), M,
                    min(N, n0 + p.cols) - n0, K, p.kc,
                    _TILE_CODE.get(p.tile, 0), scale, float(beta),
                    scale_dev, int(has_c), stream)
                if err:
                    break
    _build.check(err, "qgemm")
    return out, p
