"""Wrapper of the fused panel-update CUDA kernels (``csrc/panel.cu``).

Replaces ``repro/kernels/panel.py:panel_update``, the blocked engine's
O(n^3) step: ``L21 = A21 @ L11^-T`` and ``C -= L21 L21^T`` on the lower
tiles, with the plan's per-tile roundings
(:func:`repro_torch.kernels.ref.panel_update_ref` is its plain version).
It works in place on the engine's working buffer: ``a21`` becomes L21,
the lower tiles of ``c`` are updated and its strict upper triangle is
left untouched. Both are read and written through their leading
dimension.

Each lower tile pair ``(i, j)`` of the trailing update takes one of two
routes, by :func:`route` from the pair's name, the container dtype and
the leaf ``b`` alone (:func:`plan` lists them, in plain Python):

- ``tc``: an f32 container, a pair named f16, bf16 or int8, and
  ``b`` = 128 or 256 (:data:`TC_LEAVES`): the tensor cores (``wgmma``) on
  the pair name's codes, f32 accumulation (s32 for int8), the scales
  applied after the product.
- ``simt``: every other pair: f32 and f64 names, every name on an f64
  container, and every pair at any other ``b`` the wrapper takes
  (``b % 64 == 0``: 64, 192, 320, 384, 448, 512, ...); the CUDA cores in
  the container's type.

The products of both routes are exact on the grid values the reference
multiplies; only the summation order of a tile's b-term dot products
differs from the reference's (``csrc/panel.cu``). The plan's names reach
the kernels as int32 rounding codes, ``name | quant << 3``; the tables
are built once per panel geometry and kept on the device.

:func:`launch` with 3-D operands runs panel p of N matrices of one
geometry (``linv`` (N, b, b), ``a21`` (N, m, b), ``c`` (N, m, m), each at
a uniform batch stride) in one launch of each step: the K-FAC refactor's
panel of every block at once. All N share one plan; each matrix's tiles
take their own absmax and scales, so matrix i's bits are those of
:func:`panel_update` on it.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
#: rounding-name alphabet of csrc/common.cuh
NAME_CODE = {"f64": 0, "f32": 1, "bf16": 2, "f16": 3, "int8": 4}
#: slot kinds of the pair-name copies (csrc/panel.cu: KIND_*): the
#: container type for the CUDA cores, the tensor cores' operand type, or
#: no copy at all: L21 itself, read in place, for a name whose rounding is
#: the identity in the container (f32 and f64 in f32, f64 in f64)
KIND = {"simt": 0, "f16": 1, "bf16": 2, "int8": 3, "self": 4}
#: the pair names, and the leaves, that the tensor-core route takes
TC_NAMES = ("f16", "bf16", "int8")
TC_LEAVES = (128, 256)
ROUTES = ("tc", "simt")
#: sub-block index of a simt item that walks its whole (scaled) tile
SUB_ALL = 0xFF
_FNS: dict = {}
_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
#: (linv, ldlinv, batch stride, a21, lda, batch stride, c, ldc, batch
#: stride, nbatch, a_r, lq, slot_stride, alpha, store_tab, codes, kinds,
#: codes_h, kinds_h, nslots, tc_items, tc_off, simt_items, nsimt, nt, b, bt,
#: rounding, stream)
_ARGS = (_P, _L, _L, _P, _L, _L, _P, _L, _L, _I, _P, _P, _L, _P, _P, _P, _P,
         _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P)


def _fn(dtype):
    if dtype not in _FNS:
        _FNS[dtype] = _build.function(
            "panel", f"panel_update_{_SUFFIX[dtype]}", _ARGS)
    return _FNS[dtype]


def rcode(name: str, quant: bool) -> int:
    return NAME_CODE[name] | (int(bool(quant)) << 3)


def scaled(name: str, quant: bool) -> bool:
    """int8 and quantized f16 scale by their tile's absmax."""
    return name == "int8" or (name == "f16" and bool(quant))


def route(name: str, dtype, b: int) -> str:
    """The route of a pair named ``name`` in a ``dtype`` container at
    leaf ``b``."""
    if dtype == torch.float32 and name in TC_NAMES and b in TC_LEAVES:
        return "tc"
    return "simt"


def identity(name: str, dtype) -> bool:
    """Rounding at ``name`` leaves a ``dtype`` container's values as they
    are."""
    return name == "f64" or (name == "f32" and dtype == torch.float32)


def simt_tile(dtype, b: int) -> int:
    """The CUDA cores' square sub-block: 128 for f32 where it divides b,
    else 64."""
    return 128 if dtype == torch.float32 and b % 128 == 0 else 64


@dataclasses.dataclass(frozen=True)
class Plan:
    """One panel's routes: ``slots[s] = (name, quant, code, kind)``, one
    L21 copy per pair name; ``tc_pairs[s]`` the (i, j) pairs of a tc
    slot (empty for a simt slot); ``simt_items`` the simt route's
    ``(i, j, slot, code, sub)`` work items, ``sub`` a sub-block of the
    tile or :data:`SUB_ALL`; ``routes`` the pairs by route."""

    slots: tuple
    tc_pairs: tuple
    simt_items: tuple
    routes: dict


@functools.lru_cache(maxsize=1024)
def plan(pair_names, pair_quants, dtype, b, rounding=True,
         in_place=True) -> Plan:
    """Routes of every lower pair of one panel (``pair_names[i][j]`` for
    the trailing row tiles i >= j), in row-major order of the pairs.
    ``in_place``: the CUDA cores may read L21 itself for an identity name
    (its rows are 16-byte aligned) instead of a copy."""
    nt = len(pair_names)
    quant_by = {nm: bool(q) for row_n, row_q in zip(pair_names, pair_quants)
                for nm, q in zip(row_n, row_q)}
    names = sorted(quant_by)
    def kind(nm):
        if route(nm, dtype, b) == "tc":
            return KIND[nm]
        return KIND["self" if in_place and identity(nm, dtype) else "simt"]
    slots = tuple((nm, quant_by[nm], rcode(nm, quant_by[nm]), kind(nm))
                  for nm in names)
    tc_pairs = [[] for _ in names]
    simt_items = []
    nsub = b // simt_tile(dtype, b)
    routes = dict.fromkeys(ROUTES, 0)
    for i in range(nt):
        for j in range(i + 1):
            nm = pair_names[i][j]
            s = names.index(nm)
            r = route(nm, dtype, b)
            routes[r] += 1
            if r == "tc":
                tc_pairs[s].append((i, j))
            elif rounding and scaled(nm, quant_by[nm]):
                simt_items.append((i, j, s, slots[s][2], SUB_ALL))
            else:
                simt_items.extend((i, j, s, slots[s][2], k)
                                  for k in range(nsub * nsub))
    return Plan(slots, tuple(tuple(p) for p in tc_pairs), tuple(simt_items),
                routes)


@functools.lru_cache(maxsize=1024)
def _tables(pair_names, pair_quants, store_names, store_quants, dtype, b,
            rounding, in_place, device):
    """One panel's plan, its device tables and the host arrays its
    launcher reads."""
    p = plan(pair_names, pair_quants, dtype, b, rounding, in_place)
    ns = len(p.slots)
    store = [rcode(nm, q) for nm, q in zip(store_names, store_quants)]
    codes = [s[2] for s in p.slots]
    kinds = [s[3] for s in p.slots]
    tc = [(i << 16) | j for pairs in p.tc_pairs for (i, j) in pairs]
    off = [0]
    for pairs in p.tc_pairs:
        off.append(off[-1] + len(pairs))
    simt = [v for (i, j, s, rc, sub) in p.simt_items
            for v in ((i << 16) | j, (s << 16) | (rc << 8) | sub)]

    def dev(xs):
        return torch.tensor(xs or [0], dtype=torch.int32, device=device)

    def host(xs):
        return (ctypes.c_int * len(xs))(*xs)
    return p, (dev(store), dev(codes), dev(kinds), dev(tc), dev(simt),
               host(codes), host(kinds), host(off), ns, len(p.simt_items))


def launch(linv, a21, c, *, store_names, store_quants, pair_names,
           pair_quants, rounding=True):
    """One panel on the card (2-D operands), or panel p of N matrices
    (3-D: (N, b, b), (N, m, b), (N, m, m)); returns ``((a21, c), pairs by
    route)``, the pairs of one matrix."""
    batched = a21.dim() == 3
    nbatch = a21.shape[0] if batched else 1
    if batched and (linv.dim() != 3 or c.dim() != 3 or nbatch == 0
                    or linv.shape[0] != nbatch or c.shape[0] != nbatch):
        raise ValueError(f"panel_update: batch shapes linv "
                         f"{tuple(linv.shape)}, a21 {tuple(a21.shape)}, c "
                         f"{tuple(c.shape)}")
    m, b = a21.shape[-2:]
    nt = m // b
    dev = a21.device
    if dev.type != "cuda" or linv.device != dev or c.device != dev:
        raise ValueError("panel_update: needs CUDA tensors on one device")
    if a21.dtype not in _SUFFIX or linv.dtype != a21.dtype \
            or c.dtype != a21.dtype:
        raise TypeError(f"panel_update: f32 or f64 containers, got "
                        f"{linv.dtype}, {a21.dtype}, {c.dtype}")
    if (linv.shape[-2:] != (b, b) or c.shape[-2:] != (m, m) or m % b
            or b % 64 or len(store_names) != nt or len(pair_names) != nt):
        raise ValueError(f"panel_update: shapes linv {tuple(linv.shape)}, "
                         f"a21 {tuple(a21.shape)}, c {tuple(c.shape)}")
    if any(t.stride(-1) != 1 for t in (linv, a21, c)):
        raise ValueError("panel_update: operands need unit column stride")
    esz = a21.element_size()
    in_place = (a21.data_ptr() % 16 == 0 and a21.stride(-2) * esz % 16 == 0
                and (not batched or a21.stride(0) * esz % 16 == 0))
    p, (store_tab, codes, kinds, tc_items, simt_items, codes_h, kinds_h,
        tc_off, ns, nsimt) = _tables(
        tuple(pair_names), tuple(pair_quants), tuple(store_names),
        tuple(store_quants), a21.dtype, b, bool(rounding), in_place, dev)
    # the solve reads L11^-1 K-major by 16-byte loads
    if (linv.stride(-2) != b or linv.data_ptr() % 16
            or (batched and linv.stride(0) != b * b)):
        linv = linv.clone(memory_format=torch.contiguous_format)
    # scratch: the rounded incoming panel, one L21 copy per pair name
    # (codes of the name's type for the tensor cores, container values for
    # the CUDA cores; a "self" slot stays unused) and the copies'
    # per-row-tile scales, m b values and nt scales a matrix
    slot_stride = nbatch * m * b * esz
    a_r = torch.empty((nbatch, m, b), dtype=a21.dtype, device=dev)
    lq = torch.empty((ns * slot_stride,), dtype=torch.uint8, device=dev)
    alpha = torch.empty((ns, nbatch, nt), dtype=torch.float32, device=dev)

    def bs(t):
        return t.stride(0) if batched else 0
    with _build.on_device(dev):
        err = _fn(a21.dtype)(
            linv.data_ptr(), linv.stride(-2), bs(linv), a21.data_ptr(),
            a21.stride(-2), bs(a21), c.data_ptr(), c.stride(-2), bs(c),
            nbatch, a_r.data_ptr(), lq.data_ptr(),
            slot_stride, alpha.data_ptr(), store_tab.data_ptr(),
            codes.data_ptr(), kinds.data_ptr(),
            ctypes.cast(codes_h, ctypes.c_void_p),
            ctypes.cast(kinds_h, ctypes.c_void_p), ns, tc_items.data_ptr(),
            ctypes.cast(tc_off, ctypes.c_void_p), simt_items.data_ptr(),
            nsimt, nt, b, simt_tile(a21.dtype, b), int(bool(rounding)),
            _build.raw_stream(dev))
    _build.check(err, "panel_update")
    return (a21, c), p.routes


def panel_update(linv, a21, c, *, store_names, store_quants, pair_names,
                 pair_quants, rounding=True):
    """:func:`launch` without the route counts: returns ``(a21, c)``."""
    return launch(linv, a21, c, store_names=store_names,
                  store_quants=store_quants, pair_names=pair_names,
                  pair_quants=pair_quants, rounding=rounding)[0]

