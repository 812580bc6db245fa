"""Wrapper of the fused panel-update CUDA kernels (``csrc/panel.cu``).

Replaces ``repro/kernels/panel.py:panel_update``, the blocked engine's
O(n^3) step: ``L21 = A21 @ L11^-T`` and ``C -= L21 L21^T`` on the lower
tiles, with the plan's per-tile roundings
(:func:`repro_torch.kernels.ref.panel_update_ref` is its plain version).
It works in place on the engine's working buffer: ``a21`` becomes L21,
the lower tiles of ``c`` are updated and its strict upper triangle is
left untouched. Both are read and written through their leading
dimension.

The plan's names reach the kernels as small int32 tables of rounding
codes, ``name | quant << 3``, with the pair's L21 slot in bits 8 and up;
the tables are built once per panel geometry and kept on the device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
#: rounding-name alphabet of csrc/common.cuh
NAME_CODE = {"f64": 0, "f32": 1, "bf16": 2, "f16": 3, "int8": 4}
_FNS: dict = {}
_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGS = (_P, _L, _P, _L, _P, _L, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
         _P)


def _fn(dtype):
    if dtype not in _FNS:
        _FNS[dtype] = _build.function(
            "panel", f"panel_update_{_SUFFIX[dtype]}", _ARGS)
    return _FNS[dtype]


def rcode(name: str, quant: bool) -> int:
    return NAME_CODE[name] | (int(bool(quant)) << 3)


@functools.lru_cache(maxsize=1024)
def _tables(store_names, store_quants, pair_names, pair_quants, device):
    """(store table, pair table, slot codes): the device tables of one
    panel's geometry and the host list of the L21 roundings it needs."""
    quant_by = {nm: q for row_n, row_q in zip(pair_names, pair_quants)
                for nm, q in zip(row_n, row_q)}
    slots = sorted(quant_by)
    store = [rcode(nm, q) for nm, q in zip(store_names, store_quants)]
    pair = [rcode(nm, quant_by[nm]) | (slots.index(nm) << 8)
            for row in pair_names for nm in row]
    slot_codes = (ctypes.c_int * len(slots))(
        *(rcode(nm, quant_by[nm]) for nm in slots))
    return (torch.tensor(store, dtype=torch.int32, device=device),
            torch.tensor(pair, dtype=torch.int32, device=device),
            slot_codes)


def panel_update(linv, a21, c, *, store_names, store_quants, pair_names,
                 pair_quants, rounding=True):
    m, b = a21.shape
    nt = m // b
    dev = a21.device
    if dev.type != "cuda" or linv.device != dev or c.device != dev:
        raise ValueError("panel_update: needs CUDA tensors on one device")
    if a21.dtype not in _SUFFIX or linv.dtype != a21.dtype \
            or c.dtype != a21.dtype:
        raise TypeError(f"panel_update: f32 or f64 containers, got "
                        f"{linv.dtype}, {a21.dtype}, {c.dtype}")
    if (linv.shape != (b, b) or c.shape != (m, m) or m % b or b % 64
            or len(store_names) != nt or len(pair_names) != nt):
        raise ValueError(f"panel_update: shapes linv {tuple(linv.shape)}, "
                         f"a21 {tuple(a21.shape)}, c {tuple(c.shape)}")
    if any(t.stride(1) != 1 for t in (linv, a21, c)):
        raise ValueError("panel_update: operands need unit column stride")
    store_tab, pair_tab, slot_codes = _tables(
        tuple(store_names), tuple(store_quants), tuple(pair_names),
        tuple(pair_quants), dev)
    ns = len(slot_codes)
    # scratch: the rounded incoming panel, one rounded L21 per pair
    # name, and the full (upper half included) update of each diagonal
    # tile, whose absmax sets that tile's scale
    a_r = torch.empty((m, b), dtype=a21.dtype, device=dev)
    lq = torch.empty((ns, m, b), dtype=a21.dtype, device=dev)
    diag = torch.empty((nt, b, b), dtype=a21.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn(a21.dtype)(
            linv.data_ptr(), linv.stride(0), a21.data_ptr(), a21.stride(0),
            c.data_ptr(), c.stride(0), a_r.data_ptr(), lq.data_ptr(),
            diag.data_ptr(), store_tab.data_ptr(), pair_tab.data_ptr(),
            ctypes.cast(slot_codes, ctypes.c_void_p), ns, nt, b,
            int(bool(rounding)), stream)
    _build.check(err, "panel_update")
    return a21, c
