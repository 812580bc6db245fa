"""Kernel dispatch by device, with one launch counter per kernel.

Counterpart of ``repro/kernels/ops.py`` for the factor and solve path.
The dispatch rule has no switch: a tensor on the CPU runs the plain
version in :mod:`repro_torch.kernels.ref`; a tensor on a CUDA device
launches the hand-written kernel, for f32 and f64 alike (the card has
f64 units, so unlike the reference nothing is routed to the plain
version by dtype). Any other device raises, and so does a dtype or a
layout the kernel does not take. There is no fallback.

``LAUNCHES`` counts the kernel launches of each wrapper: one call that
launches a kernel adds one (``panel_update`` adds one per call although
it runs several CUDA kernels). Calls that run the plain version on the
CPU add nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import panel as _panel
from repro_torch.kernels import potrf as _potrf
from repro_torch.kernels import qgemm as _qgemm
from repro_torch.kernels import ref as _ref

LAUNCHES = {"potrf_leaf": 0, "tri_inv_leaf": 0, "qgemm": 0,
            "panel_update": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_card(*xs) -> bool:
    """True for CUDA tensors, False for CPU tensors; raise otherwise."""
    kinds = {x.device.type for x in xs if x is not None}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"tensors on {sorted(kinds)}: the port runs on one "
                     "CUDA device or on the CPU")


def _store(res, out):
    if out is None:
        return res
    out.copy_(res)
    return out


def potrf(a, *, out=None):
    """Lower Cholesky factor of one SPD leaf tile (NaN if not SPD)."""
    if _on_card(a, out):
        LAUNCHES["potrf_leaf"] += 1
        return _potrf.potrf_leaf(a, out=out)
    return _store(_ref.potrf_ref(a), out)


def tri_inv(l, *, out=None):
    """Inverse of a lower-triangular leaf tile."""
    if _on_card(l, out):
        LAUNCHES["tri_inv_leaf"] += 1
        return _potrf.tri_inv_leaf(l, out=out)
    return _store(_ref.tri_inv_ref(l), out)


def qgemm(a, b, scale=1.0, *, c=None, beta=0.0, trans_b=False,
          out_dtype=torch.float32, out=None):
    """``scale * (a @ b[.T]) + beta * c`` with wide accumulation. ``out``
    may be the very tensor ``c`` (an in-place update), never ``a``/``b``."""
    if _on_card(a, b, c, out):
        LAUNCHES["qgemm"] += 1
        return _qgemm.qgemm(a, b, scale, c=c, beta=beta, trans_b=trans_b,
                            out_dtype=out_dtype, out=out)
    return _store(_ref.qgemm_ref(a, b, trans_b=trans_b, scale=scale, c=c,
                                 beta=beta, out_dtype=out_dtype), out)


def panel_update(linv, a21, c, *, store_names, store_quants, pair_names,
                 pair_quants, rounding=True):
    """Fused panel TRSM + trailing update, IN PLACE: ``a21`` is
    overwritten with ``L21 = A21 @ L11^-T`` and the lower tiles of ``c``
    with ``C - L21 L21^T`` at the plan's per-tile precisions; the strict
    upper triangle of ``c`` is left as it was. Returns ``(a21, c)``.

    (The reference returns new arrays; the blocked engine here updates
    its one working buffer instead.)
    """
    kw = dict(store_names=store_names, store_quants=store_quants,
              pair_names=pair_names, pair_quants=pair_quants,
              rounding=rounding)
    if _on_card(linv, a21, c):
        LAUNCHES["panel_update"] += 1
        return _panel.panel_update(linv, a21, c, **kw)
    l21, cu = _ref.panel_update_ref(linv, a21, c, **kw)
    a21.copy_(l21)
    c.copy_(cu)
    return a21, c
