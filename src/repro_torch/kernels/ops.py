"""Kernel dispatch by device, with one launch counter per kernel.

Counterpart of ``repro/kernels/ops.py`` for the factor, solve and
refinement path of both engines, and of the model zoo's prefill attention
(``flash_attention``; the reference's models call its oracle, the scan in
``repro/models/attention.py``, where the port calls the kernel).
The dispatch rule has no switch: a tensor on the CPU runs the plain
version in :mod:`repro_torch.kernels.ref`; a tensor on a CUDA device
launches the hand-written kernel, for f32 and f64 alike (the card has
f64 units, so unlike the reference nothing is routed to the plain
version by dtype). Any other device raises, and so does a dtype or a
layout the kernel does not take. There is no fallback.

``LAUNCHES`` counts the kernel launches of each wrapper: one call that
launches a kernel adds one (``panel_update`` and a split ``syrk_leaf``
add one per call although they run several CUDA kernels; ``trsm``
without ``linv`` adds one ``tri_inv_leaf`` and one ``trsm_leaf`` or
``qgemm``; ``tri_inv_batched`` adds one ``tri_inv_leaf`` for its whole
stack). ``TILES`` counts the tiles those ``tri_inv_leaf`` launches
inverted. Calls that run the plain version on the CPU add nothing.
``flash_attention`` counts both of its routes as one kernel;
``FLASH_ROUTES`` splits the same launches by ``flash.route`` of the
operands' dtype: ``flash_tc`` (bf16 and f16, the tensor-core kernel) and
``flash_simt`` (f32). ``QGEMM_ROUTES`` splits the ``qgemm`` launches by
the route :func:`repro_torch.kernels.qgemm.plan` took (``tc``,
``tc_staged``, ``simt_ksplit``, ``simt_tile``, ``simt_narrow``).
``PANEL_ROUTES`` counts the lower tile pairs that ``panel_update``
launches updated, by the route :func:`repro_torch.kernels.panel.route`
gave each (``tc``: f16, bf16 and int8 pairs on the tensor cores;
``simt``: the rest on the CUDA cores). ``SYRK_PACKED_ROUTES`` splits the
``syrk_packed`` launches by :func:`repro_torch.kernels.syrk.packed_plan`
(``tc`` and ``tc_staged``: bf16, f16 and int8 A on the tensor cores;
``simt``: f32 and f64), ``TRSM_ROUTES`` the ``trsm_leaf`` launches by
:func:`repro_torch.kernels.trsm.plan` (``simt_wide``, ``simt_mid``,
``simt_ksplit``).

``potrf``, ``tri_inv``, ``qgemm``, ``panel_update`` and the left forms of
``trsm`` also take a stack of N matrices of one shape at a uniform batch
stride (3-D operands), the reference's kernels under ``jax.vmap``
(K-FAC's refactor and whitening), and launch once over the batch; so does
``tri_inv_batched`` (a stack of tiles, such as the diagonal tiles of one
factor). ``BATCHED`` counts those launches by kernel; they are part of
``LAUNCHES`` too (``LAUNCHES[k] - BATCHED[k]`` launches took one matrix).
The right form of ``trsm`` and ``syrk`` take a stack too (the tree
recursion's leaves on a stack): their kernels take one matrix, so on the
card a stack costs one launch a matrix, each counted in ``LAUNCHES`` as a
launch of one matrix (the right ``trsm`` first inverts the N leaves in
one batched ``tri_inv_leaf``); each matrix's result is bitwise what the
2-D call on that matrix gives.
Their routes go to the route counts as above, the pairs of all N matrices
to ``PANEL_ROUTES``, and ``TILES`` counts the tiles of every
``potrf_leaf`` and ``tri_inv_leaf`` launch.

A scale or beta may be a 0-d f32 tensor on the operands' device (the
per-block quantization scales of the tree engine): the kernels read it
from device memory, so no call waits for the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash as _flash
from repro_torch.kernels import panel as _panel
from repro_torch.kernels import potrf as _potrf
from repro_torch.kernels import qgemm as _qgemm
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import residual as _residual
from repro_torch.kernels import syrk as _syrk
from repro_torch.kernels import trsm as _trsm

LAUNCHES = {"potrf_leaf": 0, "tri_inv_leaf": 0, "qgemm": 0,
            "panel_update": 0, "residual_fused": 0, "trsm_leaf": 0,
            "syrk_leaf": 0, "syrk_packed": 0, "flash_attention": 0}
FLASH_ROUTES = {"flash_tc": 0, "flash_simt": 0}
QGEMM_ROUTES = dict.fromkeys(_qgemm.ROUTES, 0)
PANEL_ROUTES = dict.fromkeys(_panel.ROUTES, 0)
SYRK_PACKED_ROUTES = dict.fromkeys(_syrk.PACKED_ROUTES, 0)
TRSM_ROUTES = dict.fromkeys(_trsm.ROUTES, 0)
TILES = {"potrf_leaf": 0, "tri_inv_leaf": 0}
BATCHED = {"potrf_leaf": 0, "tri_inv_leaf": 0, "qgemm": 0,
           "panel_update": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, FLASH_ROUTES, QGEMM_ROUTES, PANEL_ROUTES,
                   SYRK_PACKED_ROUTES, TRSM_ROUTES, TILES, BATCHED):
        for k in counts:
            counts[k] = 0


def _on_card(*xs) -> bool:
    """True for CUDA tensors, False for CPU tensors; raise otherwise.
    Arguments that are not tensors (None, a float scale) are ignored."""
    kinds = {x.device.type for x in xs if torch.is_tensor(x)}
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
    """Lower Cholesky factor of one SPD leaf tile (NaN if not SPD), or the
    factors of a (N, b, b) stack (read in place through its strides; no
    ``out``): one launch of ``potrf_leaf`` on the card either way."""
    if _on_card(a, out):
        LAUNCHES["potrf_leaf"] += 1
        if a.dim() == 3:
            BATCHED["potrf_leaf"] += 1
            TILES["potrf_leaf"] += a.shape[0]
            return _potrf.potrf_leaf_batched(a)
        TILES["potrf_leaf"] += 1
        return _potrf.potrf_leaf(a, out=out)
    if a.dim() == 3:
        return _ref.potrf_batched_ref(a)
    return _store(_ref.potrf_ref(a), out)


def tri_inv(l, *, out=None):
    """Inverse of a lower-triangular leaf tile, or of each tile of a
    (T, b, b) stack (:func:`tri_inv_batched`; no ``out``)."""
    if l.dim() == 3:
        return tri_inv_batched(l)
    if _on_card(l, out):
        LAUNCHES["tri_inv_leaf"] += 1
        TILES["tri_inv_leaf"] += 1
        return _potrf.tri_inv_leaf(l, out=out)
    return _store(_ref.tri_inv_ref(l), out)


def tri_inv_batched(tiles):
    """Inverses of a (T, b, b) stack of lower-triangular tiles (a strided
    view such as ``kernels.potrf.diag_tiles`` of a factor is read in place):
    one launch of ``tri_inv_leaf`` on the card, one plain inverse a tile
    on the CPU."""
    if _on_card(tiles):
        LAUNCHES["tri_inv_leaf"] += 1
        BATCHED["tri_inv_leaf"] += 1
        TILES["tri_inv_leaf"] += tiles.shape[0]
        return _potrf.tri_inv_leaf_batched(tiles)
    return _ref.tri_inv_batched_ref(tiles)


def qgemm(a, b, scale=1.0, *, c=None, beta=0.0, trans_b=False,
          out_dtype=torch.float32, out=None):
    """``scale * (a @ b[.T]) + beta * c`` with wide accumulation. ``out``
    may be the very tensor ``c`` (an in-place update), never ``a``/``b``.
    3-D operands are N products of one shape, ``a`` (N, M, K), ``b``
    (N, K, N') (or (N, N', K) with ``trans_b``), ``c``/``out`` (N, M, N'),
    in one launch; ``scale`` may then also be an (N,) f32 tensor, one a
    matrix."""
    if _on_card(a, b, c, out, scale):
        res, plan = _qgemm.launch(a, b, scale, c=c, beta=beta,
                                  trans_b=trans_b, out_dtype=out_dtype,
                                  out=out)
        LAUNCHES["qgemm"] += 1
        BATCHED["qgemm"] += a.dim() == 3
        QGEMM_ROUTES[plan.route] += 1
        return res
    ref = _ref.qgemm_batched_ref if a.dim() == 3 else _ref.qgemm_ref
    return _store(ref(a, b, trans_b=trans_b, scale=scale, c=c, beta=beta,
                      out_dtype=out_dtype), out)


def trsm(b, l, *, side="right", trans=True, linv=None):
    """Leaf triangular solve against lower-triangular ``l``:
    ``B L^-T`` (right, trans), ``L^-1 B`` (left) or ``L^-T B`` (left,
    trans), as ``repro/kernels/ops.py:trsm`` dispatches it. On the card
    the leaf is inverted (``tri_inv_leaf``) unless ``linv`` is given, and
    the solve is a product with the inverse: ``trsm_leaf`` for the right
    form, ``qgemm`` for the left ones. On the CPU without ``linv`` it is
    a triangular solve (:func:`~repro_torch.kernels.ref.trsm_ref`). The
    left forms also take N systems, ``b`` (N, n, k) and ``l`` (N, n, n):
    one batched ``tri_inv_leaf`` and one batched ``qgemm``; the right form
    takes N systems as one batched ``tri_inv_leaf`` and a ``trsm_leaf``
    a system."""
    card = _on_card(b, l, linv)
    if side == "right" and b.dim() == 3:
        if card and linv is None:
            linv = tri_inv_batched(l)
        return torch.stack([
            trsm(b[i], l[i], side=side, trans=trans,
                 linv=None if linv is None else linv[i])
            for i in range(b.shape[0])])
    if not card and linv is None:
        if b.dim() == 3:
            return _ref.trsm_batched_ref(b, l, side=side, trans=trans)
        return _ref.trsm_ref(b, l, side=side, trans=trans)
    if side == "right" and trans:
        if not card:
            return _ref.qgemm_ref(b, linv, trans_b=True, out_dtype=b.dtype)
        if linv is None:
            linv = tri_inv(l)
        res, plan = _trsm.launch(b, linv)
        LAUNCHES["trsm_leaf"] += 1
        TRSM_ROUTES[plan.route] += 1
        return res
    if side != "left":
        raise NotImplementedError(f"trsm side={side} trans={trans}")
    if linv is None:
        linv = tri_inv(l)
    return qgemm((linv.mT if trans else linv).to(b.dtype), b,
                 out_dtype=b.dtype)


def syrk(c, a, scale=1.0, beta=1.0, *, packed=False, out=None):
    """Lower triangle of ``beta c + scale a a^T``, ``c``'s strict upper
    triangle kept: ``syrk_leaf`` (k split across thread blocks) or, with
    ``packed``, ``syrk_packed`` (one pass, any n). ``out`` may be ``c``
    itself for an in-place update. A stack, ``c`` (N, n, n) and ``a``
    (N, n, k), is one call a matrix (``scale`` a float, a 0-d or an (N,)
    tensor)."""
    if c.dim() == 3:
        dst = torch.empty_like(c) if out is None else out
        for i in range(c.shape[0]):
            syrk(c[i], a[i], _ref._per_matrix(scale, i), beta,
                 packed=packed, out=dst[i])
        return dst
    if _on_card(c, a, out, scale, beta):
        if not packed:
            LAUNCHES["syrk_leaf"] += 1
            return _syrk.syrk_leaf(c, a, scale, beta, out=out)
        res, plan = _syrk.packed_launch(c, a, scale, beta, out=out)
        LAUNCHES["syrk_packed"] += 1
        SYRK_PACKED_ROUTES[plan.route] += 1
        return res
    return _store(_ref.syrk_ref(c, a, alpha=1.0, beta=beta, scale=scale),
                  out)


def residual(a, x, b):
    """Fused refinement residual ``r = b - a @ x`` (``x``/``b`` (n,) or
    (n, k)), in ``b``'s dtype; f64 runs the kernel's f64 instance on the
    card where the reference routes it to its oracle."""
    if _on_card(a, x, b):
        LAUNCHES["residual_fused"] += 1
        return _residual.residual_fused(a, x, b)
    return _ref.residual_ref(a, x, b)


def panel_update(linv, a21, c, *, store_names, store_quants, pair_names,
                 pair_quants, rounding=True):
    """Fused panel TRSM + trailing update, IN PLACE: ``a21`` is
    overwritten with ``L21 = A21 @ L11^-T`` and the lower tiles of ``c``
    with ``C - L21 L21^T`` at the plan's per-tile precisions; the strict
    upper triangle of ``c`` is left as it was. Returns ``(a21, c)``.
    3-D operands, ``linv`` (N, b, b), ``a21`` (N, m, b), ``c`` (N, m, m),
    are panel p of N matrices of one geometry, in one launch.

    (The reference returns new arrays; the blocked engine here updates
    its one working buffer instead.)
    """
    kw = dict(store_names=store_names, store_quants=store_quants,
              pair_names=pair_names, pair_quants=pair_quants,
              rounding=rounding)
    nbatch = a21.shape[0] if a21.dim() == 3 else 1
    if _on_card(linv, a21, c):
        res, routes = _panel.launch(linv, a21, c, **kw)
        LAUNCHES["panel_update"] += 1
        BATCHED["panel_update"] += a21.dim() == 3
        for k, v in routes.items():
            PANEL_ROUTES[k] += v * nbatch
        return res
    ref = (_ref.panel_update_batched_ref if a21.dim() == 3
           else _ref.panel_update_ref)
    l21, cu = ref(linv, a21, c, **kw)
    a21.copy_(l21)
    c.copy_(cu)
    return a21, c


def flash_attention(q, k, v, *, causal=True, bq=_ref.FLASH_BQ,
                    bk=_ref.FLASH_BK):
    """Causal (or full) GQA attention, q [H, S, hd], k/v [KV, T, hd] ->
    [H, S, hd] (``repro/kernels/flash.py:flash_attention``):
    :func:`flash_attention_bshd` on views with B = 1."""
    out = flash_attention_bshd(q.transpose(0, 1)[None],
                               k.transpose(0, 1)[None],
                               v.transpose(0, 1)[None], causal=causal,
                               bq=bq, bk=bk)
    return out[0].transpose(0, 1)


def flash_attention_bshd(q, k, v, *, causal=True, bq=_ref.FLASH_BQ,
                         bk=_ref.FLASH_BK):
    """The batched form, q [B, S, H, hd], k/v [B, T, KV, hd] ->
    [B, S, H, hd]: one launch over B * H on the card. ``bq``/``bk`` set
    the plain version's blocks; the kernel walks its own."""
    if _on_card(q, k, v):
        out = _flash.flash_attention_bshd(q, k, v, causal=causal, bk=bk)
        LAUNCHES["flash_attention"] += 1
        FLASH_ROUTES[_flash.route(q.dtype)] += 1
        return out
    return _ref.flash_ref(q, k, v, causal=causal, bq=bq, bk=bk)
