"""Flat blocked mixed-precision Cholesky executor, in torch.

Counterpart of ``repro/core/blocked.py``: the same right-looking schedule
over leaf panels, driven by the same static plan::

    for each leaf panel p:
        L[p,p]   <- potrf leaf at the plan's diagonal level
        L[:, p]  <- fused panel update: L21 = A21 L11^-T and the trailing
                    A22 -= L21 L21^T, every tile rounded at the precision
                    the plan assigns it

The reference is functional and carries a shrinking trailing matrix. Here
:func:`blocked_potrf` makes ONE working copy of ``a`` at entry and works
in place on it: each panel update overwrites its block column with L21
and the trailing lower tiles with their update, and the finished factor
is that same buffer with its upper triangle zeroed. Kernels receive
slices of it through their leading dimension, not copies.
"""
from __future__ import annotations

import torch

from repro_torch.core.plan import build_plan
from repro_torch.core.precision import PrecisionConfig
from repro_torch.core.quantize import storage_round
from repro_torch.core.tree import _sym_from_lower
from repro_torch.kernels import ops
from repro_torch.kernels.potrf import diag_tiles


def _round(x, name: str, cfg: PrecisionConfig):
    """Storage rounding at ``name`` (no-op when the config disables it)."""
    if not cfg.storage_rounding:
        return x
    return storage_round(x, name, cfg.quantize)


def blocked_potrf(a, cfg: PrecisionConfig, *, plan=None):
    """Lower Cholesky factor of SPD ``a`` (a torch tensor) via the flat
    tile schedule. Reads the lower triangle only; returns a new tensor L
    with a zeroed upper triangle (``a`` itself is not modified).
    ``a.shape[-1]`` must be a multiple of ``cfg.leaf``; ``plan`` overrides
    the per-tile precision table as in the reference."""
    n = a.shape[-1]
    assert a.shape == (n, n), a.shape
    assert n % cfg.leaf == 0, (n, cfg.leaf)
    if plan is None:
        plan = build_plan(n, cfg)
    assert plan.ntiles == n // cfg.leaf, (plan.ntiles, n, cfg.leaf)
    b, T, high = cfg.leaf, plan.ntiles, cfg.high_dtype
    w = a.clone(memory_format=torch.contiguous_format)
    for p in range(T):
        r0, r1 = p * b, (p + 1) * b
        name_p = plan.name(p, p)
        diag = _round(_sym_from_lower(w[r0:r1, r0:r1]), name_p, cfg)
        lpp = ops.potrf(diag.to(high))
        lpp = _round(lpp.to(w.dtype), name_p, cfg)
        if p < T - 1:
            linv = ops.tri_inv(lpp.to(high))
            meta = plan.panel_meta(p)
            ops.panel_update(
                linv.to(w.dtype), w[r1:, r0:r1], w[r1:, r1:],
                store_names=meta.store_names, store_quants=meta.store_quants,
                pair_names=meta.pair_names, pair_quants=meta.pair_quants,
                rounding=cfg.storage_rounding)
        w[r0:r1, r0:r1] = lpp
        w[:r0, r0:r1] = 0
    return w


def diag_tri_inv(l, cfg: PrecisionConfig):
    """Stacked inverses of the factor's diagonal leaf tiles, shape
    ``(T, leaf, leaf)`` in the ladder's high dtype; computed once per
    factor and reused by both sweeps of every solve. On the card: one
    launch for all T tiles, read in place when ``l`` is already in the high
    dtype (else the T tiles alone are converted)."""
    n = l.shape[-1]
    b = cfg.leaf
    assert n % b == 0, (n, b)
    high = cfg.high_dtype
    if l.stride(-1) != 1:
        l = l.contiguous()
    tiles = diag_tiles(l, b)
    if tiles.dtype != high:
        tiles = tiles.to(high, memory_format=torch.contiguous_format)
    return ops.tri_inv_batched(tiles)


def blocked_trsm_left(bmat, l, cfg: PrecisionConfig, *, trans: bool,
                      linvs=None):
    """Flat left triangular solve against a blocked factor.

    trans=False : X = L^{-1} B   (forward substitution, one GEMM/panel)
    trans=True  : X = L^{-T} B   (back substitution, reversed order)

    ``bmat``: (n, k); ``l``: (n, n) lower-triangular. Runs in the ladder's
    high precision on a working copy of ``bmat``; the GEMMs read ``l``'s
    blocks (transposed in the back sweep) through their strides.
    """
    n, _ = bmat.shape
    assert l.shape == (n, n), (bmat.shape, l.shape)
    b = cfg.leaf
    assert n % b == 0, (n, b)
    T = n // b
    if linvs is None:
        linvs = diag_tri_inv(l, cfg)
    high = cfg.high_dtype
    x = bmat.to(dtype=high, memory_format=torch.contiguous_format,
                copy=True)
    lh = l.to(high)
    if not trans:
        for p in range(T):
            r0, r1 = p * b, (p + 1) * b
            xp = ops.qgemm(linvs[p], x[r0:r1], out_dtype=high)
            x[r0:r1] = xp
            if r1 < n:
                ops.qgemm(lh[r1:, r0:r1], xp, scale=-1.0, c=x[r1:],
                          beta=1.0, out_dtype=high, out=x[r1:])
    else:
        for p in reversed(range(T)):
            r0, r1 = p * b, (p + 1) * b
            xp = ops.qgemm(linvs[p].T, x[r0:r1], out_dtype=high)
            x[r0:r1] = xp
            if r0 > 0:
                ops.qgemm(lh[r0:r1, :r0].T, xp, scale=-1.0, c=x[:r0],
                          beta=1.0, out_dtype=high, out=x[:r0])
    return x.to(bmat.dtype)
