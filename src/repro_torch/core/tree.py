"""Padding and symmetrization helpers of the reference's ``core/tree.py``.

Only the helpers the blocked engine and the solve entry points use are
ported here; the nested recursion itself (``tree_potrf``, ``tree_trsm``,
``tree_syrk``, ``tree_trsm_left``) is ROADMAP A7.
"""
from __future__ import annotations

import torch


def _sym_from_lower(a):
    return torch.tril(a) + torch.tril(a, -1).T


def _tail_scale(diag_vals):
    """Power-of-two scale matching the matrix's diagonal magnitude.

    The padding tail sits at the diagonal's magnitude so that per-block
    int8/f16 storage rounding cannot flush it to zero. A power of two is
    exactly representable, so :func:`pad_spd` (from the diagonal) and
    :func:`pad_factor` (from the factor's row norms) recover the very same
    value. ``2**e`` is assembled from its exponent bits: that is
    ``ldexp(1, e)`` exactly, on every device (``torch.ldexp`` multiplies by
    ``pow(2, e)``, whose exactness would rest on the device's ``pow``; the
    reference avoids ``exp2`` for the same reason).
    """
    m = torch.clamp_min(diag_vals.to(torch.float32).mean(), 1e-30)
    e = torch.round(torch.log2(m)).to(torch.int32).clamp(-126, 127)
    return ((e + 127) << 23).view(torch.float32)


def _pad_diag_tail(a, npad: int, tail):
    """Embed ``a`` in an ``npad x npad`` zero matrix whose diagonal tail is
    ``tail`` — the shared body of :func:`pad_spd` / :func:`pad_factor`."""
    n = a.shape[-1]
    out = torch.zeros((npad, npad), dtype=a.dtype, device=a.device)
    out[:n, :n] = a
    idx = torch.arange(n, npad, device=a.device)
    out[idx, idx] = tail.to(a.dtype)
    return out


def pad_spd(a, leaf: int):
    """Pad an SPD matrix to a multiple of ``leaf`` with a diagonal tail at
    the matrix's (power-of-two) diagonal magnitude. Returns ``(a_p, n)``."""
    n = a.shape[-1]
    npad = -(-n // leaf) * leaf
    if npad == n:
        return a, n
    return _pad_diag_tail(a, npad, _tail_scale(torch.diagonal(a))), n


def pad_factor(l, leaf: int):
    """Pad a Cholesky factor the way :func:`pad_spd` pads the matrix, so
    that ``pad_factor(cholesky(a)) == cholesky(pad_spd(a))`` exactly."""
    n = l.shape[-1]
    npad = -(-n // leaf) * leaf
    if npad == n:
        return l
    tail = torch.sqrt(_tail_scale((l.to(torch.float32) ** 2).sum(dim=1)))
    return _pad_diag_tail(l, npad, tail)
