"""Nested recursive Cholesky (paper Algs. 1-3) with layered precision,
in torch.

Counterpart of ``repro/core/tree.py``: the same recursion, the same
``cfg.split`` bisection and the same precision rule. Every tree node at
recursion ``level`` computes its GEMM in ``cfg.levels[min(level, -1)]``,
every recursive call increments ``level``, leaves use the node's level
dtype; narrow dtypes get the paper's per-block quantization around each
GEMM, with the dequantization scale applied in the ``qgemm`` epilogue,
and ``storage_rounding`` rounds each updated block to its level's storage
grid, as if it lived in a low-precision tree node.

The reference unrolls the recursion at trace time and concatenates new
arrays at every node. Here each public routine makes ONE working copy of
its input at entry and the recursion writes into views of it (panels,
diagonal blocks, leaves), so a factor at n holds the input, one n x n
working buffer and per-node temporaries no larger than the node's panel:
``chip_smoke.py`` reports the peak. Each view receives the values the
reference's node would return, and what the reference zeroes (the upper
blocks a node's concatenation fills with zeros) is zeroed before the
result is returned. The per-block scales stay 0-d tensors on the
operands' device and go to the kernels as such, so no node waits for the
card.

``tree_trsm_left`` also takes a stack of N independent systems, ``b``
(N, n, k) and ``l`` (N, n, n), the reference's function under
``jax.vmap`` (K-FAC's whitening): every node's GEMM is one batched
``qgemm`` and every leaf one batched ``tri_inv_leaf`` and ``qgemm``, with
each system's quantization scales and storage roundings its own
(``quantize.quant_block`` of a 3-D stack). ``tree_potrf`` takes a stack
whose blocks are at most one leaf (one batched ``potrf_leaf``) and
refuses a stack of larger blocks: the recursion's right solves and SYRKs
have no batched form yet (ROADMAP C), and one recursion a matrix would
cost thousands of launches a K-FAC refactor.

The padding helpers (``pad_spd``, ``pad_factor``) are shared with the
blocked engine and the solve entry points.
"""
from __future__ import annotations

import torch

from repro_torch.core.precision import PrecisionConfig
from repro_torch.core.quantize import quant_block, storage_round
from repro_torch.kernels import ops


def _round_to(x, name: str, cfg: PrecisionConfig):
    """Round ``x`` to the level's storage grid, keep its dtype (the
    identity, ``x`` itself, when storage rounding is off or the grid is
    the container's). A 3-D ``x`` is a stack of blocks, each on its own
    scale."""
    if not cfg.storage_rounding:
        return x
    return storage_round(x, name, cfg.quantize)


def _round_into(view, name: str, cfg: PrecisionConfig) -> None:
    """:func:`_round_to` written back into ``view``."""
    r = _round_to(view, name, cfg)
    if r is not view:
        view.copy_(r)


def _work(x):
    """The one working copy a public routine makes of its input."""
    return x.clone(memory_format=torch.contiguous_format)


def _sym_from_lower(a):
    return torch.tril(a) + torch.tril(a, -1).transpose(-1, -2)


# ---------------------------------------------------------------------------
# the recursion, in place on views of a working buffer
# ---------------------------------------------------------------------------
def _potrf_into(w, cfg: PrecisionConfig, level: int) -> None:
    """Alg. 1 on the lower triangle of ``w``: its lower blocks become L;
    the strict upper blocks off the diagonal leaves are left stale."""
    n = w.shape[-1]
    if n <= cfg.leaf:
        name = cfg.name_at(level)
        leaf = _round_to(_sym_from_lower(w), name, cfg)
        out = ops.potrf(leaf.to(cfg.high_dtype))
        w.copy_(_round_to(out.to(w.dtype), name, cfg))
        return
    n1 = cfg.split(n)
    _potrf_into(w[:n1, :n1], cfg, level + 1)
    _trsm_into(w[n1:, :n1], w[:n1, :n1], cfg, level)
    _syrk_into(w[n1:, n1:], w[n1:, :n1], -1.0, 1.0, cfg, level)
    _potrf_into(w[n1:, n1:], cfg, level + 1)


def _trsm_into(x, l, cfg: PrecisionConfig, level: int) -> None:
    """Alg. 2: ``x <- x L^-T``, splitting the triangle dimension."""
    n = x.shape[1]
    name = cfg.name_at(level)
    if n <= cfg.leaf:
        high = cfg.high_dtype
        r = ops.trsm(_round_to(x, name, cfg).to(high), l.to(high),
                     side="right", trans=True)
        x.copy_(_round_to(r.to(x.dtype), name, cfg))
        return
    n1 = cfg.split(n)
    _trsm_into(x[:, :n1], l[:n1, :n1], cfg, level + 1)
    # B2 <- B2 - B1 L21^T  (the exposed GEMM, low precision + quantization)
    q = cfg.needs_quant(level)
    b1q, s1 = quant_block(x[:, :n1], name, q)
    l21q, s2 = quant_block(l[n1:, :n1], name, q)
    b2 = x[:, n1:]
    ops.qgemm(b1q, l21q, -(s1 * s2), c=b2, beta=1.0, trans_b=True,
              out_dtype=x.dtype, out=b2)
    _round_into(b2, name, cfg)
    _trsm_into(b2, l[n1:, n1:], cfg, level + 1)


def _syrk_into(c, a, alpha, beta, cfg: PrecisionConfig, level: int) -> None:
    """Alg. 3: lower blocks of ``c <- beta c + alpha a a^T``; a diagonal
    leaf keeps (and rounds) its strict upper triangle, as the reference's
    leaf does; the upper blocks off the diagonal leaves are not written."""
    n = c.shape[-1]
    name = cfg.name_at(level)
    q = cfg.needs_quant(level)
    if n <= cfg.leaf:
        aq, s = quant_block(_round_to(a, name, cfg), name, q)
        ops.syrk(c, aq, alpha * s * s, beta, out=c)
        _round_into(c, name, cfg)
        return
    n1 = cfg.split(n)
    _syrk_into(c[:n1, :n1], a[:n1], alpha, beta, cfg, level + 1)
    # C21 <- beta C21 + alpha A2 A1^T  (the exposed GEMM)
    a2q, s2 = quant_block(a[n1:], name, q)
    a1q, s1 = quant_block(a[:n1], name, q)
    c21 = c[n1:, :n1]
    ops.qgemm(a2q, a1q, alpha * s1 * s2, c=c21, beta=beta, trans_b=True,
              out_dtype=c.dtype, out=c21)
    _round_into(c21, name, cfg)
    _syrk_into(c[n1:, n1:], a[n1:], alpha, beta, cfg, level + 1)


def _trsm_left_into(x, l, cfg: PrecisionConfig, trans: bool,
                    level: int) -> None:
    """The solve sweeps: ``x <- L^-1 x`` or, with ``trans``,
    ``x <- L^-T x``; a 3-D ``x`` and ``l`` are N systems at once."""
    n = x.shape[-2]
    name = cfg.name_at(level)
    if n <= cfg.leaf:
        high = cfg.high_dtype
        xh, lh = _round_to(x, name, cfg).to(high), l.to(high)
        r = ops.trsm(xh, lh, side="left", trans=trans)
        x.copy_(_round_to(r.to(x.dtype), name, cfg))
        return
    n1 = cfg.split(n)
    l11, l21, l22 = l[..., :n1, :n1], l[..., n1:, :n1], l[..., n1:, n1:]
    q = cfg.needs_quant(level)
    if not trans:
        # y1 = L11^{-1} B1 ; B2 -= L21 y1 ; y2 = L22^{-1} B2
        _trsm_left_into(x[..., :n1, :], l11, cfg, False, level + 1)
        lq, s1 = quant_block(l21, name, q)
        yq, s2 = quant_block(x[..., :n1, :], name, q)
        rest, nxt = x[..., n1:, :], l22
    else:
        # x2 = L22^{-T} B2 ; B1 -= L21^T x2 ; x1 = L11^{-T} B1
        _trsm_left_into(x[..., n1:, :], l22, cfg, True, level + 1)
        lq, s1 = quant_block(l21.transpose(-1, -2), name, q)
        yq, s2 = quant_block(x[..., n1:, :], name, q)
        rest, nxt = x[..., :n1, :], l11
    ops.qgemm(lq, yq, -(s1 * s2), c=rest, beta=1.0, out_dtype=x.dtype,
              out=rest)
    _round_into(rest, name, cfg)
    _trsm_left_into(rest, nxt, cfg, trans, level + 1)


def _zero_upper_blocks(c, cfg: PrecisionConfig) -> None:
    """Zero the blocks above each node's split, as the reference's
    concatenations do (diagonal leaves keep their upper triangles)."""
    n = c.shape[-1]
    if n <= cfg.leaf:
        return
    n1 = cfg.split(n)
    c[:n1, n1:] = 0
    _zero_upper_blocks(c[:n1, :n1], cfg)
    _zero_upper_blocks(c[n1:, n1:], cfg)


# ---------------------------------------------------------------------------
# public routines (the reference's signatures)
# ---------------------------------------------------------------------------
def tree_potrf(a, cfg: PrecisionConfig, *, level: int = 0):
    """Lower Cholesky factor of SPD ``a`` (paper Alg. 1). Reads the lower
    triangle only; returns a new L with a zeroed upper triangle.
    ``a.shape[-1]`` must be a multiple of ``cfg.leaf`` (use
    :func:`pad_spd` otherwise). A stack (N, n, n) of blocks of at most
    one leaf gives the N factors in one batched launch."""
    n = a.shape[-1]
    assert a.dim() in (2, 3) and a.shape[-2:] == (n, n), a.shape
    if a.dim() == 3 and n > cfg.leaf:
        raise NotImplementedError(
            f"tree_potrf of a stack of ({n} x {n}) blocks, larger than the "
            f"leaf {cfg.leaf}: the batched recursion is ROADMAP C's open "
            "item; factor such stacks with blocked_potrf")
    w = _work(a)
    _potrf_into(w, cfg, level)
    return w.tril_()


def tree_trsm(b, l, cfg: PrecisionConfig, *, level: int = 0):
    """X = B L^{-T} (right, lower, transposed; paper Alg. 2). ``b``:
    (m, n) panel, ``l``: (n, n) lower-triangular; the recursion splits n
    and the m rows stream through the leaf kernel."""
    m, n = b.shape
    assert l.shape == (n, n), (b.shape, l.shape)
    x = _work(b)
    _trsm_into(x, l, cfg, level)
    return x


def tree_syrk(c, a, *, alpha=1.0, beta=1.0, cfg: PrecisionConfig,
              level: int = 0):
    """C <- beta C + alpha A A^T on the lower triangle (paper Alg. 3).
    ``c``: (n, n), ``a``: (n, k). The blocks above each split come back
    zero, the diagonal leaves' upper triangles as the leaf kernel leaves
    them, as in the reference."""
    n = c.shape[-1]
    assert c.shape == (n, n) and a.shape[0] == n, (c.shape, a.shape)
    out = _work(c)
    _syrk_into(out, a, alpha, beta, cfg, level)
    _zero_upper_blocks(out, cfg)
    return out


def tree_trsm_left(b, l, cfg: PrecisionConfig, *, trans: bool,
                   level: int = 0):
    """Left-side solves of cholesky_solve:

    trans=False : X = L^{-1} B      (forward substitution)
    trans=True  : X = L^{-T} B      (back substitution)

    ``b`` (N, n, k) and ``l`` (N, n, n): N systems, batched launches.
    """
    n = b.shape[-2]
    assert b.dim() in (2, 3) and l.shape == (*b.shape[:-2], n, n), (
        b.shape, l.shape)
    x = _work(b)
    _trsm_left_into(x, l, cfg, trans, level)
    return x


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
