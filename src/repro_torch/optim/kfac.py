"""Tree-Newton: Kronecker-factored preconditioning whose SPD solves run
through the paper's mixed-precision Cholesky, in torch.

Counterpart of ``repro/optim/kfac.py``. Per eligible weight matrix
(``ELIGIBLE``: the attention and MLP projections) the optimizer keeps
block-diagonal second-moment statistics

    A = EMA[ G G^T ] + damping * tr(A)/n * I        (``block`` x ``block``)

factors them every ``factor_every`` steps under the configured ladder,
and every step whitens the gradient by two triangular solves with the
cached factor (L L^T X = G), its magnitude grafted from the raw gradient;
AdamW then takes the whitened gradients.

The reference ``jax.vmap``s the factor over (layers x blocks) and the two
solves over every block; here each is a batched launch of the same
kernels (``blocked_potrf`` and ``tree_trsm_left`` on (N, n, n) stacks):

- the refactor stacks every eligible matrix's blocks, all (block x block),
  into ONE batch: per panel one ``potrf_leaf``, one ``tri_inv_leaf`` and
  one ``panel_update`` launch for all N blocks (T = block / leaf panels:
  T, T - 1 and T - 1 launches), whatever the depth of the model;
- the whitening groups the blocks by their right-hand side width
  ``dout`` and solves each group as one batch.

The reference's ``lax.cond`` on the step count is Python on a host
integer. The layers are a list, so a parameter's path reads
``layers/<i>/attn/wq``, and the statistics and factors are dicts from
such paths to per-matrix stacks (nb, block, block), where the reference
keeps pytrees whose stacked leaves are (L, nb, block, block)
(``repro_torch.convert.opt_state_from_reference`` carries them across).
:func:`apply` updates the statistics, factors, AdamW moments and
parameters in place (see ``adamw``) and returns them.
"""
from __future__ import annotations

import dataclasses
import re

import torch

from repro_torch.core.blocked import blocked_potrf
from repro_torch.core.precision import PrecisionConfig
from repro_torch.core.refine import refine_steps, scaled_solve
from repro_torch.core.tree import tree_potrf, tree_trsm_left
from repro_torch.optim import adamw

ELIGIBLE = re.compile(
    r"(mlp/(w_in|w_gate|w_out)|attn/(wq|wk|wv|wo)|ck|cv|w_out|w_in)$")


@dataclasses.dataclass(frozen=True)
class TreeNewtonConfig:
    adam: adamw.AdamWConfig = dataclasses.field(
        default_factory=adamw.AdamWConfig)
    precision: PrecisionConfig = dataclasses.field(
        default_factory=lambda: PrecisionConfig(levels=("bf16", "f32"),
                                                leaf=128))
    block: int = 512            # Shampoo block size (multiple of leaf)
    stats_every: int = 1
    factor_every: int = 10
    damping: float = 1e-3
    ema: float = 0.95
    max_side: int = 32768       # skip matrices with larger fan-in
    refine_sweeps: int = 0      # IR sweeps per whiten against the CURRENT
                                # damped stats, reusing the cached factor


def _eligible(path: str, leaf, cfg: TreeNewtonConfig) -> bool:
    if leaf.dim() not in (2, 3):
        return False
    din = leaf.shape[-2]
    if din % cfg.block != 0 or din > cfg.max_side:
        return False
    return bool(ELIGIBLE.search(path))


def _to_blocks(g, block):
    """[..., din, dout] -> [..., nb, block, dout]"""
    *lead, din, dout = g.shape
    return g.reshape(*lead, din // block, block, dout)


def init(params, cfg: TreeNewtonConfig):
    """AdamW's state, and identity statistics and factors (chol(I) = I)
    for every eligible matrix; count 0."""
    stats = {}
    for path, leaf in adamw.leaves(params):
        if _eligible(path, leaf, cfg):
            nb = leaf.shape[-2] // cfg.block
            eye = torch.eye(cfg.block, dtype=torch.float32, device=leaf.device)
            stats[path] = eye.expand(*leaf.shape[:-2], nb, cfg.block,
                                     cfg.block).clone()
    return {"adam": adamw.init(params, cfg.adam), "stats": stats,
            "factors": {p: s.clone() for p, s in stats.items()}, "count": 0}


def _update_stats(g, a, cfg: TreeNewtonConfig):
    gb = _to_blocks(g.to(torch.float32), cfg.block)
    gg = torch.matmul(gb, gb.transpose(-1, -2)) / gb.shape[-1]
    return cfg.ema * a + (1 - cfg.ema) * gg


def _damped(a, cfg: TreeNewtonConfig):
    n = a.shape[-1]
    tr = torch.diagonal(a, dim1=-2, dim2=-1).sum(-1)[..., None, None] / n
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    return a + (cfg.damping * tr + 1e-12) * eye


def _refactor(a, cfg: TreeNewtonConfig):
    """Factors of the damped statistics ``a`` (..., n, n), all as one
    batch. ``engine="auto"`` resolves against the tuning database of
    ``a``'s device at the block size, among the engines that factor a
    stack in batched launches: where it names the tree engine for blocks
    larger than the leaf, which has no batched recursion yet (ROADMAP C),
    the blocked engine factors them. Blocks of at most one leaf go to the
    tree engine's base case (any ``n <= leaf``)."""
    n = a.shape[-1]
    pcfg = cfg.precision
    if pcfg.engine == "auto":
        from repro_torch import tune  # local: avoid an import cycle
        pcfg = tune.resolve_cfg(pcfg, n, backend=a.device.type)
        if pcfg.engine == "tree" and n > pcfg.leaf:
            pcfg = dataclasses.replace(pcfg, engine="blocked")
    potrf = (blocked_potrf if pcfg.engine == "blocked"
             and n % pcfg.leaf == 0 else tree_potrf)
    flat = _damped(a, cfg).reshape(-1, n, n)
    return potrf(flat, pcfg).reshape(a.shape)


def _whiten(g, l, a, cfg: TreeNewtonConfig):
    """Solve (L L^T) X = G per block by two tree solves, ``g`` (..., din,
    dout) with its factors ``l`` and statistics ``a`` (..., nb, n, n), all
    blocks as one batch, and graft the raw gradient's norm per matrix.
    With ``refine_sweeps > 0`` each solve takes that many IR sweeps
    against the CURRENT damped statistics, the cached factor as the
    corrector."""
    return _whiten_group([(g, l, a)], cfg)[0]


def _whiten_group(items, cfg: TreeNewtonConfig):
    """:func:`_whiten` of several matrices of one ``dout``, ``items`` =
    ``[(g, l, a), ...]``, their blocks solved as ONE batch."""
    n = cfg.block
    gf = torch.cat([_to_blocks(g.to(torch.float32), n).reshape(
        -1, n, g.shape[-1]) for g, _, _ in items])
    lf = torch.cat([l.reshape(-1, n, n) for _, l, _ in items])
    prec = cfg.precision

    def base(r):
        y = tree_trsm_left(r, lf, prec, trans=False)
        return tree_trsm_left(y, lf, prec, trans=True)

    x = base(gf)
    if cfg.refine_sweeps > 0:
        af = torch.cat([_damped(a, cfg).to(torch.float32).reshape(-1, n, n)
                        for _, _, a in items])
        x = refine_steps(lambda v: af @ v, scaled_solve(base), gf, x,
                         cfg.refine_sweeps)
    out, off = [], 0
    for g, _, _ in items:
        nbl = g[..., 0, 0].numel() * (g.shape[-2] // n)
        xg = x[off:off + nbl].reshape(g.shape)
        off += nbl
        # graft: rescale to the raw gradient's norm per matrix
        gn = torch.sqrt(torch.sum(torch.square(g.to(torch.float32)),
                                  dim=(-2, -1), keepdim=True))
        xn = torch.sqrt(torch.sum(torch.square(xg), dim=(-2, -1),
                                  keepdim=True))
        out.append(xg * (gn / torch.clamp_min(xn, 1e-12)))
    return out


def whiten_groups(params, cfg: TreeNewtonConfig) -> dict:
    """The whitening's batches: ``{dout: [path, ...]}`` of the eligible
    matrices, in parameter order; each group is solved as one batch (the
    refactor takes all of them as one)."""
    out: dict = {}
    for path, leaf in adamw.leaves(params):
        if _eligible(path, leaf, cfg):
            out.setdefault(leaf.shape[-1], []).append(path)
    return out


@torch.no_grad()
def apply(grads, state, params, cfg: TreeNewtonConfig):
    """Precondition the eligible gradients, then AdamW on the result.
    Returns ``(params, state, metrics)``; the state's statistics and
    factors are replaced, its AdamW moments and the parameters updated in
    place."""
    count = state["count"] + 1
    gleaf = dict(adamw.leaves(grads))
    stats = state["stats"]
    if count % cfg.stats_every == 0:
        stats = {p: _update_stats(gleaf[p], a, cfg) for p, a in stats.items()}
    factors = state["factors"]
    if count % cfg.factor_every == 0 and stats:
        paths = list(stats)
        flat = _refactor(torch.cat([stats[p].reshape(-1, cfg.block, cfg.block)
                                    for p in paths]), cfg)
        factors, off = {}, 0
        for p in paths:
            k = stats[p].numel() // (cfg.block * cfg.block)
            factors[p] = flat[off:off + k].reshape(stats[p].shape)
            off += k
    white = {}
    for paths in whiten_groups(grads, cfg).values():
        outs = _whiten_group([(gleaf[p], factors[p], stats[p])
                              for p in paths], cfg)
        white.update(zip(paths, outs))
    pgrads = adamw.tree_map(lambda path, g: white.get(path, g), grads)
    params, adam_state, metrics = adamw.apply(pgrads, state["adam"], params,
                                              cfg.adam)
    state.update(adam=adam_state, stats=stats, factors=factors, count=count)
    return params, state, metrics
