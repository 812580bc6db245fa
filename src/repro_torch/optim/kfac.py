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

Under a device mesh (``init(params, cfg, mesh)`` on DTensor parameters)
layer ``i``'s statistics and factors live on the ranks that
``launch.sharding.stats_owners`` names (the ``data`` coordinate ``i // (L
/ data)``, whole, on every rank of it), and are ``meta`` tensors (shape
only) elsewhere. Each step each eligible gradient goes whole to its
owners alone (``launch.hostwire.gather_to``, in path order on every
rank); the owners update their statistics, refactor their own blocks
as ONE batched factor, and whiten their matrices (the schedule above,
per rank); each whitened gradient goes back to its parameter's
placement as a sum over ``data`` of the owners' values and the others'
zeros (exact), and AdamW takes them as it takes any placed gradient.
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


#: a layer's parameter path; the reference stacks such leaves [L, ...]
_LAYERED = re.compile(r"^(dense_layers|layers)/\d+/")


def _eligible(path: str, leaf, cfg: TreeNewtonConfig) -> bool:
    """The reference's rule on the shape it sees: a leaf of 2 or 3 dims,
    where a layer's leaf counts its stacked layer axis (so a layer's
    [E, d, F] expert stack, [L, E, d, F] there, goes to AdamW). A layer's
    vector has no rows of its own; no eligible name is one."""
    ndim = leaf.dim() + (1 if _LAYERED.match(path) else 0)
    if ndim not in (2, 3) or leaf.dim() < 2:
        return False
    din = leaf.shape[-2]
    if din % cfg.block != 0 or din > cfg.max_side:
        return False
    return bool(ELIGIBLE.search(path))


def _to_blocks(g, block):
    """[..., din, dout] -> [..., nb, block, dout]"""
    *lead, din, dout = g.shape
    return g.reshape(*lead, din // block, block, dout)


def _held(owner, mesh) -> bool:
    """Whether this rank holds statistics placed by ``owner``."""
    from repro_torch.launch.sharding import Owned
    if isinstance(owner, Owned):
        return owner.holds(mesh)
    if any(e is not None for e in owner):
        raise NotImplementedError("statistics sharded over data outside "
                                  "the layers (no family under a mesh has "
                                  "them)")
    return True


def init(params, cfg: TreeNewtonConfig, mesh=None):
    """AdamW's state, and identity statistics and factors (chol(I) = I)
    for every eligible matrix; count 0. With ``mesh`` (DTensor
    parameters) a rank keeps only the statistics it holds (module
    docstring); the others are ``meta`` tensors of their shape."""
    from repro_torch.launch.sharding import stats_owners
    shapes = {p: (*l.shape[:-2], l.shape[-2] // cfg.block, cfg.block,
                  cfg.block)
              for p, l in adamw.leaves(params) if _eligible(p, l, cfg)}
    leaf = dict(adamw.leaves(params))
    owners = stats_owners(shapes, mesh) if mesh is not None else {}
    stats = {}
    for path, shape in shapes.items():
        if mesh is not None and not _held(owners[path], mesh):
            stats[path] = torch.empty(shape, dtype=torch.float32,
                                      device="meta")
            continue
        eye = torch.eye(cfg.block, dtype=torch.float32,
                        device=leaf[path].device)
        stats[path] = eye.expand(shape).clone()
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
    stack (the reference vmaps the engine's POTRF over them).
    ``engine="auto"`` resolves against the tuning database of ``a``'s
    device at the block size. Blocks that are not a multiple of the leaf
    (small ``block`` configs) stay on the tree engine, whose base case
    handles any ``n <= leaf`` without padding."""
    n = a.shape[-1]
    pcfg = cfg.precision
    if pcfg.engine == "auto":
        from repro_torch import tune  # local: avoid an import cycle
        pcfg = tune.resolve_cfg(pcfg, n, backend=a.device.type)
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


def _owner_ranks(owner, g) -> list:
    """The global ranks that hold statistics placed by ``owner``, on the
    mesh of the gradient ``g``: an ``Owned`` leaf's holders, else every
    rank (``_held`` refuses the rest)."""
    from repro_torch.launch.sharding import Owned
    mesh = g.device_mesh
    if isinstance(owner, Owned):
        return owner.ranks(mesh)
    return mesh.mesh.flatten().tolist()


def _placed_back(x, g, owner):
    """A whitened whole gradient ``x`` as a DTensor placed like the
    gradient ``g``. ``owner`` is its statistics' placement: an ``Owned``
    leaf's holders add their ``x`` over the owning axis to the other
    ranks' zeros (``x`` None there); a replicated one's ``x`` is the same
    on every rank."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from repro_torch.launch.sharding import Owned, axis_names
    mesh = g.device_mesh
    if x is None:
        x = torch.zeros(g.shape, dtype=torch.float32,
                        device=g.to_local().device)
    pl = [Partial() if isinstance(owner, Owned) and a == owner.axis
          else Replicate() for a in axis_names(mesh)]
    d = DTensor.from_local(x, mesh, pl, run_check=False)
    return d.redistribute(mesh, g.placements)


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
    # a replicated placement (a restore's) is the whole tensor
    stats = {p: adamw._local(a) for p, a in state["stats"].items()}
    state["factors"] = {p: adamw._local(f)
                        for p, f in state["factors"].items()}
    held = [p for p, a in stats.items() if a.device.type != "meta"]
    placed = adamw._is_dtensor(next(iter(gleaf.values())))
    owners = {}
    if placed and stats:
        from repro_torch.launch import hostwire
        from repro_torch.launch.sharding import stats_owners
        owners = stats_owners({p: a.shape for p, a in stats.items()},
                              gleaf[next(iter(stats))].device_mesh)
    # under a mesh the owners work on whole gradients: each eligible one
    # goes whole to its owners alone, in path order on every rank
    whole = {}
    for p in stats:
        if not placed:
            whole[p] = gleaf[p]
            continue
        g = hostwire.gather_to(gleaf[p], _owner_ranks(owners[p], gleaf[p]))
        if p in held:
            whole[p] = g.to(gleaf[p].to_local().device)
    if count % cfg.stats_every == 0:
        stats = {p: _update_stats(whole[p], a, cfg) if p in whole else a
                 for p, a in stats.items()}
    factors = state["factors"]
    if count % cfg.factor_every == 0 and held:
        flat = _refactor(torch.cat([stats[p].reshape(-1, cfg.block, cfg.block)
                                    for p in held]), cfg)
        factors, off = dict(factors), 0
        for p in held:
            k = stats[p].numel() // (cfg.block * cfg.block)
            factors[p] = flat[off:off + k].reshape(stats[p].shape)
            off += k
    white = {}
    for paths in whiten_groups(grads, cfg).values():
        paths = [p for p in paths if p in whole]
        if not paths:
            continue
        outs = _whiten_group([(whole[p], factors[p], stats[p])
                              for p in paths], cfg)
        white.update(zip(paths, outs))
    if placed and stats:
        white = {p: _placed_back(white.get(p), gleaf[p], owners[p])
                 for p in stats}
    pgrads = adamw.tree_map(lambda path, g: white.get(path, g), grads)
    params, adam_state, metrics = adamw.apply(pgrads, state["adam"], params,
                                              cfg.adam)
    state.update(adam=adam_state, stats=stats, factors=factors, count=count)
    return params, state, metrics
