"""Distributed block-row Cholesky and solve on ``torch.distributed``.

Counterpart of ``repro/core/distributed.py``. 1-D block-row layout: rank i
of the mesh axis ``axis`` owns rows ``[i*w, (i+1)*w)`` of the global
(n, n) SPD matrix, w = n / P. The factorization is a right-looking panel
sweep over the P block columns; per panel j:

  1. broadcast (or all-gather) the (w, w) diagonal block   (comm: w^2|n*w)
  2. every rank factorizes the diagonal block redundantly, and each rank
     below it solves its own row block against it          (compute: w^3)
  3. all-gather the solved panel                            (comm: n*w)
  4. each rank below the panel updates its trailing rows (``qgemm``)

The local POTRF/TRSM are the single-device engines (``cfg.engine``):
``"blocked"`` runs :func:`~repro_torch.core.blocked.blocked_potrf` on a
:meth:`~repro_torch.core.plan.PrecisionPlan.subplan` view of the global
plan (every tile keeps its GLOBAL precision; w > leaf dispatches the
fused panel kernel) and :func:`~repro_torch.core.blocked
.blocked_trsm_left`, and each rank storage-rounds its block-row slice of
the solved panel per the plan; ``"tree"`` runs the paper's recursion.

Collectives are quantized by default: the solved panel travels at the
precision :meth:`~repro_torch.core.plan.ShardedPlan.comm_name` assigns
it, the coarsest level any trailing consumer computes at. 16-bit panels
travel as 2 bytes an element and int8 ones as int8, with the ranks' f32
scales gathered beside them; f32 and f64 panels travel raw. (The
reference bitcasts 16-bit panels to u16 so that XLA cannot move the
conversion to f32 ahead of the gather; torch moves the tensor it is
given.) :data:`WIRE` counts the bytes by collective and dtype; nothing
here times or synchronizes a collective.

SPMD contract: every rank of the mesh calls :func:`dist_cholesky` and
:func:`dist_cholesky_solve` with the same arguments, in the same order,
with its own shard: a ``DTensor`` placed ``Shard(0)`` on the mesh axis
``axis`` (the counterpart of ``NamedSharding(mesh, P(axis, None))``;
:func:`shard_rows` makes one from a matrix every rank holds). The results
come back the same way. Inside, each rank works on ``to_local()``
tensors and talks through the list forms of ``all_gather`` and
``broadcast`` on ``mesh.get_group(axis)``.

Where the reference differs: its shard_map traces one program that every
shard runs, with ``where`` masks choosing the owner's values, so each
shard also solves and updates the blocks of the upper triangle, which are
zeroed at the end. Here a rank is concrete: only the ranks below panel j
solve their row block and update their trailing rows, and in the solve
only the owner of a diagonal block solves against it (the reference's
psum of the diagonal block feeds a solve every shard runs and all but the
owner discard). The factor's values are the reference's; the backward
sweep sums each rank's ``L_kj^T x_k`` in rank order where the reference
runs one GEMM over the gathered rows.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.blocked import (blocked_potrf, blocked_trsm_left,
                                      diag_tri_inv)
from repro_torch.core.plan import build_plan, shard
from repro_torch.core.precision import DTYPES, PrecisionConfig
from repro_torch.core.quantize import quant_block, storage_round
from repro_torch.core.tree import tree_potrf, tree_trsm, tree_trsm_left
from repro_torch.kernels import ops

_NAMES = {dt: name for name, dt in DTYPES.items()}

#: bytes each rank handed to each collective since the last
#: :func:`reset_wire`, by collective and dtype name: its contribution to
#: an ``all_gather``, the block of a ``broadcast`` (counted on every rank,
#: the sender's as the receivers'), its own block of a ``scatter``
WIRE: dict[str, dict[str, int]] = {"all_gather": {}, "broadcast": {},
                                   "scatter": {}}


def reset_wire() -> None:
    for counts in WIRE.values():
        counts.clear()


def _count(op: str, t) -> None:
    name = _NAMES[t.dtype]
    WIRE[op][name] = WIRE[op].get(name, 0) + t.numel() * t.element_size()


def all_gather_counted(t, group) -> list:
    """The list form of ``all_gather``: every rank's ``t``, in rank
    order."""
    t = t.contiguous()
    _count("all_gather", t)
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return out


def broadcast_counted(t, src: int, group):
    """``t`` of group rank ``src`` into ``t`` of every rank, in place."""
    _count("broadcast", t)
    dist.broadcast(t, src=dist.get_global_rank(group, src), group=group)
    return t


def scatter_counted(out, chunks, src: int, group):
    """Block i of ``chunks`` (a list on group rank ``src``, None on the
    others) into ``out`` of group rank i, in place."""
    _count("scatter", out)
    dist.scatter(out, [c.contiguous() for c in chunks] if chunks else None,
                 src=dist.get_global_rank(group, src), group=group)
    return out


def _axis(mesh, axis: str):
    """``(group, nshards, my)`` of the mesh axis ``axis``."""
    group = mesh.get_group(axis)
    return group, dist.get_world_size(group), dist.get_rank(group)


def _local(x, mesh, axis: str):
    """The local shard of a ``DTensor`` placed ``Shard(0)`` on ``axis``,
    and its placements."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(x, DTensor) or x.device_mesh != mesh:
        raise TypeError("expected a DTensor on the given mesh (shard_rows "
                        f"makes one), got {type(x).__name__}")
    if x.placements[mesh.mesh_dim_names.index(axis)] != Shard(0):
        raise ValueError(f"expected rows sharded over mesh axis {axis!r}, "
                         f"got placements {x.placements}")
    return x.to_local(), x.placements


def _wrap(local, mesh, placements):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, mesh, placements, run_check=False)


def _row_placements(mesh, axis: str) -> list:
    from torch.distributed.tensor import Replicate, Shard
    placements = [Replicate()] * mesh.ndim
    placements[mesh.mesh_dim_names.index(axis)] = Shard(0)
    return placements


def shard_rows(x, mesh, axis: str = "model"):
    """A tensor every rank holds in full, as a ``DTensor`` whose rank i of
    ``axis`` holds rows ``[i*w, (i+1)*w)`` (a view; no communication)."""
    _, nshards, my = _axis(mesh, axis)
    w = x.shape[0] // nshards
    assert w * nshards == x.shape[0], (x.shape, nshards)
    return _wrap(x[my * w:(my + 1) * w], mesh, _row_placements(mesh, axis))


def scatter_rows(x, mesh, axis: str = "model", *, shape=None, dtype=None,
                 device=None):
    """A tensor that only rank 0 of ``axis`` holds, sent out as the
    ``DTensor`` :func:`shard_rows` would make (one counted ``scatter``:
    each rank receives its own rows). The other ranks pass ``x=None`` and
    the global ``shape``, ``dtype`` and their ``device``."""
    group, nshards, my = _axis(mesh, axis)
    if x is not None:
        shape, dtype, device = x.shape, x.dtype, x.device
    w = shape[0] // nshards
    assert w * nshards == shape[0], (shape, nshards)
    out = torch.empty((w, *shape[1:]), dtype=dtype, device=device)
    chunks = list(x.split(w)) if my == 0 else None
    scatter_counted(out, chunks, 0, group)
    return _wrap(out, mesh, _row_placements(mesh, axis))


def gather_rows(x, mesh, axis: str = "model"):
    """The rows of a ``Shard(0)`` ``DTensor`` gathered on every rank (one
    counted ``all_gather``)."""
    local, _ = _local(x, mesh, axis)
    group, _, _ = _axis(mesh, axis)
    return torch.cat(all_gather_counted(local, group))


def _gather_panel(li, name: str, quant: bool, group, compress: bool):
    """All-gather the solved (w, w) panel block at precision ``name``.

    Returns ``(liq, s1, gathered)``: the local block quantized to the
    collective's dtype, its scale, and every rank's block in that dtype.
    ``compress=False`` or a wide ``name`` moves the raw block and returns
    ``liq = s1 = None`` (the quantization then follows the gather)."""
    if not compress or name in ("f32", "f64"):
        return None, None, all_gather_counted(li, group)
    liq, s1 = quant_block(li, name, quant)
    return liq, s1, all_gather_counted(liq, group)


def _round_panel_rows(li, codes, names, quants, leaf: int) -> None:
    """Round each (leaf, leaf) tile of a rank's solved (w, w) panel block,
    in place, onto the storage grid ``names[codes[r, c]]`` of its plan
    slice (``codes``: this rank's rows of ``ShardedPlan.store_codes``)."""
    tps = codes.shape[0]
    for r in range(tps):
        for c in range(tps):
            tile = li[r * leaf:(r + 1) * leaf, c * leaf:(c + 1) * leaf]
            k = int(codes[r, c])
            rounded = storage_round(tile, names[k], quants[k])
            if rounded is not tile:
                tile.copy_(rounded)


def _diag_block(colpanel, j: int, group, my: int, broadcast_diag_only):
    """Panel j's (w, w) diagonal block on every rank: broadcast from its
    owner, or taken from an all-gather of every rank's block column."""
    if broadcast_diag_only:
        buf = (colpanel.contiguous() if my == j else
               torch.empty(colpanel.shape, dtype=colpanel.dtype,
                           device=colpanel.device))
        return broadcast_counted(buf, j, group)
    return all_gather_counted(colpanel, group)[j]


def _trailing_update(work, li, j: int, name: str, quant: bool, group,
                     my: int, compress: bool) -> None:
    """Gather panel j at precision ``name`` and subtract ``L_i L_t^T`` from
    the trailing columns of the rows of each rank below the panel (the
    rows of the ranks at or above it lie in the upper triangle there)."""
    w = work.shape[0]
    liq, s1, gath = _gather_panel(li, name, quant, group, compress)
    scales = None
    if liq is not None and quant:
        # per-rank scales travel as (P,) f32 and rescale the output's
        # column blocks
        scales = torch.cat(all_gather_counted(s1.reshape(1), group))
    if my <= j:
        return
    c = work[:, (j + 1) * w:]
    lt = torch.cat(gath[j + 1:])                      # ((P-j-1) w, w)
    if liq is None:                                   # wide wire
        liq, s1 = quant_block(li, name, quant)
        ltq, s2 = quant_block(lt, name, quant)
        ops.qgemm(liq, ltq, -(s1 * s2), c=c, beta=1.0, trans_b=True,
                  out_dtype=work.dtype, out=c)
        return
    upd = ops.qgemm(liq, lt, s1, trans_b=True, out_dtype=torch.float32)
    if scales is not None:
        upd = upd * scales[j + 1:].repeat_interleave(w)[None, :]
    c -= upd.to(work.dtype)


def _local_potrf_blocked(a_local, *, group, nshards: int, my: int,
                         cfg: PrecisionConfig, broadcast_diag_only: bool,
                         compress_comm: bool):
    """Plan-driven local engine: blocked POTRF/TRSM + planned
    collectives. Returns this rank's rows of L."""
    w, n = a_local.shape
    sp = shard(build_plan(n, cfg), nshards)
    tps = sp.tps
    work = a_local.clone(memory_format=torch.contiguous_format)
    for j in range(nshards):
        colpanel = work[:, j * w:(j + 1) * w]
        diag = _diag_block(colpanel, j, group, my, broadcast_diag_only)
        # redundant diagonal factorization at the GLOBAL plan's tile
        # precisions; w > leaf dispatches the fused panel kernel inside
        ld = blocked_potrf(diag, cfg, plan=sp.diag_plan(j))
        if my == j:
            li = ld                          # the owner keeps the factor
        elif my > j:
            # own row block: li = colpanel ld^-T via (ld^-1 colpanel^T)^T
            # (contiguous again, so the narrow codes the gather sends are
            # K-major for the trailing qgemm's tensor-core route)
            li = blocked_trsm_left(colpanel.T, ld, cfg, trans=False,
                                   linvs=diag_tri_inv(ld, cfg)).T.contiguous()
            if cfg.storage_rounding:
                codes = sp.store_codes(j)[my * tps:(my + 1) * tps]
                _round_panel_rows(li, codes, sp.names, sp.quants, cfg.leaf)
        else:
            li = torch.zeros_like(ld)        # upper triangle: zero
        if j < nshards - 1:
            # collective + trailing update at the sharded plan's comm
            # precision: the coarsest level any trailing consumer runs at
            _trailing_update(work, li, j, sp.comm_name(j), sp.comm_quant(j),
                             group, my, compress_comm)
        work[:, j * w:(j + 1) * w] = li
    return work.tril_(my * w)


def _local_potrf_tree(a_local, *, group, nshards: int, my: int,
                      cfg: PrecisionConfig, broadcast_diag_only: bool,
                      compress_comm: bool):
    """The paper's recursive routines as the local engine; the trailing
    update always consumes the panel at level 0 (the tree predates the
    plan). Returns this rank's rows of L."""
    w, n = a_local.shape
    work = a_local.clone(memory_format=torch.contiguous_format)
    name, quant = cfg.name_at(0), cfg.needs_quant(0)
    for j in range(nshards):
        colpanel = work[:, j * w:(j + 1) * w]
        diag = _diag_block(colpanel, j, group, my, broadcast_diag_only)
        ld = tree_potrf(diag, cfg)                               # redundant
        if my == j:
            li = ld
        elif my > j:
            li = tree_trsm(colpanel, ld, cfg)
        else:
            li = torch.zeros_like(ld)
        if j < nshards - 1:
            _trailing_update(work, li, j, name, quant, group, my,
                             compress_comm)
        work[:, j * w:(j + 1) * w] = li
    return work.tril_(my * w)


def _autoresolve(cfg: PrecisionConfig, n: int, nshards: int, backend: str):
    """Resolve ``engine="auto"`` via the tuning database (no-op
    otherwise)."""
    if cfg.engine != "auto":
        return cfg
    from repro_torch import tune  # local: tune is a consumer of this module
    return tune.resolve_cfg(cfg, n, nshards, backend=backend)


def dist_cholesky(a, mesh, cfg: PrecisionConfig | None = None,
                  axis: str = "model", *, broadcast_diag_only: bool = True,
                  compress_comm: bool | None = None):
    """Distributed lower Cholesky of a block-row-sharded SPD matrix (SPMD:
    every rank calls it with its shard).

    ``a``: the global (n, n) matrix as a ``DTensor`` placed ``Shard(0)``
    on ``axis``; n divisible by ``nshards * cfg.leaf``. Returns L placed
    the same way, its upper triangle zero. ``cfg.engine`` selects the
    local engine (``"blocked"``, ``"tree"``, or ``"auto"``: the tuning
    database's pick for this ``(n, nshards)`` on the shard's device
    type). ``broadcast_diag_only`` broadcasts the diagonal block from its
    owner (else every rank's block column is all-gathered).
    ``compress_comm`` gathers the solved panel at the precision the
    sharded plan assigns the collective; ``False`` forces full-precision
    gathers and the default ``None`` takes the tuning database's choice
    (compressed where the database has no entry).
    """
    cfg = cfg or PrecisionConfig()
    a_local, placements = _local(a, mesh, axis)
    group, nshards, my = _axis(mesh, axis)
    n = a_local.shape[-1]
    if n % nshards or (n // nshards) % cfg.leaf:
        raise ValueError(f"n={n} must be divisible by shards*leaf="
                         f"{nshards}*{cfg.leaf}")
    assert a_local.shape == (n // nshards, n), a_local.shape
    backend = a_local.device.type
    cfg = _autoresolve(cfg, n, nshards, backend)
    if compress_comm is None:
        from repro_torch import tune
        compress_comm = tune.decide(n, tune.ladder_key(cfg), nshards,
                                    backend=backend).compress_comm
    local = (_local_potrf_tree if cfg.engine == "tree"
             else _local_potrf_blocked)
    l_local = local(a_local, group=group, nshards=nshards, my=my, cfg=cfg,
                    broadcast_diag_only=broadcast_diag_only,
                    compress_comm=compress_comm)
    return _wrap(l_local, mesh, placements)


def _local_solve(l_local, b_local, *, group, nshards: int, my: int,
                 cfg: PrecisionConfig):
    """Forward then back substitution on block-row-sharded L and B; each
    diagonal block is solved by its owner, through the engine
    ``cfg.engine`` selects, in the ladder's high precision (the solve is
    O(n^2) next to the O(n^3) factorization)."""
    w = l_local.shape[0]
    high = cfg.high_dtype

    def trsm_left(bm, lm, trans):
        if cfg.engine == "tree":
            return tree_trsm_left(bm, lm, cfg, trans=trans)
        return blocked_trsm_left(bm, lm, cfg, trans=trans)

    # forward: y_j = L_jj^{-1} (b_j - sum_{k<j} L_jk y_k)
    y = torch.zeros_like(b_local)
    for j in range(nshards):
        ys = all_gather_counted(y, group) if j > 0 else None
        if my != j:
            continue
        acc = b_local
        if j > 0:
            past = torch.cat(ys[:j])                             # (j w, r)
            acc = b_local - ops.qgemm(l_local[:, :j * w].to(high),
                                      past.to(high),
                                      out_dtype=b_local.dtype)
        y = trsm_left(acc, l_local[:, j * w:(j + 1) * w], False)
    # backward: x_j = L_jj^{-T} (y_j - sum_{k>j} L_kj^T x_k); rank k > j
    # holds L_kj and its finished x_k, and hands L_kj^T x_k to the owner
    x = torch.zeros_like(y)
    for j in reversed(range(nshards)):
        if j < nshards - 1:
            part = (ops.qgemm(l_local[:, j * w:(j + 1) * w].T.to(high),
                              x.to(high), out_dtype=y.dtype)
                    if my > j else torch.zeros_like(y))
            parts = all_gather_counted(part, group)
        if my != j:
            continue
        acc = y
        if j < nshards - 1:
            for part in parts[j + 1:]:
                acc = acc - part
        x = trsm_left(acc, l_local[:, j * w:(j + 1) * w], True)
    return x


def dist_cholesky_solve(a, b, mesh, cfg: PrecisionConfig | None = None,
                        axis: str = "model", *, l=None):
    """Solve A x = b with A (and b) block-row-sharded over ``axis`` (SPMD,
    as :func:`dist_cholesky`). ``b``: an (n,) or (n, k) ``DTensor`` placed
    ``Shard(0)`` on ``axis``; the result is placed the same way. ``l``
    reuses a factor from :func:`dist_cholesky` (``a`` may then be None)."""
    cfg = cfg or PrecisionConfig()
    group, nshards, my = _axis(mesh, axis)
    b_local, placements = _local(b, mesh, axis)
    cfg = _autoresolve(cfg, b.shape[0], nshards, b_local.device.type)
    if l is None:
        l = dist_cholesky(a, mesh, cfg, axis)
    l_local, _ = _local(l, mesh, axis)
    vec = b_local.dim() == 1
    x = _local_solve(l_local, b_local[:, None] if vec else b_local,
                     group=group, nshards=nshards, my=my, cfg=cfg)
    return _wrap(x[:, 0] if vec else x, mesh, placements)
