"""Static per-tile precision plan (the flat answer to the recursion).

Counterpart of ``repro/core/plan.py``: pure numpy geometry, carried over
unchanged so that every plan, panel metadata tuple and collective table
is identical to the reference's. The text below speaks of the reference's
modules where this package has no counterpart yet (the tree engine, the
distributed solver, the auditor).

The tree solver (``repro.core.tree``) assigns precision implicitly:
every recursion node computes its exposed GEMMs in ``levels[min(level,
-1)]`` and each leaf rounds its tile at the level the recursion happens
to reach. That assignment is a pure function of the *geometry* — matrix
size, leaf size, bisection rule — so it can be computed once, with no
array ops, as a per-tile table. This module walks the same recursion on
index ranges only and emits, for every ``leaf x leaf`` tile ``(i, j)``:

* ``level``    — the recursion level of the potrf node whose split
  separates ``i`` from ``j`` (for diagonal tiles: the depth of the path
  down to the singleton leaf). This is the level of every GEMM the tree
  exposes on the tile, i.e. its *compute* precision — the paper's
  "precision rises toward the diagonal" map.
* ``store_level`` — the (deeper, >= ``level``) recursion level at which
  the tree's TRSM leaf finally rounds the tile for storage.
* ``quantize`` — whether the paper's per-block quantization applies at
  the tile's compute level.

:func:`build_plan` is cached per ``(n, cfg)``; the flat blocked executor
(:mod:`repro_torch.core.blocked`) looks tiles up here instead of re-deriving
precision by recursing, and :meth:`PrecisionPlan.describe` renders the
map for humans (README "Execution engines").
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from repro_torch.core.dtypes import BYTES, WIRE_DTYPE
from repro_torch.core.precision import DTYPES, NARROW, PrecisionConfig


def _eff(name: str, container: str) -> str:
    """Effective precision of a value rounded to ``name`` inside a
    ``container``-dtype array (the CPU oracles keep narrow values in
    wide containers): the narrower of the two."""
    return name if BYTES[name] < BYTES[container] else container


@dataclasses.dataclass(frozen=True)
class TileInfo:
    """Static precision assignment of one leaf tile."""

    level: int          # compute level (GEMM precision of the tile)
    name: str           # dtype name at the compute level
    store_level: int    # level whose dtype the tree stores the tile in
    store_name: str     # dtype name at the storage level
    quantize: bool      # per-block quantization applies at compute level

    @property
    def dtype(self):
        return DTYPES[self.name]

    @property
    def store_dtype(self):
        return DTYPES[self.store_name]


def _needs_quant(name: str, cfg: PrecisionConfig) -> bool:
    """Mirror of ``tree._round_to`` / ``cfg.needs_quant`` gating."""
    if name == "int8":
        return True
    return cfg.quantize and name in NARROW


def _split_tiles(nt: int) -> int:
    """cfg.split in tile units: leaf-aligned bisection point."""
    return max(1, nt // 2)


class PrecisionPlan:
    """Per-tile precision table for an ``n x n`` factorization.

    ``levels``/``store_levels`` are symmetric ``(T, T)`` int arrays
    (``T = n // leaf``); only the lower triangle is meaningful to the
    executor but the mirror keeps lookups order-free.
    """

    def __init__(self, n: int, cfg: PrecisionConfig):
        assert n % cfg.leaf == 0 and n > 0, (n, cfg.leaf)
        self.n = n
        self.cfg = cfg
        self.leaf = cfg.leaf
        self.ntiles = n // cfg.leaf
        T = self.ntiles
        comp = np.zeros((T, T), np.int32)
        store = np.zeros((T, T), np.int32)
        self._walk_potrf(comp, store, 0, T, 0)
        # mirror so (i, j) and (j, i) agree
        il = np.tril_indices(T, -1)
        comp[il[1], il[0]] = comp[il]
        store[il[1], il[0]] = store[il]
        self.levels = comp
        self.store_levels = store

    # -- construction (mirrors tree.py's recursion on index ranges) --------
    def _walk_potrf(self, comp, store, lo, hi, level):
        if hi - lo == 1:
            comp[lo, lo] = store[lo, lo] = level
            return
        mid = lo + _split_tiles(hi - lo)
        self._walk_potrf(comp, store, lo, mid, level + 1)
        # A21 block: every exposed GEMM runs at this node's level ...
        comp[mid:hi, lo:mid] = level
        # ... while the TRSM leaf that finally stores each column sits
        # deeper, at level + (column bisection depth):
        self._walk_trsm(store, mid, hi, lo, mid, level)
        self._walk_potrf(comp, store, mid, hi, level + 1)

    def _walk_trsm(self, store, rlo, rhi, clo, chi, level):
        if chi - clo == 1:
            store[rlo:rhi, clo] = level
            return
        cmid = clo + _split_tiles(chi - clo)
        self._walk_trsm(store, rlo, rhi, clo, cmid, level + 1)
        self._walk_trsm(store, rlo, rhi, cmid, chi, level + 1)

    # -- lookups -----------------------------------------------------------
    def level(self, i: int, j: int) -> int:
        return int(self.levels[i, j])

    def name(self, i: int, j: int) -> str:
        return self.cfg.name_at(self.level(i, j))

    def store_name(self, i: int, j: int) -> str:
        return self.cfg.name_at(int(self.store_levels[i, j]))

    def quant(self, i: int, j: int) -> bool:
        return _needs_quant(self.name(i, j), self.cfg)

    def tile(self, i: int, j: int) -> TileInfo:
        lv, sv = self.level(i, j), int(self.store_levels[i, j])
        name = self.cfg.name_at(lv)
        return TileInfo(level=lv, name=name, store_level=sv,
                        store_name=self.cfg.name_at(sv),
                        quantize=_needs_quant(name, self.cfg))

    def subplan(self, lo: int, hi: int) -> "PrecisionPlan":
        """Tile-square view ``[lo, hi)`` of this plan (shared tables).

        The returned object answers every lookup with the PARENT plan's
        levels for those tiles, so an executor running on a sub-block
        (the distributed solver's redundant diagonal factorization)
        computes each tile at the precision the GLOBAL recursion assigns
        it — not the precision a fresh size-``hi - lo`` recursion would.
        """
        assert 0 <= lo < hi <= self.ntiles, (lo, hi, self.ntiles)
        sub = object.__new__(PrecisionPlan)
        sub.n = (hi - lo) * self.leaf
        sub.cfg = self.cfg
        sub.leaf = self.leaf
        sub.ntiles = hi - lo
        sub.levels = self.levels[lo:hi, lo:hi]
        sub.store_levels = self.store_levels[lo:hi, lo:hi]
        return sub

    def panel_meta(self, p: int) -> "PanelMeta":
        """Static metadata for the fused panel update at panel ``p``:
        storage names/quant flags for the trailing row tiles of column
        ``p`` and compute names/quant flags for every trailing pair."""
        cfg = self.cfg
        rows = range(p + 1, self.ntiles)
        store_names = tuple(self.store_name(i, p) for i in rows)
        store_quants = tuple(_needs_quant(nm, cfg) for nm in store_names)
        pair_names = tuple(tuple(self.name(i, j) for j in rows)
                           for i in rows)
        pair_quants = tuple(tuple(_needs_quant(nm, cfg) for nm in row)
                            for row in pair_names)
        return PanelMeta(store_names, store_quants, pair_names, pair_quants)

    # -- audit lookup tables (consumed by repro.audit.conformance) ---------
    def panel_dot_flops(self, p: int, container: str | None = None) -> dict:
        """Expected GEMM FLOPs by *effective* dtype name for the blocked
        executor's panel-``p`` update: one ``2 b^3`` TRSM dot per
        trailing row tile at its storage precision, one ``2 b^3``
        trailing dot per pair tile (incl. diagonal) at its compute
        precision. ``container`` is the carrying array dtype (default:
        the ladder's high name)."""
        cn = container or self.cfg.high_name
        b = self.leaf
        f = 2.0 * float(b) ** 3
        out: dict[str, float] = {}
        rows = range(p + 1, self.ntiles)
        for i in rows:
            nm = _eff(self.store_name(i, p), cn)
            out[nm] = out.get(nm, 0.0) + f
        for i in rows:
            for j in range(p + 1, i + 1):
                nm = _eff(self.name(i, j), cn)
                out[nm] = out.get(nm, 0.0) + f
        return out

    def panel_round_elems(self, p: int, container: str | None = None) -> dict:
        """Expected value-rounding events (elements, by target dtype
        name) the blocked executor emits for panel ``p``'s update:

        * 2 per trailing row tile at its storage name (the incoming
          block pre-TRSM and the solved L21 tile),
        * one full-column re-round per distinct trailing pair dtype
          (the executor's ``lq`` cache),
        * one per trailing pair tile at its compute name (the rounded
          partial sum).

        Rounds onto the container dtype itself are value no-ops and
        emit no event."""
        cn = container or self.cfg.high_name
        if not self.cfg.storage_rounding:
            return {}
        b = self.leaf
        out: dict[str, int] = {}
        rows = range(p + 1, self.ntiles)
        for i in rows:
            nm = self.store_name(i, p)
            if nm != cn:
                out[nm] = out.get(nm, 0) + 2 * b * b
        pair_names = {self.name(i, j) for i in rows
                      for j in range(p + 1, i + 1)}
        nt = len(rows)
        for nm in pair_names:
            if nm != cn:
                out[nm] = out.get(nm, 0) + nt * b * b
        for i in rows:
            for j in range(p + 1, i + 1):
                nm = self.name(i, j)
                if nm != cn:
                    out[nm] = out.get(nm, 0) + b * b
        return out

    def diag_round_elems(self, p: int, container: str | None = None) -> dict:
        """Expected rounding events for panel ``p``'s diagonal tile (the
        symmetrized input block and the POTRF output, both rounded at
        the tile's compute name)."""
        cn = container or self.cfg.high_name
        if not self.cfg.storage_rounding:
            return {}
        nm = self.name(p, p)
        b = self.leaf
        return {nm: 2 * b * b} if nm != cn else {}

    def expected_dot_flops(self, container: str | None = None) -> dict:
        """Whole-factorization GEMM FLOPs by effective dtype name."""
        out: dict[str, float] = {}
        for p in range(self.ntiles - 1):
            for nm, v in self.panel_dot_flops(p, container).items():
                out[nm] = out.get(nm, 0.0) + v
        return out

    def expected_round_elems(self, container: str | None = None) -> dict:
        """Whole-factorization rounding events by target dtype name."""
        out: dict[str, int] = {}
        for p in range(self.ntiles):
            for part in (self.diag_round_elems(p, container),
                         self.panel_round_elems(p, container)
                         if p < self.ntiles - 1 else {}):
                for nm, v in part.items():
                    out[nm] = out.get(nm, 0) + v
        return out

    # -- census hooks ------------------------------------------------------
    def level_counts(self) -> dict:
        """Lower-triangle tile count per compute dtype name."""
        counts: dict[str, int] = {}
        for i in range(self.ntiles):
            for j in range(i + 1):
                nm = self.name(i, j)
                counts[nm] = counts.get(nm, 0) + 1
        return counts

    def lowp_tile_fraction(self, names=("f16", "bf16", "int8")) -> float:
        counts = self.level_counts()
        total = sum(counts.values())
        low = sum(v for k, v in counts.items() if k in names)
        return low / total if total else 0.0

    def describe(self) -> str:
        """Human-readable tile map + census (README example)."""
        short = {"int8": "i8 ", "f16": "h16", "bf16": "b16", "f32": "f32",
                 "f64": "f64"}
        lines = [f"PrecisionPlan(n={self.n}, leaf={self.leaf}, "
                 f"tiles={self.ntiles}x{self.ntiles}, "
                 f"ladder={self.cfg.describe()})"]
        counts = self.level_counts()
        lines.append("  tiles: " + "  ".join(
            f"{k}={v}" for k, v in sorted(counts.items())))
        lines.append(f"  low-precision tile fraction: "
                     f"{self.lowp_tile_fraction():.2f}")
        for i in range(self.ntiles):
            row = " ".join(short.get(self.name(i, j), self.name(i, j))
                           for j in range(i + 1))
            lines.append("  " + row)
        return "\n".join(lines)

    def __repr__(self):
        return (f"PrecisionPlan(n={self.n}, leaf={self.leaf}, "
                f"ladder={self.cfg.describe()})")


@dataclasses.dataclass(frozen=True)
class PanelMeta:
    """Hashable (jit-static) per-panel metadata for the panel kernel."""

    store_names: tuple          # per trailing row tile of the panel
    store_quants: tuple
    pair_names: tuple           # [i][j] compute name of trailing pair
    pair_quants: tuple


class ShardedPlan:
    """Block-row partition of a :class:`PrecisionPlan` over ``nshards``.

    The distributed solver (:mod:`repro.core.distributed`) lays the
    global matrix out in 1-D block rows: shard ``s`` owns tile rows
    ``[s*tps, (s+1)*tps)`` with ``tps = ntiles // nshards``, and panel
    ``j`` is the j-th ``(w, w)`` block column, ``w = n // nshards``.
    This view answers the three questions that layout asks of the
    precision map, all statically (pure numpy, no array ops):

    * :meth:`diag_plan` — the tile-square sub-plan of panel ``j``'s
      diagonal block, so the redundant local factorization computes each
      tile at its GLOBAL precision (see :meth:`PrecisionPlan.subplan`).
    * :meth:`store_codes` / :attr:`names` — each shard's block-row slice
      of the per-tile STORAGE map for panel ``j``, as an int32 code
      table the (SPMD, trace-once) local executor indexes with its
      traced shard id.
    * :meth:`comm_level` / :meth:`comm_name` — the precision of panel
      ``j``'s collective: the coarsest compute level any trailing
      consumer of the gathered panel runs at. Early panels (far corner
      still in play) communicate at the ladder's coarse level — the
      paper's per-block quantization applied to the all-gather — while
      panels near the diagonal, whose every consumer computes at a fine
      level, are gathered losslessly. "Precision rises toward the
      diagonal", applied to collectives.
    """

    def __init__(self, plan: PrecisionPlan, nshards: int):
        assert nshards >= 1 and plan.ntiles % nshards == 0, (
            f"ntiles={plan.ntiles} must divide into nshards={nshards}")
        self.plan = plan
        self.cfg = plan.cfg
        self.nshards = nshards
        self.tps = plan.ntiles // nshards       # tile rows per shard
        self.panel_width = plan.n // nshards
        #: static code alphabet for store_codes tables (sorted dtype
        #: names actually present in the plan's storage map)
        self.names = tuple(sorted(
            {plan.cfg.name_at(int(v)) for v in plan.store_levels.ravel()}))
        self.quants = tuple(_needs_quant(nm, plan.cfg) for nm in self.names)

    # -- per-shard storage map --------------------------------------------
    def row_tiles(self, s: int) -> range:
        return range(s * self.tps, (s + 1) * self.tps)

    def store_codes(self, j: int) -> np.ndarray:
        """(ntiles, tps) int32 table: ``codes[i, c]`` indexes
        :attr:`names` with the storage dtype of tile ``(i, j*tps + c)``.
        All shards share the table; shard ``s`` reads rows
        ``s*tps .. (s+1)*tps`` (a traced index under shard_map)."""
        cols = self.plan.store_levels[:, j * self.tps:(j + 1) * self.tps]
        lut = {lv: self.names.index(self.cfg.name_at(int(lv)))
               for lv in np.unique(cols)}
        return np.vectorize(lut.__getitem__, otypes=[np.int32])(cols)

    # -- local engine view -------------------------------------------------
    def diag_plan(self, j: int) -> PrecisionPlan:
        return self.plan.subplan(j * self.tps, (j + 1) * self.tps)

    # -- collective precision ----------------------------------------------
    def comm_level(self, j: int) -> int:
        """Coarsest compute level among trailing consumers of panel
        ``j``'s gathered column (lower-triangle pairs strictly below the
        panel). The last panel has no consumers: highest level."""
        lo = (j + 1) * self.tps
        T = self.plan.ntiles
        if lo >= T:
            return int(self.plan.levels.max())
        sub = self.plan.levels[lo:, lo:]
        return int(sub[np.tril_indices(sub.shape[0])].min())

    def comm_name(self, j: int) -> str:
        return self.cfg.name_at(self.comm_level(j))

    def comm_quant(self, j: int) -> bool:
        return _needs_quant(self.comm_name(j), self.cfg)

    def comm_table(self) -> tuple:
        """Static per-panel collective schedule the auditor reconciles
        against traced/compiled collectives: ``(panel, name, quant,
        wire)`` rows, ``wire`` the HLO dtype the gather moves in (16-bit
        floats bitcast to u16, int8 as s8; see ``_gather_panel``)."""
        return tuple(
            {"panel": j, "name": self.comm_name(j),
             "quant": self.comm_quant(j),
             "wire": WIRE_DTYPE[self.comm_name(j)]}
            for j in range(self.nshards))

    def describe(self) -> str:
        """Per-panel collective schedule (docs/ARCHITECTURE.md)."""
        lines = [f"ShardedPlan(nshards={self.nshards}, tps={self.tps}, "
                 f"w={self.panel_width}, ladder={self.cfg.describe()})"]
        for j in range(self.nshards):
            lines.append(f"  panel {j}: comm={self.comm_name(j)}"
                         f"{' (quantized)' if self.comm_quant(j) else ''}")
        return "\n".join(lines)

    def __repr__(self):
        return (f"ShardedPlan(n={self.plan.n}, nshards={self.nshards}, "
                f"ladder={self.cfg.describe()})")


def shard(plan: PrecisionPlan, nshards: int) -> ShardedPlan:
    """Block-row partition view of ``plan`` for an ``nshards`` mesh axis."""
    return ShardedPlan(plan, nshards)


@functools.lru_cache(maxsize=256)
def build_plan(n: int, cfg: PrecisionConfig) -> PrecisionPlan:
    """Cached plan construction (pure geometry — no array ops)."""
    return PrecisionPlan(n, cfg)
