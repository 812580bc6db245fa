"""Seeded-mutation self-test: prove the auditor *detects*, not just runs.

Counterpart of ``repro/audit/selftest.py``. A conformance checker that
always passes is indistinguishable from one that checks nothing. Each
mutation plants exactly one precision bug in a seam the real executor
honors, re-runs the relevant audit with *pristine* expectations, and
demands a finding that names the mutated tile or panel:

1. **flip-compute-level**: one trailing pair tile's compute level is
   flipped in the executed plan's table (``blocked_potrf(plan=)``). The
   static table diff and the traced dot-precision check must localize it.
2. **drop-storage-round**: one trailing row tile's storage rounding is
   deleted (its ``panel_meta`` claims a wide store), the tables pristine:
   only the meta diff or the traced missing-round check can see it.
3. **lossy-wire**: one panel's collective is moved onto a lossy f16 wire
   in an all-f32 ladder by patching the sharded-plan seam the distributed
   executor reads (``core/distributed.py``'s ``shard``), on every rank.
   The wire check must name the panel.
4. **card-route** (on the card), two mutants, each of which moves one
   16-bit pair of panel 0 off the tensor cores onto the CUDA cores.
   :func:`~repro_torch.audit.launchaudit.audit_launch_blocked`, with the
   pristine expectations, must fail through ``launch-route``, and the
   route counts the card's launches added must be the plan's with one
   pair moved from ``tc`` to ``simt``:

   * **names**: a plan whose ``panel_meta`` gives the pair the f32 name;
     ``launch-route`` must name the tile.
   * **dispatch**: the names pristine, ``panel.plan`` patched so that the
     pair's work goes to the CUDA cores (a slot of its own, the same
     rounding code). Only the route counts can see it: ``launch-route``
     must name panel 0, and ``launch-pair-name`` and
     ``launch-dot-precision``, which read the names, must stay silent.

   On the CPU nothing launches, and it reports ``selftest-skip`` at
   ``warn``.
"""
from __future__ import annotations

import contextlib

from repro_torch.audit.report import CheckResult, Violation

#: geometry of the mutations: P = 2 splits the 6-tile plan evenly, and
#: at leaf 256 the f16x3_f32 plan mixes f16 and f32 tiles
_N, _P = 1536, 2
_CFG = "f16x3_f32"


def _expect(name: str, result: CheckResult, rules: tuple,
            needle: str) -> list:
    """The mutated audit must fail via one of ``rules`` AND localize the
    mutation (``needle`` appears in some violation)."""
    hits = [v for v in result.violations if v.rule in rules]
    if not hits:
        return [Violation(
            "selftest-miss", name,
            f"seeded mutation went undetected: audit returned "
            f"{[v.rule for v in result.violations]}, expected one of "
            f"{list(rules)}")]
    blob = " ".join(str(v) + f" panel={v.panel} tile={v.tile}"
                    for v in hits)
    if needle not in blob:
        return [Violation(
            "selftest-miss", name,
            f"mutation detected but not localized: no violation names "
            f"{needle!r} (got: {blob[:300]})")]
    return []


def _copy_plan(base, cls):
    """A plan object of ``cls`` with ``base``'s tables (not its cache)."""
    plan = object.__new__(cls)
    plan.__dict__.update({k: v for k, v in base.__dict__.items()
                          if k != "_panel_meta"})
    return plan


def _mut_flip_level():
    from repro_torch.audit.conformance import audit_blocked
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.core.precision import PAPER_CONFIGS
    cfg = PAPER_CONFIGS[_CFG]
    mut = PrecisionPlan(_N, cfg)
    mut.levels = mut.levels.copy()
    i, j = mut.ntiles - 1, mut.ntiles - 2
    old = int(mut.levels[i, j])
    new = 0 if old != 0 else len(cfg.levels) - 1
    mut.levels[i, j] = mut.levels[j, i] = new
    res = audit_blocked(_N, cfg, plan=mut, label="selftest-mutant")
    return _expect(
        "flip-compute-level", res,
        ("plan-table-mismatch", "plan-dot-precision"), f"({i}, {j})")


def _no_round_plan(n, cfg, ti, tp):
    """A plan with pristine tables whose panel ``tp`` metadata stores row
    tile ``ti`` wide (its storage round deleted)."""
    from repro_torch.core.plan import PanelMeta, PrecisionPlan, build_plan

    class _NoRound(PrecisionPlan):
        def panel_meta(self, p):
            meta = PrecisionPlan.panel_meta(self, p)
            if p != tp:
                return meta
            k = ti - (p + 1)
            sn, sq = list(meta.store_names), list(meta.store_quants)
            sn[k], sq[k] = self.cfg.high_name, False
            return PanelMeta(tuple(sn), tuple(sq), meta.pair_names,
                             meta.pair_quants)
    return _copy_plan(build_plan(n, cfg), _NoRound)


def _mut_drop_round():
    from repro_torch.audit.conformance import audit_blocked
    from repro_torch.core.plan import build_plan
    from repro_torch.core.precision import PAPER_CONFIGS
    cfg = PAPER_CONFIGS[_CFG]
    ti, tp = build_plan(_N, cfg).ntiles - 1, 0    # last row tile, panel 0
    res = audit_blocked(_N, cfg, plan=_no_round_plan(_N, cfg, ti, tp),
                        label="selftest-mutant")
    return _expect(
        "drop-storage-round", res,
        ("plan-meta-mismatch", "plan-missing-round"), f"({ti}, {tp})")


class _Lossy:
    """ShardedPlan view whose panel-0 collective claims an f16 wire."""

    def __init__(self, sp):
        self._sp = sp

    def comm_name(self, j):
        return "f16" if j == 0 else self._sp.comm_name(j)

    def comm_quant(self, j):
        return False if j == 0 else self._sp.comm_quant(j)

    def __getattr__(self, k):
        return getattr(self._sp, k)


@contextlib.contextmanager
def lossy_wire():
    """Patch the sharded-plan seam of ``core/distributed.py`` so that
    panel 0 is gathered on an f16 wire."""
    from repro_torch.core import distributed as dist
    from repro_torch.core.plan import ShardedPlan
    real = dist.shard
    dist.shard = lambda plan, ns: _Lossy(ShardedPlan(plan, ns))
    try:
        yield
    finally:
        dist.shard = real


#: mutations a rank process plants by name (``conformance.dist_rank``)
SEAMS = {"lossy-wire": lossy_wire}


def _mut_lossy_wire():
    from repro_torch.audit.conformance import audit_dist
    from repro_torch.core.plan import ShardedPlan, build_plan
    from repro_torch.core.precision import PAPER_CONFIGS
    cfg = PAPER_CONFIGS["pure_f32"]     # every wire should be lossless
    pristine = ShardedPlan(build_plan(_N, cfg), _P)
    res = audit_dist(_N, cfg, _P, sharded=pristine, seam="lossy-wire")
    if any(v.rule == "dist-untestable" for v in res.violations):
        return [Violation("selftest-skip", "lossy-wire",
                          "not enough ranks to run the wire mutation",
                          severity="warn")]
    return _expect("lossy-wire", res, ("collective-wire-dtype",),
                   "panel 0")


def card_route_plan(n, cfg):
    """A plan with pristine tables whose panel 0 sends the lowest-left
    16-bit (or int8) trailing pair to the f32 name; returns the plan and
    the tile."""
    from repro_torch.core.plan import PanelMeta, PrecisionPlan, build_plan
    base = build_plan(n, cfg)
    meta0 = base.panel_meta(0)
    i, j = next((i, j) for i in reversed(range(len(meta0.pair_names)))
                for j in range(i + 1)
                if meta0.pair_names[i][j] in ("f16", "bf16", "int8"))

    class _OffRoute(PrecisionPlan):
        def panel_meta(self, p):
            meta = PrecisionPlan.panel_meta(self, p)
            if p != 0:
                return meta
            names = [list(r) for r in meta.pair_names]
            quants = [list(r) for r in meta.pair_quants]
            names[i][j], quants[i][j] = "f32", False
            return PanelMeta(meta.store_names, meta.store_quants,
                             tuple(map(tuple, names)),
                             tuple(map(tuple, quants)))
    return _copy_plan(base, _OffRoute), (1 + i, 1 + j)


@contextlib.contextmanager
def off_route_dispatch(nt: int, i: int, j: int):
    """Patch ``panel.plan`` so that pair ``(i, j)`` of a panel with ``nt``
    trailing row tiles runs on the CUDA cores though its name takes the
    tensor cores: a slot of its own, with the name's rounding code and the
    CUDA cores' kind, and the pairs by route counted as they ran."""
    from repro_torch.kernels import panel
    real = panel.plan

    def plan(pair_names, pair_quants, dtype, b, rounding=True,
             in_place=True):
        p = real(pair_names, pair_quants, dtype, b, rounding, in_place)
        s = next((s for s, pairs in enumerate(p.tc_pairs)
                  if (i, j) in pairs), None)
        if len(pair_names) != nt or s is None:
            return p
        nm, q, code, _ = p.slots[s]
        t = len(p.slots)
        nsub = b // panel.simt_tile(dtype, b)
        items = ([(i, j, t, code, panel.SUB_ALL)]
                 if rounding and panel.scaled(nm, q)
                 else [(i, j, t, code, k) for k in range(nsub * nsub)])
        return panel.Plan(
            p.slots + ((nm, q, code, panel.KIND["simt"]),),
            tuple(tuple(x for x in pairs if x != (i, j))
                  for pairs in p.tc_pairs) + ((),),
            p.simt_items + tuple(items),
            dict(p.routes, tc=p.routes["tc"] - 1,
                 simt=p.routes["simt"] + 1))
    panel._tables.cache_clear()
    panel.plan = plan
    try:
        yield
    finally:
        panel.plan = real
        panel._tables.cache_clear()


def route_shift_misses(name: str, res: CheckResult, ran: dict, want: dict,
                       needle: str, quiet: tuple = ()) -> list:
    """A card-route mutant's verdict: the audit failed through
    ``launch-route`` naming ``needle``, the card's launches counted the
    plan's pairs by route (``want``) with one moved from ``tc`` to
    ``simt`` (``ran``), and no rule in ``quiet`` fired."""
    misses = _expect(name, res, ("launch-route",), needle)
    moved = {"tc": want["tc"] - 1, "simt": want["simt"] + 1}
    if {k: ran.get(k, 0) for k in moved} != moved:
        misses.append(Violation(
            "selftest-miss", name,
            f"the card's launches counted pairs by route {ran}; the mutant "
            f"moves one of the plan's {want} from tc to simt, {moved}"))
    loud = sorted({v.rule for v in res.violations if v.rule in quiet})
    if loud:
        misses.append(Violation(
            "selftest-miss", name,
            f"{loud} fired on a mutant whose names are the plan's: the "
            "route counts alone must see it"))
    return misses


def mut_card_route(device="cuda") -> list:
    """The card-route mutants through ``audit_launch_blocked``."""
    import torch

    from repro_torch.audit.launchaudit import (audit_launch_blocked,
                                               planned_routes)
    from repro_torch.core.precision import PAPER_CONFIGS
    from repro_torch.kernels import ops
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        return [Violation("selftest-skip", "card-route",
                          f"nothing launches on {device}: the card-route "
                          "mutation runs on a CUDA device",
                          severity="warn")]
    cfg, n = PAPER_CONFIGS[_CFG], _N
    want = planned_routes(n, cfg)
    plan, tile = card_route_plan(n, cfg)
    nt, (i, j) = plan.ntiles - 1, (tile[0] - 1, tile[1] - 1)

    def run(plan, label):
        before = dict(ops.PANEL_ROUTES)
        res = audit_launch_blocked(n, cfg, plan=plan, device=device,
                                   label=label)
        return res, {k: ops.PANEL_ROUTES[k] - before[k] for k in before}
    res, ran = run(plan, "selftest-mutant[names]")
    misses = route_shift_misses("card-route[names]", res, ran, want,
                                str(tile))
    with off_route_dispatch(nt, i, j):
        res, ran = run(None, "selftest-mutant[dispatch]")
    return misses + route_shift_misses(
        "card-route[dispatch]", res, ran, want, "panel=0",
        quiet=("launch-pair-name", "launch-dot-precision"))


def run_selftest(device="cpu") -> CheckResult:
    """Run every mutation; ok iff each one was caught and localized (the
    card-route mutation only where ``device`` is a CUDA device)."""
    viols = []
    for mut in (_mut_flip_level, _mut_drop_round, _mut_lossy_wire):
        viols.extend(mut())
    viols.extend(mut_card_route(device))
    return CheckResult("selftest", "seeded-mutations", viols)
