"""Plan-conformance checks over traced graphs and the distributed wire.

Counterpart of ``repro/audit/conformance.py``. ``audit_blocked``,
``audit_solve`` and ``audit_refine`` trace one port entry point on CPU
tensors (:func:`repro_torch.audit.dtypeflow.trace`; ``kernels.ops`` runs
the plain versions there), and reconcile the result against the static
expectations of :class:`repro_torch.core.plan.PrecisionPlan`:

* ``audit_blocked``: every product's effective precision and every
  storage-round event of ``blocked_potrf`` matches the plan's per-tile
  compute and storage levels (FLOPs and rounded elements compared
  *exactly*, by dtype); the executed plan's tables and ``panel_meta``
  agree with the pristine ``build_plan`` geometry (this is what names the
  exact tile when a mutated plan sneaks in); no f16<->bf16 double round
  and no promotion wider than the container.
* ``audit_solve`` / ``audit_refine``: the triangular solves and the
  refinement loop are lossless: every product wide, no rounding event.
* ``audit_dist``: the distributed panel sweep cannot be traced (its
  collectives are ``torch.distributed`` calls), so it runs
  ``dist_cholesky`` on P gloo ranks (``repro_torch.launch``) and
  reconciles what each rank handed each collective, the port's own wire
  counters (``distributed.WIRE``) and the collectives in the order they
  were called, against ``ShardedPlan``: P diagonal blocks, P - 1 panel
  gathers whose dtype matches ``ShardedPlan.comm_name(j)`` panel by
  panel, and one f32 scale where ``comm_quant(j)`` holds.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from repro_torch.audit import dtypeflow
from repro_torch.audit.report import CheckResult, Violation
from repro_torch.core.dtypes import BYTES
from repro_torch.core.plan import (PanelMeta, PrecisionPlan, ShardedPlan,
                                   build_plan)
from repro_torch.core.precision import PrecisionConfig

#: ladder names that cross a compressed wire in their own dtype
_NARROW_WIRE = ("f16", "bf16", "int8")


def _inputs(*shapes, dtype=torch.float32):
    """Placeholder CPU tensors for a shape-only (fake) trace."""
    return tuple(torch.empty(s, dtype=dtype) for s in shapes)


def _diff_tables(plan_exec, pristine, target: str) -> list:
    """Exact-tile diff of an executed plan against the pristine geometry."""
    out = []
    for attr, what in (("levels", "compute"), ("store_levels", "storage")):
        a = np.asarray(getattr(plan_exec, attr))
        b = np.asarray(getattr(pristine, attr))
        if a.shape != b.shape:
            out.append(Violation(
                "plan-table-mismatch", target,
                f"{what}-level table shape {a.shape} != plan {b.shape}"))
            continue
        for i, j in zip(*np.nonzero(a != b)):
            if j > i:
                continue            # mirrored upper triangle
            out.append(Violation(
                "plan-table-mismatch", target,
                f"{what} level of tile ({i}, {j}) is {int(a[i, j])} "
                f"({plan_exec.cfg.name_at(int(a[i, j]))}), plan says "
                f"{int(b[i, j])} ({pristine.cfg.name_at(int(b[i, j]))})",
                tile=(int(i), int(j))))
    return out


def meta_diff(p: int, got: PanelMeta, want: PanelMeta, target: str,
              rule: str, what: str) -> list:
    """Tile-by-tile diff of one panel's metadata against another's."""
    out = []
    for k, (g, w) in enumerate(zip(got.store_names, want.store_names)):
        if g != w:
            out.append(Violation(
                rule, target,
                f"panel {p}: storage round of tile ({p + 1 + k}, {p}) is "
                f"{g!r} {what}, plan tables say {w!r}", panel=p,
                tile=(p + 1 + k, p)))
    for i, (gr, wr) in enumerate(zip(got.pair_names, want.pair_names)):
        for j, (g, w) in enumerate(zip(gr, wr)):
            if g != w and j <= i:
                out.append(Violation(
                    rule, target,
                    f"panel {p}: trailing pair ({p + 1 + i}, {p + 1 + j}) "
                    f"computes at {g!r} {what}, plan tables say {w!r}",
                    panel=p, tile=(p + 1 + i, p + 1 + j)))
    if not out and got != want:
        out.append(Violation(rule, target,
                             f"panel {p}: quant flags differ from plan "
                             "tables", panel=p))
    return out


def _diff_meta(plan_exec, target: str) -> list:
    """Cross-check the executed plan's ``panel_meta`` (what the blocked
    schedule actually consumes) against its own level tables: catches a
    schedule that drops or rewrites a storage round without touching the
    tables."""
    out = []
    for p in range(plan_exec.ntiles - 1):
        got = plan_exec.panel_meta(p)
        want = PrecisionPlan._build_panel_meta(plan_exec, p)
        if got != want:
            out += meta_diff(p, got, want, target, "plan-meta-mismatch",
                             "in the executed schedule")
    return out


def _attribute_panels(plan_exec, pristine, container, kind) -> str:
    """Name the panels whose expectations differ (trace-level findings
    can only localize to the panel granularity)."""
    bad = []
    for p in range(pristine.ntiles - 1):
        if kind == "dots":
            a = plan_exec.panel_dot_flops(p, container)
            b = pristine.panel_dot_flops(p, container)
        else:
            a = plan_exec.panel_round_elems(p, container)
            b = pristine.panel_round_elems(p, container)
        if a != b:
            bad.append(p)
    return f" (panels {bad})" if bad else ""


def _flow_violations(res, pristine, plan_exec, container, target) -> list:
    out = []
    got_dots = res.dot_flops_by_name()
    want_dots = pristine.expected_dot_flops(container)
    if got_dots != want_dots:
        where = _attribute_panels(plan_exec, pristine, container, "dots")
        for nm in sorted(set(got_dots) | set(want_dots)):
            g, w = got_dots.get(nm, 0.0), want_dots.get(nm, 0.0)
            if g != w:
                out.append(Violation(
                    "plan-dot-precision", target,
                    f"{nm} GEMM flops traced={g:.0f} planned={w:.0f}"
                    + where))
    got_r = res.round_elems_by_name()
    want_r = pristine.expected_round_elems(container)
    if got_r != want_r:
        where = _attribute_panels(plan_exec, pristine, container, "rounds")
        for nm in sorted(set(got_r) | set(want_r)):
            g, w = got_r.get(nm, 0), want_r.get(nm, 0)
            if g < w:
                out.append(Violation(
                    "plan-missing-round", target,
                    f"{nm} storage-round events cover {g} elements, plan "
                    f"requires {w}" + where))
            elif g > w:
                out.append(Violation(
                    "plan-extra-round", target,
                    f"{nm} storage-round events cover {g} elements, plan "
                    f"allows only {w}" + where))
    for r in res.double_rounds():
        out.append(Violation(
            "double-rounding", target,
            f"value on the {r.prev} grid re-rounded to {r.name} "
            f"({r.elems} elements): incommensurate 16-bit grids"))
    cw = BYTES[container]
    for src, dst, elems in res.promotions:
        if BYTES.get(dst, 0) > cw:
            out.append(Violation(
                "promotion", target,
                f"unplanned {src}->{dst} promotion of {elems} elements "
                f"(container is {container})"))
    return out


def audit_blocked(n: int, cfg: PrecisionConfig, *, plan=None,
                  label: str | None = None, flow=None) -> CheckResult:
    """Dtype-flow conformance of ``blocked_potrf`` at size ``n``.

    ``plan`` overrides the executed plan (the mutation self-test's
    injection point); expectations always come from the pristine
    ``build_plan(n, cfg)``. ``flow`` receives the traced
    :class:`~repro_torch.audit.dtypeflow.FlowResult` (a list to append
    to), for callers that compare it with another walker's.
    """
    from repro_torch.core.blocked import blocked_potrf
    target = label or f"blocked[n={n},{cfg.describe()}]"
    pristine = build_plan(n, cfg)
    plan_exec = plan if plan is not None else pristine
    container = cfg.high_name
    viols = _diff_tables(plan_exec, pristine, target)
    viols += _diff_meta(plan_exec, target)
    (a,) = _inputs((n, n), dtype=cfg.high_dtype)
    res = dtypeflow.trace(blocked_potrf, a, cfg=cfg, plan=plan_exec)
    if flow is not None:
        flow.append(res)
    viols += _flow_violations(res, pristine, plan_exec, container, target)
    return CheckResult("blocked-conformance", target, viols)


def audit_solve(n: int, cfg: PrecisionConfig) -> CheckResult:
    """The triangular solves (of 8 right-hand sides) must be lossless:
    O(n^2) work, so any narrow product or rounding event there costs
    digits for nothing."""
    from repro_torch.core.blocked import blocked_trsm_left
    target = f"trsm[n={n},{cfg.describe()}]"
    b, l = _inputs((n, 8), (n, n), dtype=cfg.high_dtype)
    viols = []
    for trans in (False, True):
        res = dtypeflow.trace(
            lambda bb, ll: blocked_trsm_left(bb, ll, cfg, trans=trans),
            b, l)
        for nm, f in res.dot_flops_by_name().items():
            if nm != cfg.high_name:
                viols.append(Violation(
                    "solve-narrow", target,
                    f"trans={trans} solve runs {f:.0f} GEMM flops at "
                    f"{nm}; solves must stay at {cfg.high_name}"))
        rr = res.round_elems_by_name()
        if rr:
            viols.append(Violation(
                "solve-narrow", target,
                f"trans={trans} solve emits rounding events {rr}; the "
                "solve path must not round"))
    return CheckResult("solve-conformance", target, viols)


def audit_refine(n: int, cfg: PrecisionConfig) -> CheckResult:
    """The refinement loop (given a factor; two sweeps of 4 right-hand
    sides) must be lossless outside the factor itself: residuals and
    corrections never round narrow. The loop reads its residuals' values
    (convergence), so it is traced on a real system of the paper's
    matrix."""
    from repro_torch.core.blocked import blocked_potrf, diag_tri_inv
    from repro_torch.core.refine import RefineConfig, iterative_refine
    from repro_torch.launch.drive import spd_matrix
    target = f"refine[n={n},{cfg.describe()}]"
    a = spd_matrix(n, 17, cfg.high_dtype, "cpu")
    rhs = torch.ones((n, 4), dtype=cfg.high_dtype)
    l = blocked_potrf(a, cfg)
    linvs = diag_tri_inv(l, cfg)
    rcfg = RefineConfig(max_sweeps=2, tol=0.0)
    res = dtypeflow.trace(
        lambda aa, bb, ll, li: iterative_refine(
            aa, bb, cfg, rcfg, l=ll, linvs=li).x,
        a, rhs, l, linvs, mode="real")
    viols = []
    for nm, f in res.dot_flops_by_name().items():
        if nm != cfg.high_name and nm != "f64":
            viols.append(Violation(
                "refine-narrow", target,
                f"refinement sweep runs {f:.0f} GEMM flops at {nm}; "
                f"sweeps must stay at >= {cfg.high_name}"))
    rr = res.round_elems_by_name()
    if rr:
        viols.append(Violation(
            "refine-narrow", target,
            f"refinement sweep emits rounding events {rr}"))
    return CheckResult("refine-conformance", target, viols)


# ---------------------------------------------------------------------------
# the distributed wire
# ---------------------------------------------------------------------------
def wire_name(sp: ShardedPlan, j: int, compress: bool) -> str:
    """The dtype panel j's solved block crosses the wire in: the comm
    name where the wire is compressed and the name narrow, else the
    container's."""
    name = sp.comm_name(j)
    return name if compress and name in _NARROW_WIRE else sp.cfg.high_name


def wire_expectation(cfg: PrecisionConfig, n: int, nshards: int, *,
                     broadcast_diag_only: bool = True,
                     compress: bool = True, sharded=None) -> dict:
    """Bytes each rank hands each collective in one ``dist_cholesky``, by
    dtype, from the sharded plan alone (the shape of
    ``distributed.WIRE``): the (w, w) diagonal block of every panel
    (broadcast, or all-gathered with the other ranks' blocks), and for
    every panel but the last the solved block at ``wire_name`` (16-bit
    2 bytes an element, int8 1, the container's dtype raw) with one f32
    scale where ``comm_quant`` says so."""
    sp = sharded or ShardedPlan(build_plan(n, cfg), nshards)
    w, high = n // nshards, cfg.high_name
    want: dict = {"all_gather": {}, "broadcast": {}, "scatter": {}}

    def add(op, name, nbytes):
        want[op][name] = want[op].get(name, 0) + nbytes
    for _ in range(nshards):
        add("broadcast" if broadcast_diag_only else "all_gather", high,
            w * w * BYTES[high])
    for j in range(nshards - 1):
        name = wire_name(sp, j, compress)
        add("all_gather", name, w * w * BYTES[name])
        if name != high and sp.comm_quant(j):
            add("all_gather", "f32", 4)
    return want


@contextlib.contextmanager
def record_collectives(into: list):
    """Log every counted collective of ``repro_torch.core.distributed``
    (``(op, dtype name, shape)`` in call order) while the context is open;
    what the collectives move and count is unchanged."""
    from repro_torch.core import distributed
    real = distributed._count

    def counting(op, t):
        into.append((op, distributed._NAMES[t.dtype], tuple(t.shape)))
        return real(op, t)
    distributed._count = counting
    try:
        yield into
    finally:
        distributed._count = real


def dist_rank(n: int, cfg: PrecisionConfig, nshards: int, compress: bool,
              seam=None) -> dict:
    """One rank of :func:`audit_dist` (run by ``repro_torch.launch``):
    ``dist_cholesky`` of the paper's matrix on the CPU, with the
    collectives logged; ``seam`` names a mutation of
    :mod:`repro_torch.audit.selftest` to plant first."""
    from repro_torch.core import distributed
    from repro_torch.launch import make_mesh
    from repro_torch.launch.drive import spd_matrix
    mesh = make_mesh((nshards,), ("model",), device_type="cpu")
    a = spd_matrix(n, 5, torch.float32, "cpu")
    log: list = []
    with contextlib.ExitStack() as stack:
        if seam is not None:
            from repro_torch.audit import selftest
            stack.enter_context(selftest.SEAMS[seam]())
        stack.enter_context(record_collectives(log))
        distributed.reset_wire()
        distributed.dist_cholesky(
            distributed.shard_rows(a, mesh), mesh, cfg,
            broadcast_diag_only=True, compress_comm=compress)
    return {"wire": {op: dict(v) for op, v in distributed.WIRE.items()},
            "log": log}


def wire_violations(rank: int, got: dict, sp: ShardedPlan, n: int, *,
                    compress: bool, target: str) -> list:
    """One rank's collectives (``got``: :func:`dist_rank`'s result)
    against the sharded plan: the wire counters by collective and dtype,
    then the logged collectives panel by panel (the diagonal blocks
    broadcast from their owners)."""
    P, high = sp.nshards, sp.cfg.high_name
    w = n // P
    viols = []
    want = wire_expectation(sp.cfg, n, P, compress=compress, sharded=sp)
    if got["wire"] != want:
        viols.append(Violation(
            "collective-wire-dtype", target,
            f"rank {rank} handed the collectives {got['wire']} bytes by "
            f"dtype; the sharded plan prescribes {want}"))
    diag_op = "broadcast"
    log = [e for e in got["log"] if e[0] != "scatter"]
    blocks = [e for e in log if e[2] == (w, w)]
    scales = [e for e in log if e[0] == "all_gather" and e[2] == (1,)]
    # per panel: its diagonal block, then (all but the last) its gather
    diags, gathers = blocks[0::2], blocks[1::2]
    if len(diags) != P or any(d[0] != diag_op or d[1] != high
                              for d in diags):
        viols.append(Violation(
            "collective-count", target,
            f"rank {rank}: diagonal blocks {diags}, schedule has {P} "
            f"{high} {diag_op}s"))
    if len(gathers) != P - 1:
        viols.append(Violation(
            "collective-count", target,
            f"rank {rank}: {len(gathers)} (w, w) panel gathers, schedule "
            f"has {P - 1}"))
    expect_scales = 0
    for j, g in enumerate(gathers[:P - 1]):
        want_wire = wire_name(sp, j, compress)
        if g[0] != "all_gather" or g[1] != want_wire:
            viols.append(Violation(
                "collective-wire-dtype", target,
                f"rank {rank}: panel {j} gathered on a {g[1]} wire "
                f"({g[0]}); plan comm level is {sp.comm_name(j)} => "
                f"{want_wire} wire", panel=j))
        expect_scales += int(want_wire != high and sp.comm_quant(j))
    if len(scales) != expect_scales:
        viols.append(Violation(
            "collective-count", target,
            f"rank {rank}: {len(scales)} scale gathers, the quantized "
            f"schedule has {expect_scales}"))
    for op, name, shape in log:
        if BYTES.get(name, 0) > BYTES[high]:
            viols.append(Violation(
                "promotion", target,
                f"rank {rank}: {op} moves {name} (shape {shape}); nothing "
                f"in the distributed sweep is planned wider than {high}"))
    return viols


def audit_dist(n: int, cfg: PrecisionConfig, nshards: int, *,
               compress: bool = True, sharded=None,
               seam=None) -> CheckResult:
    """Wire conformance of ``dist_cholesky`` (diagonal blocks broadcast
    from their owners) on ``nshards`` gloo ranks of this machine's CPU,
    one rank a core.

    ``sharded`` overrides the *expected* schedule source, for the
    self-test, whose ranks run a patched one (``seam``); normally the
    expectations come from ``ShardedPlan(build_plan(n, cfg), nshards)``.
    """
    from repro_torch.launch import launch
    target = (f"dist[n={n},P={nshards},{cfg.describe()}"
              f"{'' if compress else ',raw-wire'}]")
    avail = os.cpu_count() or 1
    if avail < nshards:
        return CheckResult("dist-conformance", target, [Violation(
            "dist-untestable", target,
            f"only {avail} ranks available, need {nshards}",
            severity="warn")])
    sp = sharded or ShardedPlan(build_plan(n, cfg), nshards)
    results = launch(dist_rank, nshards,
                     (n, cfg, nshards, compress, seam),
                     device="cpu", timeout=300)
    viols = []
    for rank, got in enumerate(results):
        viols += wire_violations(rank, got, sp, n, compress=compress,
                                 target=target)
    return CheckResult("dist-conformance", target, viols)
