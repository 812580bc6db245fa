"""What the card launched: the kernels, operand types, plan names and routes.

Counterpart of ``repro/audit/hloaudit.py``. The reference re-checks what
the compiler emitted for the traced program, and tightens its per-dtype
dot checks to errors on MXU backends. The port runs its narrow arithmetic
inside hand-written CUDA called through ``ctypes``, which no tracer sees,
so its counterpart of "what actually ran" is the kernel launches, read
where the port dispatches them:

* :func:`record` is a context manager that wraps the entry points of
  :mod:`repro_torch.kernels.ops` and records each outermost call: its
  kernel, the operands' dtypes and shapes, the plan metadata it was
  given (``panel_update``'s ``pair_names`` / ``store_names``), and the
  launches and routes the call added to the ``ops`` counters (the routes
  ``panel.plan`` and ``qgemm.plan`` took). It changes nothing that
  ``ops`` computes or counts.
* :func:`audit_launch_blocked` runs one blocked factor on the card and
  reconciles its products' FLOPs by name, from the names the launches
  were given, against ``plan.expected_dot_flops`` exactly; every 16-bit
  or int8 pair of an f32 container at leaf 128 or 256 must have run on
  ``tc`` and every other pair on ``simt``, panel by panel; every
  ``potrf_leaf`` and ``tri_inv_leaf`` in the high dtype.
* :func:`audit_launch_solve`: every ``qgemm`` of both sweeps in the high
  dtype on a ``simt_*`` route.
* :func:`audit_launch_refine`: ``residual_fused`` runs in f64 with
  f64 residuals, and the sweeps' solves stay wide.

On CPU tensors nothing launches: these checks then return
``launch-untestable`` at severity ``warn``, never a clean pass.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch

from repro_torch.audit.dtypeflow import ladder_name
from repro_torch.audit.report import CheckResult, Violation
from repro_torch.core.plan import _eff, build_plan
from repro_torch.core.precision import PrecisionConfig
from repro_torch.launch.drive import spd_matrix

#: the ops entry points the recorder wraps
ENTRIES = ("potrf", "tri_inv", "tri_inv_batched", "qgemm", "trsm", "syrk",
           "residual", "panel_update", "flash_attention",
           "flash_attention_bshd")
#: pair names the tensor cores take in an f32 container, and their
#: leaves: the policy stated here, apart from ``kernels/panel.py``'s own
#: table, so that the audit does not hold the kernel to itself
TC_NAMES = ("f16", "bf16", "int8")
TC_LEAVES = (128, 256)


@dataclasses.dataclass
class Launch:
    """One outermost ``ops`` call."""

    entry: str              # the ops function
    dtypes: tuple           # ladder names of the tensor operands
    shapes: tuple
    on_card: bool
    meta: dict              # plan names and options the call was given
    launches: dict          # ops.LAUNCHES added, by kernel
    routes: dict            # route counts added: {counter: {route: n}}


def _counters():
    from repro_torch.kernels import ops
    return {"launches": ops.LAUNCHES, "panel": ops.PANEL_ROUTES,
            "qgemm": ops.QGEMM_ROUTES, "trsm": ops.TRSM_ROUTES,
            "syrk_packed": ops.SYRK_PACKED_ROUTES, "flash": ops.FLASH_ROUTES}


def _delta(before, after) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


_META_KEYS = ("store_names", "store_quants", "pair_names", "pair_quants",
              "out_dtype", "trans_b")


@contextlib.contextmanager
def record(into: list):
    """Record every outermost call of the ``ops`` entry points into
    ``into`` (a list of :class:`Launch`) while the context is open."""
    from repro_torch.kernels import ops
    real = {name: getattr(ops, name) for name in ENTRIES}
    depth = [0]

    def wrap(name, fn):
        @functools.wraps(fn)
        def recorded(*args, **kwargs):
            if depth[0]:
                return fn(*args, **kwargs)
            before = {k: dict(v) for k, v in _counters().items()}
            depth[0] += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                depth[0] -= 1
            after = _counters()
            tensors = [a for a in list(args) + list(kwargs.values())
                       if torch.is_tensor(a)]
            meta = {k: (ladder_name(v) if isinstance(v, torch.dtype) else v)
                    for k, v in kwargs.items() if k in _META_KEYS}
            routes = {k: _delta(before[k], after[k]) for k in after
                      if k != "launches"}
            into.append(Launch(
                name, tuple(ladder_name(t.dtype) for t in tensors),
                tuple(tuple(t.shape) for t in tensors),
                any(t.device.type == "cuda" for t in tensors), meta,
                _delta(before["launches"], after["launches"]),
                {k: v for k, v in routes.items() if v}))
            return out
        return recorded

    for name, fn in real.items():
        setattr(ops, name, wrap(name, fn))
    try:
        yield into
    finally:
        for name, fn in real.items():
            setattr(ops, name, fn)


def _untestable(name, target, device) -> CheckResult:
    return CheckResult(name, target, [Violation(
        "launch-untestable", target,
        f"nothing launches on {device}: the launch audit runs on a CUDA "
        "device", severity="warn")])


def _card(device) -> bool:
    return torch.device(device).type == "cuda" and torch.cuda.is_available()


def tc_route(name: str, container: str, b: int) -> bool:
    """The route policy the launches are held to: the tensor cores for a
    16-bit or int8 pair of an f32 container at leaf 128 or 256."""
    return container == "f32" and name in TC_NAMES and b in TC_LEAVES


def pair_routes(pair_names, container: str, b: int) -> dict:
    """One panel's lower pairs by the route their names take."""
    out = {"tc": 0, "simt": 0}
    for i, row in enumerate(pair_names):
        for nm in row[:i + 1]:
            out["tc" if tc_route(nm, container, b) else "simt"] += 1
    return out


def planned_routes(n: int, cfg: PrecisionConfig) -> dict:
    """The pristine plan's pairs by route over one blocked factor."""
    plan, out = build_plan(n, cfg), {"tc": 0, "simt": 0}
    for p in range(plan.ntiles - 1):
        for k, v in pair_routes(plan.panel_meta(p).pair_names,
                                cfg.high_name, cfg.leaf).items():
            out[k] += v
    return out


def panel_flops(store_names, pair_names, container: str, b: int) -> dict:
    """One panel update's products by effective name, from the names it
    was given: a 2 b^3 TRSM a trailing row tile at its storage name and a
    2 b^3 product a lower pair at its compute name
    (``PrecisionPlan.panel_dot_flops``)."""
    f = 2.0 * float(b) ** 3
    out: dict = {}
    for nm in store_names:
        nm = _eff(nm, container)
        out[nm] = out.get(nm, 0.0) + f
    for i, row in enumerate(pair_names):
        for nm in row[:i + 1]:
            nm = _eff(nm, container)
            out[nm] = out.get(nm, 0.0) + f
    return out


def blocked_violations(calls: list, n: int, cfg: PrecisionConfig,
                       target: str) -> list:
    """The recorded launches of one blocked factor against the pristine
    plan: counts and dtypes of the leaf kernels, each panel's names tile
    by tile, its pairs by route, and the FLOPs by name exactly."""
    from repro_torch.audit.conformance import meta_diff
    from repro_torch.core.plan import PanelMeta
    pristine = build_plan(n, cfg)
    T, b, high = pristine.ntiles, cfg.leaf, cfg.high_name
    viols = []
    by = {}
    for c in calls:
        by.setdefault(c.entry, []).append(c)
    if any(not c.on_card for c in calls):
        viols.append(Violation("launch-untestable", target,
                               "a call ran on the CPU", severity="warn"))
    for entry, kernel, want in (("potrf", "potrf_leaf", T),
                                ("tri_inv", "tri_inv_leaf", T - 1),
                                ("panel_update", "panel_update", T - 1)):
        got = by.get(entry, [])
        launched = sum(c.launches.get(kernel, 0) for c in got)
        if len(got) != want or launched != want:
            viols.append(Violation(
                "launch-count", target,
                f"{len(got)} {entry} calls launched {launched} {kernel}; "
                f"the schedule has {want}"))
        for c in got:
            if c.entry != "panel_update" and set(c.dtypes) != {high}:
                viols.append(Violation(
                    "launch-dtype", target,
                    f"{kernel} ran on {c.dtypes} operands; the diagonal "
                    f"leaves run in the high dtype {high}"))
    flops: dict = {}
    for p, c in enumerate(by.get("panel_update", [])):
        m = c.meta
        got_meta = PanelMeta(tuple(m["store_names"]),
                             tuple(m["store_quants"]),
                             tuple(map(tuple, m["pair_names"])),
                             tuple(map(tuple, m["pair_quants"])))
        if p < T - 1:
            viols += meta_diff(p, got_meta, pristine.panel_meta(p), target,
                               "launch-pair-name", "in the launch")
            want_names = pristine.panel_meta(p).pair_names
        else:
            want_names = got_meta.pair_names
        if set(c.dtypes) != {high}:
            viols.append(Violation(
                "launch-dtype", target,
                f"panel {p}: panel_update ran on {c.dtypes}; the container "
                f"is {high}", panel=p))
        for nm, f in panel_flops(got_meta.store_names, got_meta.pair_names,
                                 high, b).items():
            flops[nm] = flops.get(nm, 0.0) + f
        # the pairs by route the kernel counted, against the route each
        # pair's planned name must take
        ran = c.routes.get("panel", {})
        want = pair_routes(want_names, high, b)
        if {k: ran.get(k, 0) for k in want} != want:
            moved = [(p + 1 + i, p + 1 + j)
                     for i, row in enumerate(want_names)
                     for j, nm in enumerate(row[:i + 1])
                     if tc_route(nm, high, b) != tc_route(
                         got_meta.pair_names[i][j], high, b)]
            viols.append(Violation(
                "launch-route", target,
                f"panel {p}: pairs by route {ran}, the plan's names need "
                f"{want}" + (f"; tiles {moved} left their route"
                             if moved else ""), panel=p,
                tile=moved[0] if moved else None))
    want_flops = pristine.expected_dot_flops(high)
    if flops != want_flops:
        for nm in sorted(set(flops) | set(want_flops)):
            g, w = flops.get(nm, 0.0), want_flops.get(nm, 0.0)
            if g != w:
                viols.append(Violation(
                    "launch-dot-precision", target,
                    f"{nm} products of the launches: {g:.0f} FLOPs, the "
                    f"plan prices {w:.0f}"))
    return viols


def audit_launch_blocked(n: int, cfg: PrecisionConfig, *, plan=None,
                         device="cuda", label: str | None = None
                         ) -> CheckResult:
    """One blocked factor of the paper's matrix on the card, its launches
    against the pristine plan; ``plan`` overrides the executed plan (the
    card-route mutation's seam)."""
    from repro_torch.core.blocked import blocked_potrf
    target = label or f"launch-blocked[n={n},{cfg.describe()}]"
    if not _card(device):
        return _untestable("launch-blocked", target, device)
    a = spd_matrix(n, 31, cfg.high_dtype, device)
    calls: list = []
    with record(calls):
        blocked_potrf(a, cfg, plan=plan)
        torch.cuda.synchronize()
    return CheckResult("launch-blocked", target,
                       blocked_violations(calls, n, cfg, target))


def _qgemm_violations(calls, high: str, target: str, what: str) -> list:
    viols = []
    for c in calls:
        if c.entry not in ("qgemm", "trsm"):
            continue
        routes = c.routes.get("qgemm", {})
        out = c.meta.get("out_dtype", high)
        if (set(c.dtypes) != {high} or out != high
                or any(not r.startswith("simt") for r in routes)):
            viols.append(Violation(
                "solve-narrow", target,
                f"{what}: qgemm on {c.dtypes} operands, out {out}, routes "
                f"{routes}; the solves run in {high} on the CUDA cores"))
    return viols


def audit_launch_solve(n: int, cfg: PrecisionConfig, *,
                       device="cuda") -> CheckResult:
    """Both sweeps of a blocked solve of 16 right-hand sides on the card:
    every ``qgemm`` in the high dtype on a ``simt_*`` route, 2 T - 1 of
    them a sweep."""
    from repro_torch.core.blocked import (blocked_potrf, blocked_trsm_left,
                                          diag_tri_inv)
    target = f"launch-solve[n={n},{cfg.describe()}]"
    if not _card(device):
        return _untestable("launch-solve", target, device)
    high = cfg.high_dtype
    l = blocked_potrf(spd_matrix(n, 32, high, device), cfg)
    b = torch.ones((n, 16), dtype=high, device=device)
    linvs = diag_tri_inv(l, cfg)
    viols, T = [], n // cfg.leaf
    for trans in (False, True):
        calls: list = []
        with record(calls):
            blocked_trsm_left(b, l, cfg, trans=trans, linvs=linvs)
            torch.cuda.synchronize()
        what = "back sweep" if trans else "forward sweep"
        viols += _qgemm_violations(calls, cfg.high_name, target, what)
        got = sum(c.launches.get("qgemm", 0) for c in calls)
        if got != 2 * T - 1 or any(c.entry != "qgemm" for c in calls):
            viols.append(Violation(
                "launch-count", target,
                f"{what}: {got} qgemm launches in "
                f"{sorted({c.entry for c in calls})}; the schedule has "
                f"{2 * T - 1}"))
    return CheckResult("launch-solve", target, viols)


def audit_launch_refine(n: int, cfg: PrecisionConfig, *,
                        device="cuda") -> CheckResult:
    """Two refinement sweeps of 4 right-hand sides on the card with f64
    residuals and a given factor: every ``residual_fused`` launch in
    f64, the solves' ``qgemm`` wide, and no factor kernel."""
    from repro_torch.core.blocked import blocked_potrf, diag_tri_inv
    from repro_torch.core.refine import RefineConfig, iterative_refine
    target = f"launch-refine[n={n},{cfg.describe()},residual=f64]"
    if not _card(device):
        return _untestable("launch-refine", target, device)
    high = cfg.high_dtype
    a = spd_matrix(n, 33, high, device)
    l = blocked_potrf(a, cfg)
    linvs = diag_tri_inv(l, cfg)
    rhs = torch.ones((n, 4), dtype=high, device=device)
    rcfg = RefineConfig(max_sweeps=2, tol=0.0, residual_dtype="f64")
    calls: list = []
    with record(calls):
        iterative_refine(a, rhs, cfg, rcfg, l=l, linvs=linvs)
        torch.cuda.synchronize()
    viols = _qgemm_violations(calls, cfg.high_name, target, "sweep")
    res = [c for c in calls if c.entry == "residual"]
    if not res or any(c.launches.get("residual_fused", 0) != 1 for c in res):
        viols.append(Violation(
            "launch-count", target,
            f"{len(res)} residual calls launched "
            f"{sum(c.launches.get('residual_fused', 0) for c in res)} "
            "residual_fused; every sweep forms one"))
    for c in res:
        if set(c.dtypes) != {"f64"}:
            viols.append(Violation(
                "refine-narrow", target,
                f"residual_fused ran on {c.dtypes}; the residuals are f64"))
    factor = [c.entry for c in calls if c.entry in ("potrf", "panel_update")]
    if factor:
        viols.append(Violation(
            "refine-narrow", target,
            f"the sweeps launched factor kernels {factor}"))
    return CheckResult("launch-refine", target, viols)
