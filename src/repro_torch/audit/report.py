"""Violation report schema of the port's precision-conformance auditor.

The port's own copy of ``repro/audit/report.py`` (``repro_torch`` imports
nothing of the JAX package), with the same JSON layout, so that a report
of ``python -m repro_torch.audit --json out.json`` passes the reference's
``validate_report`` and ``tools/perf_gate.py audit`` unchanged.
Stdlib-only: :mod:`repro_torch.audit.lint` emits :class:`Violation` rows
from AST analysis alone. Severity is two-valued: ``error`` fails the
audit (the CLI exits nonzero), ``warn`` is informational (a check that
cannot run here, such as a launch audit on the CPU, where nothing
launches).

Report JSON layout::

    {"schema": 1, "mode": "smoke", "device": "cpu",
     "checks": [{"name": "...", "target": "...", "violations": 0}, ...],
     "violations": [{"rule": "...", "target": "...", "message": "...",
                     "severity": "error", "panel": 1, "tile": [2, 1],
                     "path": null, "line": null}, ...],
     "summary": {"checks": N, "violations": N, "errors": N, "warns": N}}

``device`` is the port's addition (the device the audit ran on);
``validate_report`` checks only the reference's keys and accepts it.
"""
from __future__ import annotations

import dataclasses
import json

SCHEMA_VERSION = 1

SEVERITIES = ("error", "warn")


@dataclasses.dataclass
class Violation:
    """One conformance failure, attributed as precisely as possible."""

    rule: str               # e.g. "plan-dot-precision", "kernel-smem-budget"
    target: str             # what was audited: "blocked[n=1024,f16x3_f32]"
    message: str            # human-readable finding
    severity: str = "error"
    panel: int | None = None    # panel index, when attributable
    tile: tuple | None = None   # (i, j) leaf-tile index, when attributable
    path: str | None = None     # source file (lint rules)
    line: int | None = None     # source line (lint rules)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if self.tile is not None:
            d["tile"] = list(self.tile)
        return d

    def __str__(self):
        where = ""
        if self.panel is not None:
            where += f" panel={self.panel}"
        if self.tile is not None:
            where += f" tile={tuple(self.tile)}"
        if self.path is not None:
            where += f" {self.path}:{self.line}"
        return (f"[{self.severity}] {self.rule} @ {self.target}{where}: "
                f"{self.message}")


@dataclasses.dataclass
class CheckResult:
    """One named check over one target, with its violations."""

    name: str
    target: str
    violations: list

    @property
    def ok(self) -> bool:
        return not any(v.severity == "error" for v in self.violations)


def build_report(mode: str, results: list,
                 device: str | None = None) -> dict:
    """Assemble the schema'd JSON payload from CheckResults."""
    violations = [v for r in results for v in r.violations]
    report = {
        "schema": SCHEMA_VERSION,
        "mode": mode,
        "checks": [{"name": r.name, "target": r.target,
                    "violations": len(r.violations)} for r in results],
        "violations": [v.to_dict() for v in violations],
        "summary": {
            "checks": len(results),
            "violations": len(violations),
            "errors": sum(v.severity == "error" for v in violations),
            "warns": sum(v.severity == "warn" for v in violations),
        },
    }
    if device is not None:
        report["device"] = device
    return report


def validate_report(payload) -> list:
    """Structural validation of a report payload (list of error strings,
    empty = valid), as ``tools/perf_gate.py audit`` runs it."""
    errs = []
    if not isinstance(payload, dict):
        return [f"report is not an object: {type(payload).__name__}"]
    if payload.get("schema") != SCHEMA_VERSION:
        errs.append(f"schema != {SCHEMA_VERSION}: {payload.get('schema')!r}")
    if not isinstance(payload.get("mode"), str):
        errs.append(f"mode missing or not a string: {payload.get('mode')!r}")
    checks = payload.get("checks")
    if not isinstance(checks, list) or not checks:
        errs.append("checks empty or not a list")
        checks = []
    for i, c in enumerate(checks):
        if not isinstance(c, dict) or not {"name", "target",
                                           "violations"} <= set(c):
            errs.append(f"check {i} malformed: {c!r}")
    viols = payload.get("violations")
    if not isinstance(viols, list):
        errs.append("violations not a list")
        viols = []
    for i, v in enumerate(viols):
        if not isinstance(v, dict):
            errs.append(f"violation {i} not an object: {v!r}")
            continue
        for k in ("rule", "target", "message", "severity"):
            if not isinstance(v.get(k), str):
                errs.append(f"violation {i}: field {k!r} missing/not str")
        if v.get("severity") not in SEVERITIES:
            errs.append(f"violation {i}: bad severity {v.get('severity')!r}")
    summary = payload.get("summary")
    if not isinstance(summary, dict):
        errs.append("summary missing")
    else:
        for k in ("checks", "violations", "errors", "warns"):
            if not isinstance(summary.get(k), int):
                errs.append(f"summary.{k} missing/not int")
        if isinstance(viols, list) and isinstance(summary.get("violations"),
                                                  int) \
                and summary["violations"] != len(viols):
            errs.append(f"summary.violations={summary['violations']} != "
                        f"len(violations)={len(viols)}")
    return errs


def load_report(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
