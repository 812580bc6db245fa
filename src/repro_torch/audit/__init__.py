"""Precision-conformance auditor of the port: does what ran match the plan?

Counterpart of ``repro/audit``. Checks in six modules:

* :mod:`repro_torch.audit.dtypeflow` — dtype flow of the ATen graph of a
  port entry point traced on CPU tensors (which products run at which
  effective precision, where values are rounded),
* :mod:`repro_torch.audit.conformance` — reconciles the traced flows, and
  the distributed path's wire counters, against ``PrecisionPlan`` /
  ``ShardedPlan``,
* :mod:`repro_torch.audit.launchaudit` — what the card actually launched:
  the kernels, operand types, plan names and routes of every
  :mod:`repro_torch.kernels.ops` call (the counterpart of the reference's
  compiled-HLO checks),
* :mod:`repro_torch.audit.kernelaudit` — static checks of the CUDA
  kernels (accumulator types, shared memory and registers, index bounds),
* :mod:`repro_torch.audit.lint` — AST layering rules (stdlib-only),
* :mod:`repro_torch.audit.selftest` — seeded mutations proving detection.

Run ``python -m repro_torch.audit --device cpu`` here, or ``python -m
repro_torch.audit --full --selftest`` on the card.

This ``__init__`` stays import-light on purpose: it re-exports the
stdlib-only report schema and nothing else.
"""
from repro_torch.audit.report import (  # noqa: F401
    SCHEMA_VERSION, CheckResult, Violation, build_report, load_report,
    validate_report,
)
