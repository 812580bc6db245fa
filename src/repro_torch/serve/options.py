"""The consolidated per-request option surface for solve serving.

The port's own copy of ``repro/serve/options.py`` (pure Python; the port
imports nothing of the JAX package).

Every serving entry point — :meth:`SolverEngine.solve`,
:meth:`SolverEngine.solve_batched`, :meth:`BatchScheduler.submit`,
:meth:`BatchScheduler.submit_async` (and the :class:`ServeFrontend` on
top of them) — accepts one :class:`SolveOptions` value instead of the
per-call kwarg spread that used to drift between them (``target_digits``
here, ``fingerprint`` there, ``method`` everywhere).  The old keyword
arguments keep working as deprecated aliases through
:func:`resolve_options`; each use emits a :class:`DeprecationWarning`
pointing at the replacement.

The dataclass is frozen so a single options value can be shared across
requests and threads; per-request variation goes through
``dataclasses.replace`` (or the deprecated kwargs, which do exactly
that under the hood).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Sequence


@dataclasses.dataclass(frozen=True)
class SolveOptions:
    """Per-request solve policy, uniform across all serving entry points.

    ``target_digits`` may be a sequence only for
    :meth:`SolverEngine.solve_batched` (one target per RHS in the
    batch); everywhere else it is a scalar.  ``deadline_ms`` is honored
    by the continuous-batching scheduler: a request whose deadline
    expires mid-loop retires with its best-so-far iterate and
    ``SolveInfo.deadline_expired`` set (windowed drains record it but
    cannot interrupt a running refine call).  ``fingerprint`` is the
    cache hint callers that already ran
    :func:`~repro_torch.serve.engine.matrix_fingerprint` pass to skip the
    redundant O(n) device round-trip.  ``shed_tier`` is stamped by the
    :class:`~repro_torch.serve.frontend.ServeFrontend` when tiered load
    shedding degraded this request (tier 1); it rides through to
    ``SolveInfo.shed_tier``.
    """

    target_digits: float | Sequence[float] = 6.0
    method: str = "ir"                  # "ir" | "gmres"
    cache_key: Any = None
    fingerprint: Any = None             # precomputed matrix_fingerprint
    deadline_ms: float | None = None    # continuous-mode deadline
    col_tol: Any = None                 # explicit per-column tolerances
    shed_tier: int = 0                  # stamped by the frontend

    def __post_init__(self):
        assert self.method in ("ir", "gmres"), self.method
        assert self.shed_tier in (0, 1, 2), self.shed_tier
        if self.deadline_ms is not None:
            assert self.deadline_ms >= 0, self.deadline_ms


#: kwargs accepted as deprecated aliases by every entry point
DEPRECATED_KWARGS = ("target_digits", "method", "cache_key",
                     "fingerprint", "deadline_ms", "col_tol")


def resolve_options(options: SolveOptions | None, kwargs: dict, *,
                    caller: str) -> SolveOptions:
    """Merge an explicit :class:`SolveOptions` with deprecated kwargs.

    ``kwargs`` is the caller's ``**kw`` catch-all; any key from
    :data:`DEPRECATED_KWARGS` is applied on top of ``options`` (or the
    defaults) with one :class:`DeprecationWarning` per call.  Unknown
    keys raise ``TypeError`` — exactly what the old explicit signatures
    did.

    ``_internal=True`` in ``kwargs`` suppresses the warning: the serve
    stack's own layers route through the alias path on purpose (so
    tests and tools that monkeypatch the kwarg-spread entry-point
    signatures keep working) and must not spam the client's warning
    filters for it.
    """
    opts = options if options is not None else SolveOptions()
    internal = bool(kwargs.pop("_internal", False))
    if not kwargs:
        return opts
    unknown = sorted(set(kwargs) - set(DEPRECATED_KWARGS))
    if unknown:
        raise TypeError(
            f"{caller}() got unexpected keyword argument(s) {unknown}; "
            f"per-request policy lives on repro_torch.serve.SolveOptions")
    if not internal:
        warnings.warn(
            f"{caller}(**{{{', '.join(sorted(kwargs))}}}) uses deprecated "
            "keyword aliases; pass repro_torch.serve.SolveOptions "
            "instead",
            DeprecationWarning, stacklevel=3)
    return dataclasses.replace(opts, **kwargs)
