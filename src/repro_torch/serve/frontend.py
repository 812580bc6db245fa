"""Tiered-load-shedding service front for the batch scheduler.

Counterpart of ``repro/serve/frontend.py`` (pure Python over the port's
scheduler).

The raw :class:`~repro_torch.serve.scheduler.BatchScheduler` has one
backpressure lever: admission control raises
:class:`~repro_torch.serve.scheduler.SchedulerOverload` and the client gets
nothing. Production serving wants a *graduated* response — the paper's
whole pitch is that accuracy is a knob, so the first thing to give up
under load is DIGITS, not availability. :class:`ServeFrontend` keys
three tiers off the scheduler's queue depth (pending RHS columns, via
:meth:`~repro_torch.serve.scheduler.BatchScheduler.pending_cols`):

========  =========================  =====================================
tier      depth                      behavior
========  =========================  =====================================
0         ``< soft_pending``         admit as requested
1         ``[soft_pending,           admit with ``target_digits`` capped
          hard_pending)``            at ``degraded_digits`` (cheaper:
                                     fewer refinement sweeps per column);
                                     ``SolveInfo.shed_tier == 1``
2         ``>= hard_pending``        reject with ``SchedulerOverload``
========  =========================  =====================================

Tier 1 is load shedding a refinement server can uniquely afford: a
degraded request still returns a correct solve, just to fewer digits —
each dropped digit saves O(n^2 k) sweep work — and ``shed_tier`` in its
:class:`~repro_torch.serve.engine.SolveInfo` tells the client to resubmit
later if full accuracy matters. Every decision is counted on the
metrics tracker (``frontend.shed`` labelled by tier).
"""
from __future__ import annotations

import dataclasses

from repro_torch.serve.metrics import MetricsTracker
from repro_torch.serve.options import SolveOptions, resolve_options
from repro_torch.serve.scheduler import BatchScheduler, SchedulerOverload


class ServeFrontend:
    """Deadline- and load-aware admission front over a scheduler.

    ``soft_pending`` / ``hard_pending`` are queue depths in RHS columns
    (the unit the scheduler batches in); ``degraded_digits`` is the
    accuracy floor tier 1 degrades to — requests already asking for
    less keep their own target. ``metrics`` defaults to the scheduler's
    tracker, so one injected sink observes engine, scheduler and
    frontend together.
    """

    def __init__(self, scheduler: BatchScheduler, *,
                 soft_pending: int, hard_pending: int,
                 degraded_digits: float = 4.0,
                 metrics: MetricsTracker | None = None):
        assert 0 < soft_pending <= hard_pending, (soft_pending, hard_pending)
        self.scheduler = scheduler
        self.soft_pending = soft_pending
        self.hard_pending = hard_pending
        self.degraded_digits = degraded_digits
        self.metrics: MetricsTracker = (metrics if metrics is not None
                                        else scheduler.metrics)

    def shed_tier(self) -> int:
        """The tier a submission arriving NOW would be assigned."""
        depth = self.scheduler.pending_cols()
        if depth >= self.hard_pending:
            return 2
        return 1 if depth >= self.soft_pending else 0

    def submit(self, a, b, options: SolveOptions | None = None, **kw):
        """Admit through the shedding tiers; returns the scheduler's
        Future. Tier 2 raises :class:`SchedulerOverload`; tier 1 admits
        with the accuracy target capped at ``degraded_digits`` and
        ``SolveInfo.shed_tier`` set so the client can tell. Deprecated
        kwarg aliases as on the scheduler entry points.
        """
        opts = resolve_options(options, kw, caller="ServeFrontend.submit")
        tier = self.shed_tier()
        self.metrics.inc("frontend.requests")
        if tier == 2:
            self.metrics.inc("frontend.shed", tier=2)
            raise SchedulerOverload(
                f"{self.scheduler.pending_cols()} columns pending "
                f"(hard_pending={self.hard_pending})")
        if tier == 1:
            self.metrics.inc("frontend.shed", tier=1)
            opts = dataclasses.replace(
                opts, shed_tier=1,
                target_digits=min(float(opts.target_digits),
                                  self.degraded_digits))
        return self.scheduler.submit_async(a, b, opts)
