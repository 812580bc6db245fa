"""Pluggable serving metrics: a tracker protocol + default sinks.

The port's own copy of ``repro/serve/metrics.py`` (pure Python).

The engine, scheduler and frontend all emit through one small interface
(:class:`MetricsTracker`) instead of hard-wiring a telemetry backend —
the levanter ``tracker``/``callbacks`` split: call sites name *what*
happened (a counter increment, a latency observation, a gauge level) and
the injected tracker decides *where* it goes.  Production deployments
plug their own exporter; tests and the benches use the bundled
:class:`InMemoryMetrics`; the default is :class:`NullMetrics` so the hot
path pays one no-op virtual call when nobody is listening.

Emitted series:

=============================  =====  ==========================================
name                           kind   meaning
=============================  =====  ==========================================
``engine.requests``            count  RHS batches entering ``solve_batched``
``engine.factor_cache_hit``    count  cached factor reused
``engine.factor_cache_miss``   count  factorization actually ran
``engine.sweeps_per_column``   obs    refinement sweeps spent, per RHS column
``scheduler.queue_ms``         obs    submit → solve-start latency per request
``scheduler.requests``         count  requests completed (rate → req/s)
``scheduler.slot_occupancy``   gauge  occupied / total slots, per sweep
``scheduler.sweeps``           count  continuous-loop sweeps executed
``scheduler.deadline_expired`` count  requests retired at their deadline
``frontend.requests``          count  admissions through the frontend
``frontend.shed``              count  load-shed events, labelled ``tier=``
=============================  =====  ==========================================
"""
from __future__ import annotations

import threading
import time
from typing import Protocol, runtime_checkable


@runtime_checkable
class MetricsTracker(Protocol):
    """What a serving metrics sink must implement.

    Labels are keyword strings (``tracker.inc("frontend.shed", tier=2)``)
    and must have a small, bounded cardinality — implementations key
    storage on ``(name, sorted(labels))``.
    """

    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        """Add ``value`` to a monotonic counter."""
        ...

    def observe(self, name: str, value: float, **labels) -> None:
        """Record one sample of a distribution (latency, sweep count)."""
        ...

    def gauge(self, name: str, value: float, **labels) -> None:
        """Set a point-in-time level (slot occupancy, queue depth)."""
        ...


class NullMetrics:
    """Default tracker: drops everything (one no-op call per event)."""

    def inc(self, name, value=1.0, **labels):
        pass

    def observe(self, name, value, **labels):
        pass

    def gauge(self, name, value, **labels):
        pass


class _Series:
    __slots__ = ("count", "total", "min", "max", "last")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.last = 0.0

    def add(self, v: float):
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        self.last = v

    def summary(self) -> dict:
        return {"count": self.count, "mean": self.total / self.count,
                "min": self.min, "max": self.max, "last": self.last}


def _key(name: str, labels: dict):
    return (name, tuple(sorted(labels.items()))) if labels else (name, ())


class InMemoryMetrics:
    """Thread-safe in-process tracker with a one-shot summary view.

    Counters additionally remember their first/last increment times so
    :meth:`snapshot` can derive rates (``scheduler.requests`` →
    ``req_per_s``) without the caller timing anything.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict = {}
        self._spans: dict = {}          # counter key -> (first_ts, last_ts)
        self._series: dict = {}
        self._gauges: dict = {}

    def inc(self, name, value=1.0, **labels):
        k = _key(name, labels)
        now = time.monotonic()
        with self._lock:
            self._counters[k] = self._counters.get(k, 0.0) + value
            first, _ = self._spans.get(k, (now, now))
            self._spans[k] = (first, now)

    def observe(self, name, value, **labels):
        k = _key(name, labels)
        with self._lock:
            self._series.setdefault(k, _Series()).add(float(value))

    def gauge(self, name, value, **labels):
        with self._lock:
            self._gauges[_key(name, labels)] = float(value)

    @staticmethod
    def _fmt(k):
        name, labels = k
        if not labels:
            return name
        return name + "{" + ",".join(f"{a}={b}" for a, b in labels) + "}"

    def counter(self, name, **labels) -> float:
        with self._lock:
            return self._counters.get(_key(name, labels), 0.0)

    def snapshot(self) -> dict:
        """Summary dict: counters, per-series stats, gauges and rates."""
        with self._lock:
            out = {
                "counters": {self._fmt(k): v
                             for k, v in self._counters.items()},
                "observations": {self._fmt(k): s.summary()
                                 for k, s in self._series.items()},
                "gauges": {self._fmt(k): v for k, v in self._gauges.items()},
                "rates": {},
            }
            for k, (first, last) in self._spans.items():
                if last > first:
                    out["rates"][self._fmt(k) + "_per_s"] = (
                        self._counters[k] / (last - first))
        return out
