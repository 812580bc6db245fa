"""The curated serving surface of the port — import serving names
from HERE (counterpart of ``repro.serve``).

The stack, bottom-up:

* :class:`SolverEngine` — accuracy-targeted SPD solves over a
  fingerprint-guarded factor cache (``solve`` / ``solve_batched``);
  with ``mesh=``, large matrices are factored and solved on a
  ``torch.distributed`` mesh (driven SPMD, or with rank 0 leading:
  ``lead()`` / ``follow()``).
* :class:`BatchScheduler` — cross-request batching: windowed drains or
  continuous batching (``continuous=True``; mid-flight column
  join/retire). Raises :class:`SchedulerOverload` on admission-control
  rejection.
* :class:`ServeFrontend` — tiered load shedding (degrade digits before
  rejecting) on top of the scheduler.
* :class:`SolveOptions` — the one per-request policy object every entry
  point accepts; :class:`SolveInfo` the per-request result metadata.
* :class:`MetricsTracker` — the protocol a pluggable metrics sink
  implements; :class:`InMemoryMetrics` / :class:`NullMetrics` the
  bundled implementations.

The model-serving half: :func:`prefill_step`, :func:`serve_step` and
:func:`generate` (every family of the model zoo: dense, vlm, audio, moe,
and the recurrent rwkv and hybrid, whose states ride in the caches), and
:func:`pick`, the next token from logits (greedy or sampled; audio's
[B, 1, C]).
"""
from repro_torch.serve.engine import (MeshCallError, SolveInfo,
                                      SolverEngine, generate,
                                      matrix_fingerprint, pick,
                                      prefill_step, serve_step)
from repro_torch.serve.frontend import ServeFrontend
from repro_torch.serve.metrics import (InMemoryMetrics, MetricsTracker,
                                       NullMetrics)
from repro_torch.serve.options import SolveOptions
from repro_torch.serve.scheduler import (BatchScheduler, SchedulerOverload,
                                         SolveRequest)

__all__ = [
    "BatchScheduler",
    "InMemoryMetrics",
    "MeshCallError",
    "MetricsTracker",
    "NullMetrics",
    "SchedulerOverload",
    "ServeFrontend",
    "SolveInfo",
    "SolveOptions",
    "SolveRequest",
    "SolverEngine",
    "generate",
    "matrix_fingerprint",
    "pick",
    "prefill_step",
    "serve_step",
]
