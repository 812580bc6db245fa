"""Cross-request batching scheduler for accuracy-targeted SPD solves.

Counterpart of ``repro/serve/scheduler.py``, on the port's engine: the
same grouping, ordering, admission, async and continuous loops, with torch
tensors in place of jax arrays. There is no jit boundary here; the slot
loop's sweep is a host call into :class:`~repro_torch.core.refine
.RefineStepper`.

**On a mesh-mode engine** (``SolverEngine(mesh=...)``), rank 0 of the
engine's mesh axis alone runs the scheduler, inside ``with
engine.lead():``, and every other rank of the axis runs
``engine.follow()``. JAX has one controller for the whole mesh; torch has
one per rank, and if each rank's worker formed its own batching windows,
timing could order the collectives differently on different ranks and
the run would deadlock. So rank 0 is the single controller: each
distributed engine call it makes (a windowed drain's stacked refine call)
is checked there, then broadcast to the followers with
``broadcast_object_list`` (the options, the right-hand sides, the
matrix's fingerprint) and runs on every rank in the order rank 0 made it,
the matrix scattered to the ranks by block rows; the engine serializes
rank 0's distributed calls, so the worker thread and direct callers
interleave safely. A call that fails on any rank raises
:class:`~repro_torch.serve.engine.MeshCallError` on every rank: the
worker hands it to the call's futures and serves the next window. Requests below
the engine's ``dist_threshold`` run on rank 0 alone. Leaving ``lead()``
releases the followers.

Production solve traffic is bursty and highly redundant: GP
hyperparameter sweeps, K-FAC-style optimizers and ranking backends fire
many concurrent requests against the SAME matrix. Solving them one at a
time pays a full refinement loop — O(n^2) GEMV sweeps plus a dispatch
round-trip — per request. The :class:`BatchScheduler` instead queues
requests, groups the ones that can legally share a factor (same
``cache_key`` AND the same matrix by :func:`~repro_torch.serve.engine
.matrix_fingerprint` AND the same method), stacks their right-hand sides
into one multi-RHS refine call (O(n^2) GEMM sweeps — MXU/BLAS3-shaped
instead of k GEMVs), and splits the per-column results back into
per-request ``(x, SolveInfo)`` pairs.

Per-request accuracy targets survive batching: the stacked call carries
per-column tolerances, and the refinement loop's per-column convergence
masks freeze easy columns while hard neighbors keep sweeping — a batch
is never slower in sweeps than its hardest member, and never burns
sweeps on its easiest.

Ordering guarantees (tested in tests/test_torch_serve.py):

* ``drain()`` returns a result for EVERY pending request, keyed by the
  id that ``submit`` returned.
* Groups are processed in order of their first-submitted request, and
  within a group requests keep submission order (``SolveInfo
  .batch_index`` records each request's slot).
* Groups are chunked to ``max_batch`` columns per refine call, in
  submission order.

**Async drain**: with
``max_wait_ms`` set and :meth:`BatchScheduler.start` called, a
background worker thread drains the queue continuously.
:meth:`~BatchScheduler.submit_async` returns a
:class:`concurrent.futures.Future`; the worker opens a deadline-aware
batching window when the first request of a burst arrives, keeps
collecting arrivals until the oldest pending request has waited
``max_wait_ms`` (or the window holds ``max_batch`` columns), then runs
one drain and resolves the futures. Simple admission control guards the
factor cache: a submission whose matrix would push the number of
DISTINCT pending factors past ``max_pending_factors`` (default: the
engine's ``max_cached_factors``) is rejected with
:class:`SchedulerOverload` instead of queued — a window with more
distinct matrices than cache slots would evict factors still needed by
later groups of the same window (thrash), so the backpressure lands on
the client that would cause it. (For graduated backpressure — degrade
the accuracy target before rejecting — stack a
:class:`~repro_torch.serve.frontend.ServeFrontend` on top.)

**Continuous batching**: with
``continuous=True`` the worker replaces the batching *window* with a
re-entrant slot loop (``max_batch`` slots wide) per factor group.
Converged columns RETIRE between sweeps — their request's future
resolves while neighbors keep refining — and freed slots are refilled
mid-flight from queued requests sharing the factor fingerprint, so a
request's latency tracks its own difficulty instead of the window's
slowest member. Classic IR is column-local, so a column's trajectory is
identical in either mode (tests/test_torch_serve.py pins continuous ==
window column-for-column); GMRES-IR and distributed-path requests fall
back to a windowed drain of their group (the engine asserts that no
distributed request reaches the slot loop). Per-request
``deadline_ms`` is enforced between sweeps: an expired request retires
immediately with its best-so-far iterate and ``SolveInfo
.deadline_expired`` set.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import weakref
from concurrent.futures import Future
from typing import Any

import numpy as np
import torch

from repro_torch.core.solve import as_tensor
from repro_torch.serve.engine import (SolveInfo, SolverEngine,
                                      matrix_fingerprint)
from repro_torch.serve.metrics import MetricsTracker
from repro_torch.serve.options import SolveOptions, resolve_options


class SchedulerOverload(RuntimeError):
    """Submission rejected by admission control (factor cache would
    thrash) or by the frontend's hard shedding tier. Clients should back
    off and resubmit, or raise the engine's ``max_cached_factors`` / the
    scheduler's ``max_pending_factors`` / the frontend's
    ``hard_pending``."""


@dataclasses.dataclass
class SolveRequest:
    """One queued solve: A x = b per ``options``.

    ``options`` is the fully resolved per-request policy (scalar
    ``target_digits``); ``submitted_at`` the ``time.monotonic()`` stamp
    queue latency and deadlines are measured from. The flat accessors
    (``req.target_digits`` etc.) are kept for callers that predate
    :class:`~repro_torch.serve.options.SolveOptions`.
    """

    request_id: int
    a: Any
    b: Any
    options: SolveOptions
    n_cols: int                 # 1 for a vector b, k for an (n, k) block
    submitted_at: float = 0.0   # time.monotonic() at submit

    @property
    def target_digits(self) -> float:
        return self.options.target_digits

    @property
    def method(self) -> str:
        return self.options.method

    @property
    def cache_key(self):
        return self.options.cache_key

    @property
    def deadline_ms(self):
        return self.options.deadline_ms

    @property
    def shed_tier(self) -> int:
        return self.options.shed_tier


@dataclasses.dataclass
class _LiveRequest:
    """A request currently holding slots in the continuous loop."""

    req: SolveRequest
    slots: list                  # slot indices still holding its columns
    queue_ms: float              # submit -> join latency
    deadline: float | None       # absolute monotonic deadline
    cached: bool                 # factor_cached for its SolveInfo
    hist: dict                   # col index -> [rel0, per-sweep rel, ...]
    cols: dict = dataclasses.field(default_factory=dict)
    expired: bool = False        # retired by deadline, not convergence


class BatchScheduler:
    """Request loop that batches solves sharing a factor.

    ``submit`` enqueues and returns a request id; ``drain`` processes
    the whole queue and returns ``{request_id: (x, SolveInfo)}``. The
    ``engine`` owns the factor cache, so batching composes with factor
    reuse ACROSS drains: the first drain factorizes once per distinct
    matrix, later drains hit the fingerprint-checked LRU cache.

    With ``max_wait_ms`` set, :meth:`start` spawns a background worker
    and :meth:`submit_async` returns futures — the deadline-aware async
    request loop (module docstring).
    ``drain()`` stays available for synchronous use, but don't mix the
    two styles on one scheduler instance: the worker assumes it is the
    only drainer.

    With ``continuous=True`` the worker runs the slot loop instead
    (module docstring, "Continuous batching"); ``max_wait_ms`` is then
    optional — arrivals join mid-flight, there is no window to bound.
    ``metrics`` defaults to the engine's tracker so one injected sink
    sees the whole serving stack.
    """

    def __init__(self, engine: SolverEngine | None = None, *,
                 max_batch: int | None = None,
                 max_wait_ms: float | None = None,
                 max_pending_factors: int | None = None,
                 continuous: bool = False,
                 metrics: MetricsTracker | None = None):
        self.engine = engine if engine is not None else SolverEngine()
        if max_batch is None:
            # the tuning database's serving width for this ladder and
            # device type, falling back to the untuned 32
            from repro_torch import tune
            max_batch = tune.decide(
                256, tune.ladder_key(self.engine.cfg),
                backend=self.engine.device.type,
                db=self.engine._tuning_db).max_batch
        assert max_batch >= 1, max_batch
        self.max_batch = max_batch
        #: async batching window; None = sync-only (or continuous)
        self.max_wait_ms = max_wait_ms
        #: continuous (slot-loop) worker instead of windowed drains
        self.continuous = continuous
        #: admission-control bound on distinct pending factors
        self.max_pending_factors = (
            max_pending_factors if max_pending_factors is not None
            else self.engine.max_cached_factors)
        assert self.max_pending_factors >= 1, self.max_pending_factors
        self.metrics: MetricsTracker = (metrics if metrics is not None
                                        else self.engine.metrics)
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._worker: threading.Thread | None = None
        self._stop_flag = False
        self._window_start: float | None = None
        self._futures: dict[int, Future] = {}
        self._queue: list[SolveRequest] = []
        self._fingerprints: dict[int, Any] = {}   # request_id -> fp
        self._next_id = 0
        #: results completed before a failed drain raised; merged into
        #: (and cleared by) the next drain()'s return value
        self._stashed: dict[int, tuple[Any, SolveInfo]] = {}
        #: requests abandoned by the last failed drain (the batch whose
        #: solve raised) — callers inspect these to report/resubmit;
        #: cleared by the next drain
        self.failed: list[SolveRequest] = []
        #: id(a) -> (weakref(a), fingerprint): burst traffic against one
        #: shared matrix fingerprints it once, not once per submit
        self._fp_memo: dict[int, tuple[Any, Any]] = {}

    def __len__(self) -> int:
        return len(self._queue)

    def submit(self, a, b, options: SolveOptions | None = None,
               **kw) -> int:
        """Enqueue a solve; returns the id ``drain()`` keys results by.

        Pre-``SolveOptions`` kwargs (``target_digits=``, ``method=``,
        ``cache_key=``) keep working as deprecated aliases.
        """
        opts = resolve_options(options, kw, caller="BatchScheduler.submit")
        b = as_tensor(b, self.engine.device)
        assert b.dim() in (1, 2), b.shape
        assert np.isscalar(opts.target_digits), (
            "scheduler requests carry one target each; per-column "
            "sequences belong to SolverEngine.solve_batched")
        opts = dataclasses.replace(opts,
                                   target_digits=float(opts.target_digits))
        # fingerprint at submit time so grouping can never batch two
        # different matrices that happen to share a cache_key
        fp = (opts.fingerprint if opts.fingerprint is not None
              else self._fingerprint_of(a))
        with self._cv:
            rid = self._next_id
            self._next_id += 1
            req = SolveRequest(rid, a, b, opts,
                               1 if b.dim() == 1 else b.shape[1],
                               submitted_at=time.monotonic())
            self._fingerprints[rid] = fp
            if not self._queue:
                self._window_start = time.monotonic()
            self._queue.append(req)
            self._cv.notify_all()
        return rid

    # -- async drain --------------------------------------------------------
    def submit_async(self, a, b, options: SolveOptions | None = None,
                     **kw) -> Future:
        """Enqueue a solve for the background worker; returns a Future
        resolving to ``(x, SolveInfo)``.

        Requires a running worker (:meth:`start`). Raises
        :class:`SchedulerOverload` when admission control rejects the
        request (the submission would put more distinct factors in
        flight than the factor cache holds) and ``RuntimeError`` when
        the scheduler is stopping — a submission racing :meth:`stop`
        either completes (it beat the stop flag, so the worker's final
        sweep drains it) or raises here; it is never silently dropped.
        Deprecated kwarg aliases as in :meth:`submit`.
        """
        opts = resolve_options(options, kw,
                               caller="BatchScheduler.submit_async")
        fp = (opts.fingerprint if opts.fingerprint is not None
              else self._fingerprint_of(a))
        opts = dataclasses.replace(opts, fingerprint=fp)
        with self._cv:
            assert self._worker is not None, (
                "submit_async needs the async worker: call start() first")
            if self._stop_flag:
                raise RuntimeError(
                    "scheduler is stopping; submission refused")
            self._admit((opts.cache_key, fp))
            rid = self.submit(a, b, opts)
            fut: Future = Future()
            self._futures[rid] = fut
        return fut

    def _admit(self, key):
        """Reject a NEW distinct factor when the pending set is full."""
        pending = {(r.cache_key, self._fingerprints[r.request_id])
                   for r in self._queue}
        if key not in pending and len(pending) >= self.max_pending_factors:
            raise SchedulerOverload(
                f"{len(pending)} distinct factors already pending "
                f"(max_pending_factors={self.max_pending_factors})")

    def start(self) -> None:
        """Spawn the background drain worker (idempotent)."""
        assert self.max_wait_ms is not None or self.continuous, (
            "async drain needs a batching window (max_wait_ms) or "
            "continuous=True")
        with self._cv:
            if self._worker is not None:
                if self._worker.is_alive():
                    return                   # one drainer only
                self._worker = None          # finished after a timed-out stop
            self._stop_flag = False
            self._worker = threading.Thread(
                target=self._run, name="BatchScheduler-drain", daemon=True)
            self._worker.start()

    def stop(self, timeout: float | None = None) -> None:
        """Stop the worker; pending requests are drained first.

        A :meth:`submit_async` racing this call either completes (its
        request landed before the stop flag was set, and the worker
        drains the queue before exiting — the flag is set and checked
        under the same lock as enqueue) or raises ``RuntimeError`` at
        submission; its future is never silently dropped. As a backstop,
        anything still queued with a future after the worker exits is
        drained inline here.

        If ``timeout`` expires while the worker is still mid-drain, the
        worker stays registered (and stopping): a later :meth:`start`
        is a no-op until it actually exits, so two drainers can never
        race one queue.
        """
        with self._cv:
            worker = self._worker
            if worker is None:
                return
            self._stop_flag = True
            self._cv.notify_all()
        worker.join(timeout)
        with self._cv:
            if not worker.is_alive():
                self._worker = None
        self._flush_leftovers()

    def _flush_leftovers(self):
        """Resolve futures of requests the dead worker never saw."""
        while True:
            with self._cv:
                if self._worker is not None or not any(
                        r.request_id in self._futures for r in self._queue):
                    return
            try:
                results = self.drain()
            except Exception as exc:  # noqa: BLE001 — forwarded to futures
                with self._cv:
                    for req in self.failed:
                        fut = self._futures.pop(req.request_id, None)
                        if fut is not None:
                            fut.set_exception(exc)
                continue
            with self._cv:
                for rid, out in results.items():
                    fut = self._futures.pop(rid, None)
                    if fut is not None:
                        fut.set_result(out)

    def _pending_cols(self) -> int:
        return sum(r.n_cols for r in self._queue)

    def pending_cols(self) -> int:
        """Queued RHS columns not yet in a refine loop — the load signal
        the :class:`~repro_torch.serve.frontend.ServeFrontend` sheds on."""
        with self._lock:
            return self._pending_cols()

    def _run(self):
        """Worker loop: deadline-aware batching window, then one drain.

        The window opens when the first request of a burst arrives
        (``submit`` stamps ``_window_start``) and closes when the oldest
        pending request has waited ``max_wait_ms`` or the queue holds a
        full batch — so a lone request never waits longer than the
        window, while a burst inside it batches into one refine call.
        ``continuous=True`` replaces the window with the slot loop
        (:meth:`_run_continuous`).
        """
        if self.continuous:
            return self._run_continuous()
        while True:
            with self._cv:
                while not self._queue and not self._stop_flag:
                    self._cv.wait()
                if not self._queue:         # stop requested, queue empty
                    return
                deadline = self._window_start + self.max_wait_ms / 1e3
                while (not self._stop_flag
                       and self._pending_cols() < self.max_batch):
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._cv.wait(left)
            try:
                results = self.drain()
            except Exception as exc:  # noqa: BLE001 — forwarded to futures
                with self._cv:
                    for req in self.failed:
                        fut = self._futures.pop(req.request_id, None)
                        if fut is not None:
                            fut.set_exception(exc)
                    # flush results completed before the failure straight
                    # to their futures; results of SYNC-submitted
                    # requests stay stashed for the next drain() to
                    # return. Re-queued requests ride the next window.
                    stashed, self._stashed = self._stashed, {}
                    for rid, out in stashed.items():
                        fut = self._futures.pop(rid, None)
                        if fut is not None:
                            fut.set_result(out)
                        else:
                            self._stashed[rid] = out
                continue
            with self._cv:
                for rid, out in results.items():
                    fut = self._futures.pop(rid, None)
                    if fut is not None:
                        fut.set_result(out)

    # -- continuous batching ------------------------------------------------
    def _run_continuous(self):
        """Continuous worker: head-of-queue group -> slot refine loop.

        Groups are served in order of their first-submitted request,
        like windowed drains. GMRES-IR, distributed-path and
        wider-than-the-block requests fall back to a windowed drain of
        their group (:meth:`_drain_group`) — the slot loop only accepts
        what can legally retire per column.
        """
        while True:
            with self._cv:
                while not self._queue and not self._stop_flag:
                    self._cv.wait()
                if not self._queue:         # stop requested, queue empty
                    return
                head = self._queue[0]
                key = self._group_key(head)
                n = head.b.shape[0]
                wide = head.n_cols > self.max_batch
            if head.method != "ir" or wide or self.engine._use_dist(n):
                self._drain_group(key)
            else:
                self._continuous_group(key, head.a)

    def _continuous_group(self, key, a):
        """Run one factor group through the slot loop until drained.

        Per iteration: admit queued group members into free slots
        (mid-flight join), force-retire deadline-expired requests, run
        one masked sweep, then retire converged/stalled/exhausted slots
        and resolve any request whose last column just retired. The
        loop exits when the block is empty and no matching request is
        queued.
        """
        cache_key, fp, _ = key
        stepper, base_solve, cached = self.engine.continuous_stepper(
            a, slots=self.max_batch, cache_key=cache_key, fingerprint=fp)
        state = stepper.init()
        slot_owner: list = [None] * self.max_batch   # slot -> (rid, col)
        live: dict[int, _LiveRequest] = {}
        while True:
            state = self._cb_admit(key, stepper, state, slot_owner, live,
                                   base_solve, cached)
            if not live:
                return                      # block empty, queue has no match
            state = self._cb_expire(stepper, state, slot_owner, live)
            if not live:
                continue
            if stepper.active_mask(state).any():
                state, stepped = stepper.step(state)
                self.metrics.inc("scheduler.sweeps")
                rel = state.rel.cpu().numpy()
                for s in np.flatnonzero(stepped):
                    owner = slot_owner[s]
                    if owner is not None:
                        live[owner[0]].hist[owner[1]].append(float(rel[s]))
            self.metrics.gauge(
                "scheduler.slot_occupancy",
                float(state.occ.sum()) / self.max_batch)
            done = [s for s in np.flatnonzero(stepper.done_mask(state))
                    if slot_owner[s] is not None]
            state = self._cb_retire(stepper, state, slot_owner, live, done,
                                    expired=False)

    def _cb_admit(self, key, stepper, state, slot_owner, live, base_solve,
                  cached):
        """Join queued group members into free slots (FIFO, no overtake:
        a member that doesn't fit blocks later members of ITS group so
        submission order holds; other groups are untouched)."""
        room = sum(1 for o in slot_owner if o is None)
        take: list[SolveRequest] = []
        with self._cv:
            blocked = False
            rest = []
            for r in self._queue:
                if (self._group_key(r) == key and not blocked
                        and r.n_cols <= room):
                    take.append(r)
                    room -= r.n_cols
                else:
                    if self._group_key(r) == key:
                        blocked = True
                    rest.append(r)
            if take:
                self._queue = rest
                self._cv.notify_all()
        if not take:
            return state
        now = time.monotonic()
        free = [i for i, o in enumerate(slot_owner) if o is None]
        bblk = torch.cat(
            [r.b[:, None] if r.b.dim() == 1 else r.b for r in take],
            dim=1).to(stepper.rdtype)
        x0 = base_solve(bblk)               # the window path's x0, unscaled
        tols = np.concatenate([
            np.full(r.n_cols, 10.0 ** -self.engine._clamp(r.target_digits))
            for r in take])
        used = free[:bblk.shape[1]]
        state = stepper.join(state, used, bblk, x0, tols)
        rel = state.rel.cpu().numpy()
        pos = 0
        for r in take:
            rslots = used[pos:pos + r.n_cols]
            pos += r.n_cols
            for ci, s in enumerate(rslots):
                slot_owner[s] = (r.request_id, ci)
            qms = (now - r.submitted_at) * 1e3
            live[r.request_id] = _LiveRequest(
                req=r, slots=list(rslots), queue_ms=qms,
                deadline=(r.submitted_at + r.deadline_ms / 1e3
                          if r.deadline_ms is not None else None),
                cached=cached,
                hist={ci: [float(rel[s])] for ci, s in enumerate(rslots)})
            self.metrics.observe("scheduler.queue_ms", qms)
        return state

    def _cb_expire(self, stepper, state, slot_owner, live):
        """Force-retire live requests whose deadline has passed; they
        resolve with the best iterate seen so far."""
        now = time.monotonic()
        for rid in list(live):
            lv = live[rid]
            if lv.deadline is not None and now >= lv.deadline and lv.slots:
                state = self._cb_retire(stepper, state, slot_owner, live,
                                        list(lv.slots), expired=True)
        return state

    def _cb_retire(self, stepper, state, slot_owner, live, slots, *,
                   expired):
        """Retire ``slots`` and resolve requests with no columns left."""
        if not slots:
            return state
        state, results = stepper.retire(state, slots)
        finished = set()
        for s, res in zip(slots, results):
            rid, ci = slot_owner[s]
            slot_owner[s] = None
            lv = live[rid]
            lv.slots.remove(s)
            lv.cols[ci] = res
            lv.expired = lv.expired or expired
            if not lv.slots:
                finished.add(rid)
        for rid in finished:
            self._cb_resolve(live.pop(rid))
        return state

    def _cb_resolve(self, lv: _LiveRequest):
        """Assemble ``(x, SolveInfo)`` from retired columns and resolve
        the request's future (or stash for a sync caller)."""
        req = lv.req
        k = req.n_cols
        xcols = [lv.cols[ci][0] for ci in range(k)]
        x = xcols[0] if req.b.dim() == 1 else torch.stack(xcols, dim=1)
        info = SolveInfo(
            ladder=self.engine.ladder_name, method="ir",
            sweeps=max(lv.cols[ci][2] for ci in range(k)),
            residual=max(lv.cols[ci][1] for ci in range(k)),
            converged=all(lv.cols[ci][3] for ci in range(k)),
            target_digits=self.engine._clamp(req.target_digits),
            factor_cached=lv.cached, queue_ms=lv.queue_ms,
            shed_tier=req.shed_tier, deadline_expired=lv.expired,
            history=tuple(tuple(lv.hist[ci]) for ci in range(k)))
        self.metrics.inc("scheduler.requests")
        if lv.expired:
            self.metrics.inc("scheduler.deadline_expired")
        with self._cv:
            self._fingerprints.pop(req.request_id, None)
            fut = self._futures.pop(req.request_id, None)
            if fut is None:
                self._stashed[req.request_id] = (x, info)
        if fut is not None:
            fut.set_result((x, info))

    def _drain_group(self, key):
        """Windowed drain of ONE group — the continuous worker's
        fallback for GMRES-IR / distributed / oversized requests. A
        failing chunk forwards its exception to its futures (and
        ``self.failed``) without taking down the worker."""
        with self._lock:
            take = [r for r in self._queue if self._group_key(r) == key]
            self._queue = [r for r in self._queue
                           if self._group_key(r) != key]
        for chunk in self._chunks(take):
            start = time.monotonic()
            try:
                xs, infos = self._solve_chunk(chunk)
            except Exception as exc:  # noqa: BLE001 — forwarded
                with self._cv:
                    self.failed = list(chunk)
                    for req in chunk:
                        self._fingerprints.pop(req.request_id, None)
                        fut = self._futures.pop(req.request_id, None)
                        if fut is not None:
                            fut.set_exception(exc)
                continue
            for req, x, info in zip(chunk, xs, infos):
                out = (x, self._stamp(info, req, start))
                with self._cv:
                    self._fingerprints.pop(req.request_id, None)
                    fut = self._futures.pop(req.request_id, None)
                    if fut is None:
                        self._stashed[req.request_id] = out
                if fut is not None:
                    fut.set_result(out)

    # -- shared drain plumbing ----------------------------------------------
    def _solve_chunk(self, chunk: list[SolveRequest]):
        """One stacked refine call for a chunk of grouped requests.

        Deliberately routes through the engine's kwarg-alias path (with
        the warning suppressed via ``_internal``) rather than a
        positional ``SolveOptions``: tests and tools monkeypatch
        ``engine.solve_batched`` with the kwarg-spread signature, and
        this keeps that seam stable.
        """
        return self.engine.solve_batched(
            chunk[0].a, [r.b for r in chunk],
            target_digits=[r.target_digits for r in chunk],
            method=chunk[0].method, cache_key=chunk[0].cache_key,
            fingerprint=self._fingerprints[chunk[0].request_id],
            _internal=True)

    def _stamp(self, info: SolveInfo, req: SolveRequest,
               start: float) -> SolveInfo:
        """Fill the serving-layer SolveInfo fields for one request."""
        qms = (start - req.submitted_at) * 1e3
        self.metrics.observe("scheduler.queue_ms", qms)
        self.metrics.inc("scheduler.requests")
        # a windowed drain can't interrupt a running refine call, but it
        # still reports requests whose deadline had passed before the
        # solve even started
        expired = (req.deadline_ms is not None and qms > req.deadline_ms)
        if expired:
            self.metrics.inc("scheduler.deadline_expired")
        return dataclasses.replace(info, queue_ms=qms,
                                   shed_tier=req.shed_tier,
                                   deadline_expired=expired)

    def _fingerprint_of(self, a):
        """Memoized matrix_fingerprint: the O(n) device reduction + host
        sync runs once per distinct matrix object, not once per submit.
        The weakref guard makes id() reuse after gc harmless."""
        key = id(a)
        hit = self._fp_memo.get(key)
        if hit is not None and hit[0]() is a:
            return hit[1]
        fp = matrix_fingerprint(a)
        try:
            if len(self._fp_memo) > 64:        # drop dead refs, stay small
                self._fp_memo = {k: v for k, v in self._fp_memo.items()
                                 if v[0]() is not None}
            self._fp_memo[key] = (weakref.ref(a), fp)
        except TypeError:                      # un-weakref-able input
            pass
        return fp

    def _group_key(self, req: SolveRequest):
        return (req.cache_key, self._fingerprints[req.request_id],
                req.method)

    def drain(self) -> dict[int, tuple[Any, SolveInfo]]:
        """Solve everything queued; returns ``{request_id: (x, info)}``.

        Exception-safe: if a batch fails (e.g. a client submitted a
        non-SPD matrix and the factorization raised), the exception
        propagates, but no other work is lost — results completed
        before the failure are stashed and returned by the NEXT drain,
        requests not yet attempted go back on the queue in submission
        order, and the failing batch's requests land in ``self.failed``
        for the caller to report or resubmit (they are NOT re-queued:
        retrying a deterministically failing batch would wedge every
        subsequent drain).
        """
        with self._lock:
            queue, self._queue = self._queue, []
            results, self._stashed = self._stashed, {}
            self.failed = []
        groups: list[list[SolveRequest]] = []
        index: dict[Any, int] = {}
        for req in queue:                       # FIFO by first arrival
            key = self._group_key(req)
            if key in index:
                groups[index[key]].append(req)
            else:
                index[key] = len(groups)
                groups.append([req])
        in_flight: list[SolveRequest] = []
        try:
            for members in groups:
                for chunk in self._chunks(members):
                    start = time.monotonic()
                    in_flight = chunk          # blamed if the solve raises
                    xs, infos = self._solve_chunk(chunk)
                    in_flight = []
                    for req, x, info in zip(chunk, xs, infos):
                        results[req.request_id] = (
                            x, self._stamp(info, req, start))
                        self._fingerprints.pop(req.request_id, None)
        except BaseException:
            # only a chunk whose solve actually raised is abandoned; an
            # interrupt between chunks re-queues everything unprocessed
            with self._lock:
                self.failed = list(in_flight)
                dropped = {r.request_id for r in in_flight}
                for rid in dropped:
                    self._fingerprints.pop(rid, None)
                self._stashed = results
                self._queue = [r for r in queue
                               if r.request_id not in results
                               and r.request_id not in dropped] + self._queue
            raise
        return results

    def _chunks(self, members: list[SolveRequest]):
        """Split a group so no refine call exceeds ``max_batch`` columns."""
        chunk: list[SolveRequest] = []
        width = 0
        for req in members:
            if chunk and width + req.n_cols > self.max_batch:
                yield chunk
                chunk, width = [], 0
            chunk.append(req)
            width += req.n_cols
        if chunk:
            yield chunk
