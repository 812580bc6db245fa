"""Serving engine, in torch: batched prefill + decode, and
accuracy-targeted SPD solve serving.

Counterpart of ``repro/serve/engine.py``. ``prefill_step`` /
``serve_step`` are one full-sequence forward and one decode step of the
model zoo (the dense family; the others are ROADMAP A12); ``generate`` is
the host loop around them: prefill a prompt batch, then greedy or sampled
decoding. ``serve_step`` writes the new position into the caches in
place (the reference returns new arrays).

``SolverEngine`` is the linear-algebra side: SPD solve requests carry a
per-request ACCURACY TARGET (decimal digits of relative residual) instead
of naming a precision ladder. The engine factorizes in its cheap ladder
once per matrix, caches the factor, and spends iterative-refinement
sweeps — O(n^2) each — to reach the requested digits.

A ladder with ``engine="auto"`` is resolved per problem size against the
tuning database (:mod:`repro_torch.tune`; ``tuning_db=`` injects one,
else the packaged database of the engine's device type).

Mesh mode (``SolverEngine(mesh=...)``) factors and solves large matrices
on a ``torch.distributed`` mesh (:mod:`repro_torch.core.distributed`);
:class:`SolverEngine` says how its ranks are driven.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import distributed as D
from repro_torch.core.blocked import diag_tri_inv
from repro_torch.core.precision import PAPER_CONFIGS, PrecisionConfig
from repro_torch.core.refine import (RefineConfig, RefineResult,
                                     RefineStepper, gmres_operator,
                                     refine_operator, scaled_solve)
from repro_torch.core.solve import (as_tensor, cholesky_padded,
                                    refine_solve, solve_factored)
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig
from repro_torch.serve.metrics import MetricsTracker, NullMetrics
from repro_torch.serve.options import SolveOptions, resolve_options


def prefill_step(params, batch, cfg: ModelConfig):
    """Full-sequence forward; returns (last_logits [B, V] f32, caches)."""
    logits, _, caches = T.forward(params, batch, cfg, mode="prefill",
                                  last_only=True)
    return logits[:, -1], caches


def serve_step(params, caches, tokens, pos, cfg: ModelConfig):
    """One decode step. tokens: [B, 1]; pos: the absolute position (int).
    Returns (logits [B, V], caches), the caches updated in place."""
    logits, _, caches = T.forward(params, {"tokens": tokens}, cfg,
                                  mode="decode", caches=caches, pos=pos)
    return logits[:, 0], caches


def generate(params, prompt_batch, cfg: ModelConfig, *, n_tokens: int,
             temperature: float = 0.0, rng=None):
    """Greedy (``temperature == 0``) or sampled generation: prefill the
    prompt batch, then ``n_tokens - 1`` decode steps. Runs where the
    parameters lie. ``rng`` is a ``torch.Generator`` on that device, needed
    for sampling. Returns the new tokens, [B, n_tokens] int64."""
    S = prompt_batch["tokens"].shape[1]
    last, caches = prefill_step(params, prompt_batch, cfg)
    caches = T.pad_caches(caches, S + n_tokens)
    outs = []
    tok = _pick(last, temperature, rng)
    outs.append(tok)
    for i in range(1, n_tokens):
        logits, caches = serve_step(params, caches, tok, S + i - 1, cfg)
        tok = _pick(logits, temperature, rng)
        outs.append(tok)
    return torch.cat(outs, dim=1)


def _pick(logits, temperature, rng):
    """logits: [B, V] -> next token [B, 1]: argmax, or a draw from
    ``softmax(logits / temperature)`` with ``rng`` (the reference folds
    the step index into its key; a generator advances instead)."""
    if temperature > 0:
        if rng is None:
            raise ValueError("sampling (temperature > 0) needs rng")
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=rng)
    return torch.argmax(logits, dim=-1)[:, None]


def matrix_fingerprint(a, samples: int = 8):
    """Cheap identity check for a cached factor: shape, dtype, trace and a
    strided sample of the diagonal and first row, as f32 bytes.

    O(n): the diagonal and the sampled row are brought to the host and
    summed there, so a matrix gets the same fingerprint whether it is
    given as a numpy array or as a tensor on any device, and a reused
    ``cache_key`` with other matrix data is never served a stale factor.
    """
    if not torch.is_tensor(a):
        a = torch.as_tensor(np.asarray(a))
    n = a.shape[0]
    stride = max(1, n // samples)
    diag = torch.diagonal(a).cpu()
    probe = torch.cat([
        diag[::stride].reshape(-1),
        a[0, ::stride].cpu().reshape(-1),
        diag.sum()[None],
    ]).to(torch.float32)
    return (tuple(a.shape), str(a.dtype).replace("torch.", ""),
            probe.numpy().tobytes())


def _stack(bs):
    """Right-hand sides as one (n, k) block."""
    return torch.cat([b[:, None] if b.dim() == 1 else b for b in bs], dim=1)


def _strip_history(h):
    """Nan-padded ``[sweeps+1, k]`` history -> per-column float tuples,
    so the windowed and continuous paths hand back the same trajectory
    for the same column."""
    return tuple(tuple(float(v) for v in col[~np.isnan(col)])
                 for col in h.T)


@dataclasses.dataclass
class SolveInfo:
    """Per-request serving metadata returned next to the solution.

    ``queue_ms``/``shed_tier``/``deadline_expired`` are stamped by the
    serving layer (scheduler/frontend); direct engine calls leave their
    defaults. ``history[j]`` is the relative-residual trajectory of this
    request's column ``j``: the pre-refinement residual, then one entry
    per sweep that column ran.
    """

    ladder: str                 # PAPER_CONFIGS key actually used
    method: str                 # "ir" | "gmres"
    sweeps: int                 # refinement sweeps spent
    residual: float             # achieved relative residual
    converged: bool
    target_digits: float        # digits actually targeted (post-clamp)
    factor_cached: bool         # True if the factor was reused
    batch_size: int = 1         # requests sharing this refine call
    batch_index: int = 0        # this request's slot in the batch
    distributed: bool = False   # factor/solves ran on the engine's mesh
    queue_ms: float = 0.0       # submit -> solve-start latency
    shed_tier: int = 0          # 0 = as requested, 1 = degraded target
    deadline_expired: bool = False  # retired at its deadline, best-so-far
    history: tuple = ()         # per-column residual trajectories


class MeshCallError(RuntimeError):
    """A mesh-mode engine call that failed on some rank, raised on every
    rank of the mesh axis. The ranks are still in step: the next call
    runs."""


def _why(exc) -> str | None:
    return None if exc is None else f"{type(exc).__name__}: {exc}"


class SolverEngine:
    """Serve SPD solves against a per-request accuracy target.

    Clients ask for *digits* (``-log10`` of the relative residual), not a
    ladder: the engine factorizes in its cheap ladder and buys accuracy
    with refinement sweeps. Targets beyond the residual precision's floor
    are clamped: ``residual_dtype="f32"`` (the default) caps at 7 digits,
    ``"f64"`` at 14. The reference picks between the two by JAX's x64
    switch; here the engine is told.

    Factors are cached under a caller-provided ``cache_key`` with a
    :func:`matrix_fingerprint` of their matrix (a reused key with another
    matrix refactorizes), LRU-bounded by ``max_cached_factors`` and
    guarded by one lock shared with the scheduler's worker thread.
    :meth:`solve_batched` stacks many right-hand sides sharing a factor
    into ONE multi-RHS refine call with per-column accuracy targets.

    Matrices and right-hand sides given as numpy arrays go to ``device``
    (the card unless ``device="cpu"``); tensors stay where they are.

    **Mesh mode**: with ``mesh=`` (a ``DeviceMesh``; ``dist_axis`` names
    its axis), matrices at or above ``dist_threshold`` whose order divides
    the axis size times the leaf are factorized by
    :func:`~repro_torch.core.distributed.dist_cholesky` and every
    refinement sweep's correction solve runs distributed too, with every
    residual formed from the request's own matrix, block row by block
    row; the factor cache then holds the block-row-sharded L (a
    ``DTensor``, no ``linvs``). ``dist_threshold=None`` and
    ``dist_compress=None`` take the tuning database's values for the
    mesh's ``nshards`` (without an entry: 2048 and compressed). Smaller or
    non-divisible matrices stay on the single-device path;
    ``SolveInfo.distributed`` says which path served a request. The ranks
    of the axis are driven in one of two ways:

    * SPMD: every rank makes the same engine calls with the same
      arguments in the same order (as with ``dist_cholesky``);
    * rank 0 leads: rank 0 alone takes requests (its
      :class:`~repro_torch.serve.scheduler.BatchScheduler`, or direct
      calls) inside ``with engine.lead():``, while every other rank runs
      :meth:`follow`. The leader checks each distributed call (shapes,
      options) and then broadcasts it to the followers (the options, the
      right-hand sides, the fingerprint), and it runs on all ranks in the
      order the leader made it, the request's matrix scattered to them by
      block rows; leaving ``lead()`` releases the followers. Requests
      below the threshold run on rank 0 alone.

    Either way, the ranks of a distributed call first agree that each can
    run it and whether each holds its factor (a factor any rank lacks is
    made again on all), and last that each ran it. A call that failed on
    a rank raises :class:`MeshCallError` on every rank, and the next call
    runs. A rank that fails between two collectives leaves the others
    waiting until the group's timeout; the engine then refuses every later
    distributed call, and :meth:`follow` ends with the error.
    """

    #: digits attainable by the residual precision (with ~1 digit margin)
    _FLOOR_DIGITS = {"f32": 7.0, "f64": 14.0}

    def __init__(self, ladder: str | PrecisionConfig = "bf16_f32", *,
                 max_sweeps: int = 10, gmres_restart: int = 16,
                 max_cached_factors: int = 16, residual_dtype: str = "f32",
                 device="cuda", mesh=None, dist_threshold: int | None = None,
                 dist_axis: str = "model", dist_compress: bool | None = None,
                 tuning_db=None, metrics: MetricsTracker | None = None):
        if isinstance(ladder, str):
            self.ladder_name = ladder
            self.cfg = PAPER_CONFIGS[ladder]
        else:
            self.ladder_name = ladder.describe()
            self.cfg = ladder
        assert residual_dtype in self._FLOOR_DIGITS, residual_dtype
        self.residual_dtype = residual_dtype
        self.device = torch.device(device)
        self.max_sweeps = max_sweeps
        self.gmres_restart = gmres_restart
        assert max_cached_factors >= 1, max_cached_factors
        self.max_cached_factors = max_cached_factors
        self.mesh = mesh
        #: None = the tuning database's threshold for the mesh's nshards
        #: (2048 without an entry); an int pins it
        self.dist_threshold = dist_threshold
        self.dist_axis = dist_axis
        #: None = the tuning database's choice; a bool pins it
        self.dist_compress = dist_compress
        if mesh is not None:
            assert dist_axis in mesh.mesh_dim_names, (dist_axis, mesh)
        #: True on rank 0 inside lead(): distributed calls go to followers
        self._leading = False
        #: True inside follow(): the calls come from rank 0
        self._following = False
        #: why the ranks fell out of step; set, no distributed call runs
        self._broken: str | None = None
        #: serializes rank 0's distributed calls (scheduler worker and
        #: direct callers), so followers see them in execution order
        self._mesh_lock = threading.RLock()
        #: injected TuningDB (tests); None = the packaged database of the
        #: device type
        self._tuning_db = tuning_db
        #: pluggable metrics sink, shared by the scheduler/frontend
        #: stacked on this engine unless overridden
        self.metrics: MetricsTracker = (metrics if metrics is not None
                                        else NullMetrics())
        #: cache_key -> (fingerprint, padded factor, diag-tile inverses),
        #: most-recently-used last; in mesh mode a large matrix's entry is
        #: (fingerprint, sharded L, None); guarded by ``_cache_lock``
        self._factors: collections.OrderedDict = collections.OrderedDict()
        #: (cache_key, fingerprint, slots) -> (RefineStepper, base_solve)
        self._steppers: collections.OrderedDict = collections.OrderedDict()
        self._cache_lock = threading.RLock()

    def _tuned(self, n: int, nshards: int = 1):
        """Tuning-database decision for ``(n, ladder, nshards)`` on the
        engine's device type (:mod:`repro_torch.tune`)."""
        from repro_torch import tune
        return tune.decide(n, tune.ladder_key(self.cfg), nshards,
                           backend=self.device.type, db=self._tuning_db)

    def _nshards(self) -> int:
        from repro_torch.launch.mesh import axis_size
        return axis_size(self.mesh, self.dist_axis)

    def _use_dist(self, n: int) -> bool:
        """True when a size-``n`` solve takes the distributed path:
        deterministic in ``n``, so the factor cache and the solves agree on
        what a cached factor is."""
        if self.mesh is None:
            return False
        nshards = self._nshards()
        if n % (nshards * self.cfg.leaf) != 0:
            return False
        thr = self.dist_threshold
        if thr is None:
            thr = self._tuned(n, nshards).dist_threshold
        return n >= thr

    def _cfg_for(self, n: int) -> PrecisionConfig:
        """Per-size engine resolution for ``engine="auto"`` configs.

        Factorization and every later solve against the cached factor
        route through this, so both always agree on the engine (and thus
        on whether ``linvs`` exist for the factor).
        """
        if self.cfg.engine != "auto":
            return self.cfg
        nshards = self._nshards() if self._use_dist(n) else 1
        return dataclasses.replace(self.cfg,
                                   engine=self._tuned(n, nshards).engine)

    def _rcfg(self, **kw) -> RefineConfig:
        return RefineConfig(max_sweeps=self.max_sweeps,
                            gmres_restart=self.gmres_restart,
                            residual_dtype=self.residual_dtype, **kw)

    def _clamp(self, target_digits: float) -> float:
        return min(float(target_digits),
                   self._FLOOR_DIGITS[self.residual_dtype])

    def _factorize(self, a):
        """Leaf-padded factor + the blocked engine's diagonal-tile
        inverses, so every refinement sweep's pair of triangular solves
        reuses the one-off leaf inversions (None for the tree engine,
        whose solves invert their leaves, as in the reference)."""
        a = as_tensor(a, self.device)
        cfg = self._cfg_for(a.shape[-1])
        l = cholesky_padded(a, cfg)
        linvs = diag_tri_inv(l, cfg) if cfg.engine == "blocked" else None
        return l, linvs

    def factor(self, a, cache_key=None, *, fingerprint=None):
        """Factorize (or fetch the cached factor for) ``a``; returns
        ``(l, linvs, cached)``. A hit is served only when the stored
        fingerprint matches ``a``; insertions evict least-recently-used
        entries beyond ``max_cached_factors``. ``fingerprint`` skips the
        fingerprinting for callers that already ran it. In mesh mode a
        large matrix's factor is the block-row-sharded L (no ``linvs``),
        and the call is collective (SPMD, or inside :meth:`lead`)."""
        if self._use_dist(a.shape[-1]):
            return self._dist_call(a, cache_key, fingerprint)
        if cache_key is None:
            l, linvs = self._factorize(a)
            self.metrics.inc("engine.factor_cache_miss")
            return l, linvs, False
        fp = fingerprint if fingerprint is not None else matrix_fingerprint(a)
        hit = self._lookup(cache_key, fp)
        if hit is not None:
            self.metrics.inc("engine.factor_cache_hit")
            return hit[0], hit[1], True
        self.metrics.inc("engine.factor_cache_miss")
        l, linvs = self._factorize(a)
        self._store(cache_key, fp, l, linvs)
        return l, linvs, False

    def _lookup(self, cache_key, fp):
        """``(l, linvs)`` of ``cache_key`` when its fingerprint is ``fp``
        (a hit, now most recently used), else None."""
        if cache_key is None:
            return None
        with self._cache_lock:
            hit = self._factors.get(cache_key)
            if hit is None or hit[0] != fp:
                return None
            self._factors.move_to_end(cache_key)
            return hit[1], hit[2]

    def _store(self, cache_key, fp, l, linvs) -> None:
        with self._cache_lock:
            self._factors[cache_key] = (fp, l, linvs)
            self._factors.move_to_end(cache_key)
            while len(self._factors) > self.max_cached_factors:
                self._factors.popitem(last=False)

    def evict(self, cache_key):
        with self._cache_lock:
            self._factors.pop(cache_key, None)
            for k in [k for k in self._steppers if k[0] == cache_key]:
                self._steppers.pop(k)

    def cached_keys(self):
        """Cache keys currently held, least-recently-used first."""
        with self._cache_lock:
            return list(self._factors)

    def solve(self, a, b, options: SolveOptions | None = None, **kw):
        """Solve A x = b per ``options``; returns ``(x, SolveInfo)``. For
        an (n, k) ``b`` the SolveInfo aggregates across columns (max
        sweeps/residual, all-converged). Deprecated kwargs
        (``target_digits=``, ``method=``, ``cache_key=``) still work."""
        opts = resolve_options(options, kw, caller="SolverEngine.solve")
        xs, infos = self.solve_batched(a, [b], opts)
        return xs[0], infos[0]

    def solve_batched(self, a, bs, options: SolveOptions | None = None,
                      **kw):
        """Solve A x_i = b_i for a batch of right-hand sides sharing one
        factor: all are stacked into ONE multi-RHS refine call whose
        per-column tolerances encode each request's target
        (``options.target_digits``, a scalar or one per request). Returns
        ``(xs, infos)`` aligned with ``bs``; each x keeps its input arity
        and comes back in the residual precision. In mesh mode a large
        matrix's call is collective (SPMD, or inside :meth:`lead`) and
        every rank gets the whole x."""
        opts = resolve_options(options, kw,
                               caller="SolverEngine.solve_batched")
        bs = [as_tensor(b, self.device) for b in bs]
        assert bs, "solve_batched needs at least one RHS"
        n = bs[0].shape[0]
        for b in bs:
            assert b.dim() in (1, 2) and b.shape[0] == n, b.shape
        if self._use_dist(n):
            return self._dist_call(a, opts.cache_key, opts.fingerprint, bs,
                                   opts)
        cols, digits, col_tol, rcfg = self._columns(bs, opts)
        a = as_tensor(a, self.device)
        l, linvs, cached = self.factor(a, opts.cache_key,
                                       fingerprint=opts.fingerprint)
        res = refine_solve(a, _stack(bs), self._cfg_for(n), refine=rcfg,
                           l=l, col_tol=col_tol, linvs=linvs)
        return self._results(res, bs, cols, digits, opts, cached, False)

    def _columns(self, bs, opts: SolveOptions):
        """Per request: its column count and clamped target; per column:
        its tolerance; and the refinement config of the stacked call."""
        cols = [1 if b.dim() == 1 else b.shape[1] for b in bs]
        target_digits = opts.target_digits
        if np.isscalar(target_digits):
            target_digits = [target_digits] * len(bs)
        assert len(target_digits) == len(bs), (len(target_digits), len(bs))
        digits = [self._clamp(d) for d in target_digits]
        if opts.col_tol is not None:
            col_tol = np.asarray(opts.col_tol, np.float64)
            assert col_tol.shape == (sum(cols),), (col_tol.shape, cols)
        else:
            col_tol = np.repeat([10.0 ** -d for d in digits], cols)
        rcfg = self._rcfg(tol=float(col_tol.min()), method=opts.method)
        return cols, digits, col_tol, rcfg

    def _results(self, res: RefineResult, bs, cols, digits,
                 opts: SolveOptions, cached: bool, dist: bool):
        """Split a stacked refine call back into per-request x and
        SolveInfo."""
        sweeps = np.atleast_1d(res.iterations.cpu().numpy())
        resid = np.atleast_1d(res.residual.cpu().numpy())
        conv = np.atleast_1d(res.converged.cpu().numpy())
        hist = res.history.cpu().numpy()         # [S+1] or [S+1, k]
        if hist.ndim == 1:
            hist = hist[:, None]
        self.metrics.inc("engine.requests", len(bs))
        for s in sweeps:
            self.metrics.observe("engine.sweeps_per_column", int(s))
        xs, infos = [], []
        off = 0
        for i, (b, k) in enumerate(zip(bs, cols)):
            x = res.x[:, off:off + k]
            xs.append(x[:, 0] if b.dim() == 1 else x)
            sl = slice(off, off + k)
            infos.append(SolveInfo(
                ladder=self.ladder_name, method=opts.method,
                sweeps=int(sweeps[sl].max()),
                residual=float(resid[sl].max()),
                converged=bool(conv[sl].all()),
                target_digits=digits[i], factor_cached=cached,
                batch_size=len(bs), batch_index=i, distributed=dist,
                shed_tier=opts.shed_tier,
                history=_strip_history(hist[:, sl])))
            off += k
        return xs, infos

    # -- mesh mode -----------------------------------------------------------
    def _group(self):
        return self.mesh.get_group(self.dist_axis)

    def _collective(self, fn, *args):
        """``fn(*args, group=...)`` on the axis's group. A failure there
        leaves the ranks out of step (one stopped between two collectives
        the others made), so it marks the engine broken."""
        try:
            return fn(*args, group=self._group())
        except Exception as exc:
            self._broken = _why(exc)
            raise

    def _exchange(self, msg):
        """``msg`` of the axis's rank 0, on every rank of the axis."""
        box = [msg]
        src = dist.get_global_rank(self._group(), 0)
        self._collective(dist.broadcast_object_list, box, src)
        return box[0]

    def _agree(self, err, state=None) -> list:
        """Every rank's ``state``, in rank order, beside whether its part
        of the call failed (``err``); raises :class:`MeshCallError` on
        every rank when any rank's part failed, chained to this rank's own
        exception."""
        got = [None] * dist.get_world_size(self._group())
        self._collective(dist.all_gather_object, got, (_why(err), state))
        failed = [f"rank {r}: {why}" for r, (why, _) in enumerate(got)
                  if why]
        if failed:
            raise MeshCallError("distributed call failed on "
                                + "; ".join(failed)) from err
        return [st for _, st in got]

    def _dist_call(self, a, key, fp, bs=None, opts=None):
        """A distributed factor (``bs`` None) or solve: collective, so on
        the leader it is checked, then announced to the followers."""
        if self._broken is not None:
            raise RuntimeError("mesh-mode engine out of step with its ranks "
                               f"since: {self._broken}")
        a = as_tensor(a, self.device)
        n = a.shape[-1]
        if a.dim() != 2 or a.shape[0] != n or (bs and bs[0].shape[0] != n):
            raise ValueError(f"A of shape {tuple(a.shape)} for right-hand "
                             f"sides of {bs[0].shape[0] if bs else n} rows")
        if bs is not None:
            self._columns(bs, opts)        # its checks, before any collective
        if key is not None and fp is None:
            fp = matrix_fingerprint(a)
        with self._mesh_lock:
            if self._leading:
                self._exchange({
                    "bs": None if bs is None else [b.cpu() for b in bs],
                    "opts": opts, "key": key, "fp": fp,
                    "shape": tuple(a.shape), "dtype": a.dtype})
            return self._run_dist(a, key, fp, bs, opts, a.shape, a.dtype)

    def _run_dist(self, a, key, fp, bs, opts, shape, dtype):
        """One distributed call on this rank (leader, follower or SPMD; a
        follower's ``a`` is None). The ranks agree that each can run it and
        whether each holds the factor; the request's A reaches them as
        block rows; the factor is reused only if every rank holds it, else
        made on all; a solve refines against the request's A; last, the
        ranks agree that each ran it."""
        err = hit = columns = None
        try:
            if bs is not None:
                bs = [b.to(self.device) for b in bs]
                columns = self._columns(bs, opts)
            hit = self._lookup(key, fp)
        except Exception as exc:  # noqa: BLE001 — every rank raises it
            err = exc
        holds = all(self._agree(err, hit is not None))
        out = err = None
        try:
            rows = (self._rows(a, shape, dtype)
                    if bs is not None or not holds else None)
            if holds:
                self.metrics.inc("engine.factor_cache_hit")
                l = hit[0]
            else:
                self.metrics.inc("engine.factor_cache_miss")
                l = self._dist_factor(rows)
                if key is not None:
                    self._store(key, fp, l, None)
            if bs is None:
                out = (l, None, holds)
            else:
                cols, digits, col_tol, rcfg = columns
                res = self._dist_refine(l, rows, _stack(bs), rcfg, col_tol)
                out = self._results(res, bs, cols, digits, opts, holds, True)
        except Exception as exc:  # noqa: BLE001 — every rank raises it
            err = exc
        self._agree(err)
        return out

    def _rows(self, a, shape, dtype):
        """The request's A as a block-row ``DTensor`` on the mesh:
        scattered by the leader to its followers, or this rank's slice of
        the matrix every rank holds (SPMD)."""
        mesh, axis = self.mesh, self.dist_axis
        if self._leading:
            return D.scatter_rows(a.contiguous(), mesh, axis)
        if self._following:
            return D.scatter_rows(None, mesh, axis, shape=shape, dtype=dtype,
                                  device=self.device)
        return D.shard_rows(a, mesh, axis)

    def _dist_factor(self, rows):
        n = rows.shape[-1]
        compress = self.dist_compress
        if compress is None:
            compress = self._tuned(n, self._nshards()).compress_comm
        return D.dist_cholesky(rows, self.mesh, self._cfg_for(n),
                               self.dist_axis, compress_comm=compress)

    @contextlib.contextmanager
    def lead(self):
        """Make this rank (rank 0 of the mesh axis) the single controller:
        inside the block, every distributed call it makes is first sent to
        the ranks running :meth:`follow`; leaving the block releases
        them."""
        if self.mesh is None or dist.get_rank(self._group()) != 0:
            raise ValueError("lead() runs on rank 0 of a mesh-mode engine's "
                             "axis; the other ranks call follow()")
        with self._mesh_lock:
            self._leading = True
        try:
            yield self
        finally:
            with self._mesh_lock:
                self._leading = False
                if self._broken is None:
                    self._exchange(None)

    def follow(self) -> int:
        """Run the distributed calls rank 0 makes inside :meth:`lead`, in
        its order, until it leaves the block; returns how many ran. A call
        that failed on some rank goes on to the next (the leader's caller
        gets the :class:`MeshCallError`); one that left the ranks out of
        step ends the loop with its error."""
        served = 0
        self._following = True
        try:
            while (msg := self._exchange(None)) is not None:
                try:
                    self._run_dist(None, msg["key"], msg["fp"], msg["bs"],
                                   msg["opts"], msg["shape"], msg["dtype"])
                except MeshCallError:
                    pass
                served += 1
        finally:
            self._following = False
        return served

    def _dist_refine(self, l, rows, bmat, rcfg: RefineConfig,
                     col_tol) -> RefineResult:
        """Refinement loop whose correction solves run on the mesh.

        The contract of :func:`~repro_torch.core.solve.refine_solve`, with
        every solve a :func:`~repro_torch.core.distributed
        .dist_cholesky_solve` against the sharded factor ``l``, and each
        residual formed by ``ops.residual`` on this rank's block row of
        the request's A (``rows``) and then gathered: every rank runs the
        same loop on the same whole vectors, so all take the same
        decisions."""
        mesh, axis = self.mesh, self.dist_axis
        n = bmat.shape[0]
        cfg = self._cfg_for(n)
        rdtype = rcfg.rdtype()
        group = self._group()
        a_rows = rows.to_local().to(rdtype)
        b_r = bmat.to(rdtype)
        b_rows = D.shard_rows(b_r, mesh, axis).to_local()

        def base_solve(r):
            x = D.dist_cholesky_solve(
                None, D.shard_rows(r.to(l.dtype), mesh, axis), mesh, cfg,
                axis, l=l)
            return D.gather_rows(x, mesh, axis).to(rdtype)

        def matvec(x):
            return torch.cat(D.all_gather_counted(a_rows @ x, group))

        def resid(x):
            return torch.cat(D.all_gather_counted(
                ops.residual(a_rows, x, b_rows), group))

        correct = scaled_solve(base_solve)
        x0 = base_solve(b_r)     # unscaled, like iterative_refine
        run = gmres_operator if rcfg.method == "gmres" else refine_operator
        return run(matvec, correct, b_r, x0, rcfg, resid=resid, tol=col_tol)

    def continuous_stepper(self, a, *, slots: int, cache_key=None,
                           fingerprint=None):
        """Factor ``a`` (through the cache) and return the continuous-
        batching machinery bound to it: ``(stepper, base_solve, cached)``.

        ``stepper`` is a :class:`~repro_torch.core.refine.RefineStepper`
        over a ``slots``-wide block; ``base_solve`` computes the initial
        iterate of joining columns (the same unscaled factored solve the
        windowed path starts from). Classic IR only. The stepper is cached
        per ``(cache_key, fingerprint, slots)`` beside the factor cache,
        so re-activating a continuous group reuses it, with the residual-
        precision copy of A it holds.
        """
        a = as_tensor(a, self.device)
        n = a.shape[-1]
        assert not self._use_dist(n), \
            "continuous batching is single-device; distributed requests window"
        fp = fingerprint if fingerprint is not None else matrix_fingerprint(a)
        memo_key = (cache_key, fp, slots)
        with self._cache_lock:
            hit = self._steppers.get(memo_key)
            if hit is not None:
                self._steppers.move_to_end(memo_key)
                return hit[0], hit[1], True
        cfg = self._cfg_for(n)
        l, linvs, cached = self.factor(a, cache_key, fingerprint=fp)
        rcfg = self._rcfg(method="ir")
        rdtype = rcfg.rdtype()
        a_r = a.to(rdtype)

        def base_solve(r):
            return solve_factored(l, r.to(l.dtype), cfg,
                                  linvs=linvs).to(rdtype)

        def resid(x, b):
            return ops.residual(a_r, x, b)

        stepper = RefineStepper(scaled_solve(base_solve), resid, n=n,
                                slots=slots, rcfg=rcfg, device=a.device)
        with self._cache_lock:
            self._steppers[memo_key] = (stepper, base_solve)
            while len(self._steppers) > self.max_cached_factors:
                self._steppers.popitem(last=False)
        return stepper, base_solve, cached
