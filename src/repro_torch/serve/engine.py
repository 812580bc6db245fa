"""Accuracy-targeted SPD solve serving, in torch.

Counterpart of the solver half of ``repro/serve/engine.py``: SPD solve
requests carry a per-request ACCURACY TARGET (decimal digits of relative
residual) instead of naming a precision ladder. The engine factorizes in
its cheap ladder once per matrix, caches the factor, and spends
iterative-refinement sweeps — O(n^2) each — to reach the requested digits.

Left out, each raising ``NotImplementedError`` that names the ROADMAP item
that ports it: mesh mode (``mesh=``, A9), the
tuner (``tuning_db=``, ``engine="auto"``, A8) and the decode half of the
reference module (``prefill_step``, ``serve_step``, ``generate``, A12).
"""
from __future__ import annotations

import collections
import dataclasses
import threading

import numpy as np
import torch

from repro_torch.core.blocked import diag_tri_inv
from repro_torch.core.precision import PAPER_CONFIGS, PrecisionConfig
from repro_torch.core.refine import (RefineConfig, RefineStepper,
                                     scaled_solve)
from repro_torch.core.solve import (as_tensor, cholesky_padded,
                                    refine_solve, solve_factored)
from repro_torch.kernels import ops
from repro_torch.serve.metrics import MetricsTracker, NullMetrics
from repro_torch.serve.options import SolveOptions, resolve_options

MESH_ITEM = "ROADMAP A9 (distributed: SolverEngine mesh mode)"
TUNER_ITEM = "ROADMAP A8 (census, tuner: tuning_db, engine='auto')"
DECODE_ITEM = "ROADMAP A12 (model zoo: the decode half of serve/engine.py)"


def prefill_step(*args, **kwargs):
    raise NotImplementedError(f"prefill_step is {DECODE_ITEM}")


def serve_step(*args, **kwargs):
    raise NotImplementedError(f"serve_step is {DECODE_ITEM}")


def generate(*args, **kwargs):
    raise NotImplementedError(f"generate is {DECODE_ITEM}")


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
    distributed: bool = False   # always False here (mesh mode: A9)
    queue_ms: float = 0.0       # submit -> solve-start latency
    shed_tier: int = 0          # 0 = as requested, 1 = degraded target
    deadline_expired: bool = False  # retired at its deadline, best-so-far
    history: tuple = ()         # per-column residual trajectories


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
    """

    #: digits attainable by the residual precision (with ~1 digit margin)
    _FLOOR_DIGITS = {"f32": 7.0, "f64": 14.0}

    def __init__(self, ladder: str | PrecisionConfig = "bf16_f32", *,
                 max_sweeps: int = 10, gmres_restart: int = 16,
                 max_cached_factors: int = 16, residual_dtype: str = "f32",
                 device="cuda", mesh=None, tuning_db=None,
                 metrics: MetricsTracker | None = None):
        if mesh is not None:
            raise NotImplementedError(f"mesh mode is {MESH_ITEM}")
        if tuning_db is not None:
            raise NotImplementedError(f"tuning_db is {TUNER_ITEM}")
        if isinstance(ladder, str):
            self.ladder_name = ladder
            self.cfg = PAPER_CONFIGS[ladder]
        else:
            self.ladder_name = ladder.describe()
            self.cfg = ladder
        if self.cfg.engine == "auto":
            raise NotImplementedError(f"engine='auto' is {TUNER_ITEM}")
        assert residual_dtype in self._FLOOR_DIGITS, residual_dtype
        self.residual_dtype = residual_dtype
        self.device = torch.device(device)
        self.max_sweeps = max_sweeps
        self.gmres_restart = gmres_restart
        assert max_cached_factors >= 1, max_cached_factors
        self.max_cached_factors = max_cached_factors
        #: pluggable metrics sink, shared by the scheduler/frontend
        #: stacked on this engine unless overridden
        self.metrics: MetricsTracker = (metrics if metrics is not None
                                        else NullMetrics())
        #: cache_key -> (fingerprint, padded factor, diag-tile inverses),
        #: most-recently-used last; guarded by ``_cache_lock``
        self._factors: collections.OrderedDict = collections.OrderedDict()
        #: (cache_key, fingerprint, slots) -> (RefineStepper, base_solve)
        self._steppers: collections.OrderedDict = collections.OrderedDict()
        self._cache_lock = threading.RLock()

    def _use_dist(self, n: int) -> bool:
        """Never: the distributed path is ROADMAP A9."""
        return False

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
        l = cholesky_padded(a, self.cfg, device=self.device)
        linvs = (diag_tri_inv(l, self.cfg)
                 if self.cfg.engine == "blocked" else None)
        return l, linvs

    def factor(self, a, cache_key=None, *, fingerprint=None):
        """Factorize (or fetch the cached factor for) ``a``; returns
        ``(l, linvs, cached)``. A hit is served only when the stored
        fingerprint matches ``a``; insertions evict least-recently-used
        entries beyond ``max_cached_factors``. ``fingerprint`` skips the
        fingerprinting for callers that already ran it."""
        if cache_key is None:
            l, linvs = self._factorize(a)
            self.metrics.inc("engine.factor_cache_miss")
            return l, linvs, False
        fp = fingerprint if fingerprint is not None else matrix_fingerprint(a)
        with self._cache_lock:
            hit = self._factors.get(cache_key)
            if hit is not None and hit[0] == fp:
                self._factors.move_to_end(cache_key)
                self.metrics.inc("engine.factor_cache_hit")
                return hit[1], hit[2], True
        self.metrics.inc("engine.factor_cache_miss")
        l, linvs = self._factorize(a)
        with self._cache_lock:
            self._factors[cache_key] = (fp, l, linvs)
            self._factors.move_to_end(cache_key)
            while len(self._factors) > self.max_cached_factors:
                self._factors.popitem(last=False)
        return l, linvs, False

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
        and comes back in the residual precision."""
        opts = resolve_options(options, kw,
                               caller="SolverEngine.solve_batched")
        method = opts.method
        bs = [as_tensor(b, self.device) for b in bs]
        assert bs, "solve_batched needs at least one RHS"
        n = bs[0].shape[0]
        for b in bs:
            assert b.dim() in (1, 2) and b.shape[0] == n, b.shape
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
        rcfg = self._rcfg(tol=float(col_tol.min()), method=method)
        a = as_tensor(a, self.device)
        l, linvs, cached = self.factor(a, opts.cache_key,
                                       fingerprint=opts.fingerprint)
        bmat = torch.cat([b[:, None] if b.dim() == 1 else b for b in bs],
                         dim=1)
        res = refine_solve(a, bmat, self.cfg, refine=rcfg, l=l,
                           col_tol=col_tol, linvs=linvs)
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
                ladder=self.ladder_name, method=method,
                sweeps=int(sweeps[sl].max()),
                residual=float(resid[sl].max()),
                converged=bool(conv[sl].all()),
                target_digits=digits[i], factor_cached=cached,
                batch_size=len(bs), batch_index=i,
                shed_tier=opts.shed_tier,
                history=_strip_history(hist[:, sl])))
            off += k
        return xs, infos

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
        fp = fingerprint if fingerprint is not None else matrix_fingerprint(a)
        memo_key = (cache_key, fp, slots)
        with self._cache_lock:
            hit = self._steppers.get(memo_key)
            if hit is not None:
                self._steppers.move_to_end(memo_key)
                return hit[0], hit[1], True
        cfg = self.cfg
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
