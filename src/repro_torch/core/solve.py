"""SPD factorization / solve entry points, in torch.

Counterpart of ``repro/core/solve.py``. ``PrecisionConfig.engine``
selects the execution engine behind every entry point here:

* ``"blocked"`` (default): the flat in-place tile schedule driven by the
  static precision plan (:mod:`repro_torch.core.blocked`);
* ``"tree"``: the paper's nested recursion (:mod:`repro_torch.core.tree`),
  the oracle the blocked engine is checked against. It caches no
  diagonal-tile inverses (``linvs``): each solve inverts its leaves.
* ``"auto"``: resolved here, at factor time, against the tuning database
  (:mod:`repro_torch.tune`) of the device the call runs on: the measured
  winner for the (leaf-padded) problem size, falling back to
  ``"blocked"`` when no database entry applies.

Refinement is :func:`refine_solve`.

Devices: every entry point takes ``device=``, ``"cuda"`` by default. A
numpy input goes to that device; a torch tensor stays where it is. On the
CPU the kernels' plain versions run; on a CUDA device the hand-written
kernels do. Asking for CUDA where there is none raises.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.blocked import (blocked_potrf, blocked_trsm_left,
                                      diag_tri_inv)
from repro_torch.core.precision import PrecisionConfig
from repro_torch.core.tree import (pad_factor, pad_spd, tree_potrf,
                                   tree_trsm_left)


def as_tensor(x, device="cuda"):
    """A torch tensor stays as it is; anything else becomes a tensor on
    ``device``. Raises if ``device`` is CUDA and there is no CUDA device."""
    if torch.is_tensor(x):
        return x
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' asked for, but torch sees no CUDA "
                           "device; pass device='cpu' to run on the CPU")
    return torch.tensor(np.asarray(x), device=dev)


def _autoresolve(cfg: PrecisionConfig, n: int, backend: str):
    """Resolve ``engine="auto"`` via the tuning database of ``backend``
    (the device type); no-op otherwise."""
    if cfg.engine != "auto":
        return cfg
    from repro_torch import tune  # local: tune is a consumer of this module
    return tune.resolve_cfg(cfg, n, backend=backend)


def _potrf(a_padded, cfg: PrecisionConfig):
    if cfg.engine == "blocked":
        return blocked_potrf(a_padded, cfg)
    return tree_potrf(a_padded, cfg)


def _trsm_left(b, l, cfg: PrecisionConfig, *, trans, linvs=None):
    if cfg.engine == "blocked":
        return blocked_trsm_left(b, l, cfg, trans=trans, linvs=linvs)
    return tree_trsm_left(b, l, cfg, trans=trans)


def cholesky(a, cfg: PrecisionConfig | None = None, *, device="cuda"):
    """Lower Cholesky factor via the mixed-precision engine selected by
    ``cfg.engine``; any n (padding to the leaf size inside)."""
    cfg = cfg or PrecisionConfig()
    a = as_tensor(a, device)
    n = a.shape[-1]
    return cholesky_padded(a, cfg)[:n, :n]


def cholesky_padded(a, cfg: PrecisionConfig | None = None, *,
                    device="cuda"):
    """Leaf-padded lower factor (diagonal tail, shape a multiple of
    ``cfg.leaf``); ``cholesky_padded(a)[:n, :n] == cholesky(a)``."""
    cfg = cfg or PrecisionConfig()
    a_p, _ = pad_spd(as_tensor(a, device), cfg.leaf)
    return _potrf(a_p, _autoresolve(cfg, a_p.shape[-1], a_p.device.type))


def cholesky_solve(a, b, cfg: PrecisionConfig | None = None, *, l=None,
                   refine=None, linvs=None, device="cuda"):
    """Solve A x = b for SPD A via L (L^T x) = b.

    ``b`` may be (n,) or (n, k). ``l`` reuses a factor, tight (n, n) or
    leaf-padded; ``linvs`` reuses its diagonal-tile inverses
    (:func:`~repro_torch.core.blocked.diag_tri_inv`; the blocked engine
    only, the tree engine ignores them).

    ``refine`` (int sweep count or
    :class:`~repro_torch.core.refine.RefineConfig`) runs mixed-precision
    iterative refinement after the base solve and returns
    ``refine_solve(...).x``, in the RESIDUAL precision, not ``b.dtype``;
    it needs ``a``.
    """
    cfg = cfg or PrecisionConfig()
    if refine is not None:
        return refine_solve(a, b, cfg, refine=refine, l=l, linvs=linvs,
                            device=device).x
    b = as_tensor(b, device)
    vec = b.dim() == 1
    if vec:
        b = b[:, None]
    n = b.shape[0]
    npad = -(-n // cfg.leaf) * cfg.leaf
    cfg = _autoresolve(cfg, npad, b.device.type)
    if l is None:
        lp = cholesky_padded(a, cfg, device=device)
    else:
        l = as_tensor(l, device)
        lp = l if l.shape[-1] == npad else pad_factor(l, cfg.leaf)
    if npad == n:
        bp = b
    else:
        bp = torch.zeros((npad, b.shape[1]), dtype=b.dtype, device=b.device)
        bp[:n] = b
    if cfg.engine == "blocked":
        linvs = (diag_tri_inv(lp, cfg) if linvs is None
                 else as_tensor(linvs, device))
    y = _trsm_left(bp, lp, cfg, trans=False, linvs=linvs)
    x = _trsm_left(y, lp, cfg, trans=True, linvs=linvs)[:n]
    return x[:, 0] if vec else x


def solve_factored(l, b, cfg: PrecisionConfig | None = None, *, linvs=None,
                   device="cuda"):
    """Two triangular solves with an existing factor (``linvs`` reuses
    cached diagonal-tile inverses, blocked engine)."""
    return cholesky_solve(None, b, cfg, l=l, linvs=linvs, device=device)


def refine_solve(a, b, cfg: PrecisionConfig | None = None, *,
                 refine=None, l=None, col_tol=None, linvs=None,
                 device="cuda"):
    """Accuracy-targeted solve: cheap-ladder factorization + iterative
    refinement. Returns the full
    :class:`~repro_torch.core.refine.RefineResult` (solution, residual
    history, sweeps, converged — per column for an (n, k) ``b``).
    ``refine`` is an int sweep bound or a ``RefineConfig`` (classic IR or
    GMRES-IR); ``None`` means the default 5-sweep IR. ``col_tol`` sets
    per-column tolerances; ``l``/``linvs`` reuse a cached factor and its
    diagonal-tile inverses."""
    from repro_torch.core import refine as _refine  # circular-import guard
    if cfg is not None and cfg.engine == "auto":
        npad = -(-b.shape[0] // cfg.leaf) * cfg.leaf
        backend = (b.device.type if torch.is_tensor(b)
                   else torch.device(device).type)
        cfg = _autoresolve(cfg, npad, backend)
    return _refine.iterative_refine(a, b, cfg, refine, l=l, col_tol=col_tol,
                                    linvs=linvs, device=device)


def logdet(l):
    """log det(A) = 2 sum(log diag(L))."""
    return 2.0 * torch.log(torch.diagonal(l)).sum()
