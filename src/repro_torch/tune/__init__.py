"""Measured-search autotuner + tuning database, in torch.

Counterpart of ``repro/tune``. The knobs the port's speed hinges on (the
execution engine, tree or blocked; the leaf size; the serving batch
width) depend on the size and the device, so they are measured, not
picked by hand:

* :func:`autotune` (``python -m repro_torch.tune``) races candidate
  configurations and persists winners, including the interpolated engine
  crossover size, to a JSON database keyed by ``(backend, n, ladder,
  nshards)``, where ``backend`` is the device type (``"cuda"``, ``"cpu"``).
* :func:`decide` resolves a key against the packaged per-backend
  database (``repro_torch/tune/data/<backend>.json``, override with
  ``REPRO_TORCH_TUNING_DB``) with a deterministic nearest-key fallback
  chain ending at the untuned defaults.
* :func:`resolve_cfg` is the factor-time hook: a
  :class:`~repro_torch.core.precision.PrecisionConfig` with
  ``engine="auto"`` is resolved to the measured winner for its problem
  size before any schedule is built. ``SolverEngine(tuning_db=)`` and
  ``BatchScheduler(max_batch=None)`` consult the same database.
"""
from __future__ import annotations

import dataclasses

from repro_torch.tune.db import (DEFAULTS, TunedDecision, TuningDB,  # noqa: F401
                                 clear_cache, decide, default_db_path,
                                 get_default_db, ladder_key, load_db,
                                 validate_db, verify_consultation)
from repro_torch.tune.search import autotune, interp_crossover  # noqa: F401


def resolve_cfg(cfg, n: int, nshards: int = 1, *, db=None,
                backend: str = "cuda"):
    """Resolve ``engine="auto"`` to the tuned engine for size ``n`` on
    ``backend`` (the device type of the factor).

    Any other engine value passes through untouched, so explicit
    ``engine="tree"``/``"blocked"`` configs keep meaning what they say.
    The leaf is never changed here: plan geometry is the caller's
    contract (factor caches and solves must agree on it); callers that
    want the tuned leaf read ``decide(...).leaf`` before building their
    config.
    """
    if cfg.engine != "auto":
        return cfg
    dec = decide(n, ladder_key(cfg), nshards, backend=backend, db=db)
    return dataclasses.replace(cfg, engine=dec.engine)
