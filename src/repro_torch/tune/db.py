"""Tuning database: persisted winners of the measured knob search.

The port's own copy of ``repro/tune/db.py`` (stdlib only): the same
schema (version 1), lookups and fallbacks, over the port's own databases.
The autotuner (:mod:`repro_torch.tune.search`) times candidate
configurations over the plan/engine knob space and persists the winners
here as a plain JSON payload keyed by ``(backend, n, ladder, nshards)``;
``backend`` is the type of the device the factor runs on, ``"cuda"`` or
``"cpu"``. At factor time the solver consults the database through
:func:`decide`, which resolves a key to a :class:`TunedDecision` with a
DETERMINISTIC relaxation order:

1. exact ``(backend, n, ladder, nshards)`` entry,
2. the measured engine **crossover** for ``(backend, ladder, nshards)``
   (the interpolated problem size where the blocked engine starts
   beating the tree engine), with the remaining knobs taken from the
   nearest-``n`` entry,
3. the nearest-``n`` entry for ``(backend, ladder, nshards)``
   (log-space distance, ties to the smaller ``n``),
4. the nearest entry for ``(backend, nshards)`` across ladders,
5. the hand-picked defaults (:data:`DEFAULTS`), the untuned behaviour.

The packaged database of a backend is ``repro_torch/tune/data/
<backend>.json``; ``REPRO_TORCH_TUNING_DB`` overrides it, so a database of
the JAX package (``REPRO_TUNING_DB``) is never read here. A corrupt
database, or a missing file the user explicitly pointed
``REPRO_TORCH_TUNING_DB`` at, falls back to :data:`DEFAULTS` with a warning
(never an exception): tuning is a performance layer, not a correctness
dependency.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import warnings

SCHEMA_VERSION = 1

#: env var overriding the packaged per-backend database path
ENV_DB = "REPRO_TORCH_TUNING_DB"

#: pre-tuner hand-picked constants (the deterministic final fallback);
#: the reference's keys, so one schema serves both packages
DEFAULTS = {
    "engine": "blocked",        # PrecisionConfig default
    "leaf": None,               # keep the caller's leaf
    "compress_comm": True,      # mesh mode's knob (core/distributed.py)
    "dist_threshold": 2048,     # mesh mode's knob (SolverEngine)
    "max_batch": 32,            # BatchScheduler default
    "max_wait_ms": 5.0,         # async batching window suggestion
}


def ladder_key(cfg) -> str:
    """Canonical ladder name of a PrecisionConfig: ``"bf16_f32"``."""
    return "_".join(cfg.levels)


@dataclasses.dataclass(frozen=True)
class TunedDecision:
    """Resolved knob values for one ``(backend, n, ladder, nshards)``.

    ``source`` records how the lookup resolved: ``"exact"`` (entry hit),
    ``"crossover"`` (engine from the interpolated crossover, other knobs
    from the nearest entry), ``"nearest"`` (nearest-key entry), or
    ``"default"`` (no usable database — today's constants).
    """

    engine: str
    leaf: int | None
    compress_comm: bool
    dist_threshold: int
    max_batch: int
    max_wait_ms: float
    source: str = "default"
    matched_n: int | None = None    # n of the entry the knobs came from

    @classmethod
    def defaults(cls) -> "TunedDecision":
        return cls(**DEFAULTS, source="default")


def _choice_decision(choice: dict, source: str, matched_n=None):
    d = dict(DEFAULTS)
    d.update({k: choice[k] for k in DEFAULTS if choice.get(k) is not None})
    return TunedDecision(**d, source=source, matched_n=matched_n)


# ---------------------------------------------------------------------------
# schema validation
# ---------------------------------------------------------------------------
_ENTRY_KEYS = ("backend", "n", "ladder", "nshards", "choice", "measurements")
_CROSSOVER_KEYS = ("backend", "ladder", "nshards", "knob", "below", "above",
                   "n")


def _finite(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool) \
        and math.isfinite(v)


def validate_db(payload) -> list[str]:
    """Schema check; returns a list of problems (empty = valid).

    Required: ``version``/``backend``/``entries``/``crossovers`` top-level
    keys, at least one entry, every entry fully keyed with finite
    positive timings, every crossover fully keyed (``n`` may be null =
    "never crosses on the measured grid").
    """
    errs = []
    if not isinstance(payload, dict):
        return [f"payload is {type(payload).__name__}, not an object"]
    for k in ("version", "backend", "entries", "crossovers"):
        if k not in payload:
            errs.append(f"missing top-level key {k!r}")
    if errs:
        return errs
    if payload["version"] != SCHEMA_VERSION:
        errs.append(f"version {payload['version']!r} != {SCHEMA_VERSION}")
    entries = payload["entries"]
    if not isinstance(entries, list) or not entries:
        errs.append("entries must be a non-empty list")
        entries = []
    for i, e in enumerate(entries):
        for k in _ENTRY_KEYS:
            if k not in e:
                errs.append(f"entries[{i}]: missing key {k!r}")
        if not isinstance(e.get("choice"), dict):
            errs.append(f"entries[{i}]: choice must be an object")
        elif "engine" not in e["choice"]:
            errs.append(f"entries[{i}]: choice.engine missing")
        meas = e.get("measurements")
        if not isinstance(meas, dict) or not meas:
            errs.append(f"entries[{i}]: measurements must be a non-empty "
                        "object")
            continue
        for name, v in meas.items():
            if name.startswith("us_") and not (_finite(v) and v > 0):
                errs.append(f"entries[{i}]: measurement {name}={v!r} not "
                            "a finite positive time")
    for i, c in enumerate(payload.get("crossovers") or []):
        for k in _CROSSOVER_KEYS:
            if k not in c:
                errs.append(f"crossovers[{i}]: missing key {k!r}")
        n = c.get("n", "missing")
        if n is not None and n != "missing" and not (_finite(n) and n > 0):
            errs.append(f"crossovers[{i}]: n={n!r} not null or positive")
    return errs


# ---------------------------------------------------------------------------
# the database
# ---------------------------------------------------------------------------
class TuningDB:
    """In-memory view of one tuning-database payload."""

    def __init__(self, payload: dict):
        errs = validate_db(payload)
        if errs:
            raise ValueError("invalid tuning DB: " + "; ".join(errs[:5]))
        self.payload = payload
        self.backend = payload["backend"]
        self.entries = payload["entries"]
        self.crossovers = payload["crossovers"]

    # -- lookups -----------------------------------------------------------
    def crossover(self, ladder: str, nshards: int, knob: str = "engine"):
        """The crossover record for ``(ladder, nshards, knob)`` or None."""
        for c in self.crossovers:
            if (c["ladder"] == ladder and c["nshards"] == nshards
                    and c["knob"] == knob):
                return c
        return None

    def _nearest(self, n: int, candidates: list[dict]):
        """Nearest entry by log-space distance in ``n`` (ties: smaller n)."""
        return min(candidates,
                   key=lambda e: (abs(math.log(e["n"]) - math.log(n)),
                                  e["n"]))

    def decide(self, n: int, ladder: str, nshards: int = 1) -> TunedDecision:
        """Resolve knobs for ``(n, ladder, nshards)`` (module docstring
        relaxation order)."""
        same = [e for e in self.entries
                if e["ladder"] == ladder and e["nshards"] == nshards]
        for e in same:
            if e["n"] == n:
                return _choice_decision(e["choice"], "exact", e["n"])
        cx = self.crossover(ladder, nshards)
        if same and cx is not None:
            near = self._nearest(n, same)
            dec = _choice_decision(near["choice"], "crossover", near["n"])
            xn = cx["n"]
            engine = cx["below"] if (xn is None or n < xn) else cx["above"]
            return dataclasses.replace(dec, engine=engine)
        if same:
            near = self._nearest(n, same)
            return _choice_decision(near["choice"], "nearest", near["n"])
        anyl = [e for e in self.entries if e["nshards"] == nshards]
        if anyl:
            near = self._nearest(n, anyl)
            return _choice_decision(near["choice"], "nearest", near["n"])
        return TunedDecision.defaults()


# ---------------------------------------------------------------------------
# loading + the process-wide default database
# ---------------------------------------------------------------------------
def default_db_path(backend: str) -> str:
    """Committed per-backend database path (``REPRO_TORCH_TUNING_DB``
    wins)."""
    env = os.environ.get(ENV_DB)
    if env:
        return env
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "data", f"{backend}.json")


def load_db(path: str, *, warn_missing: bool = True) -> TuningDB | None:
    """Load a database file; corrupt or missing input returns None.

    ``warn_missing=False`` silences the not-found warning (used for
    backends that simply have no committed database yet — that is the
    normal pre-tuning state, not an error).
    """
    if not os.path.exists(path):
        if warn_missing:
            warnings.warn(f"tuning DB not found at {path}; "
                          "falling back to untuned defaults",
                          stacklevel=2)
        return None
    try:
        with open(path, encoding="utf-8") as f:
            payload = json.load(f)
        return TuningDB(payload)
    except (json.JSONDecodeError, ValueError, OSError) as e:
        warnings.warn(f"corrupt tuning DB at {path} ({e}); "
                      "falling back to untuned defaults", stacklevel=2)
        return None


_DB_CACHE: dict[str, TuningDB | None] = {}


def get_default_db(backend: str = "cuda") -> TuningDB | None:
    """The committed database for ``backend`` (cached per process)."""
    if backend not in _DB_CACHE:
        path = default_db_path(backend)
        # only an explicitly-configured path warrants a missing-file
        # warning; an absent packaged DB is the normal untuned state
        _DB_CACHE[backend] = load_db(
            path, warn_missing=bool(os.environ.get(ENV_DB)))
    return _DB_CACHE[backend]


def clear_cache() -> None:
    """Drop cached databases (tests re-point ``REPRO_TORCH_TUNING_DB``)."""
    _DB_CACHE.clear()


def verify_consultation(db: TuningDB) -> list[str]:
    """Check that lookups actually follow the measured crossovers.

    For every engine crossover in ``db``: a size just below the
    interpolated crossover must resolve to the ``below`` engine (tree)
    and a size just above to the ``above`` engine; a null crossover
    (never crosses on the measured grid) must resolve every measured
    size to the ``below`` engine. Returns a list of violations (empty =
    the engine consults the database correctly). ``python -m
    repro_torch.tune --verify`` runs this.
    """
    errs = []
    checked = 0
    for c in db.crossovers:
        if c["knob"] != "engine":
            continue
        lad, ns, xn = c["ladder"], c["nshards"], c["n"]
        grid = sorted(e["n"] for e in db.entries
                      if e["ladder"] == lad and e["nshards"] == ns)
        if not grid:
            errs.append(f"crossover ({lad}, nshards={ns}) has no entries")
            continue
        checked += 1
        if xn is None:
            probes = [(n, c["below"]) for n in grid]
        else:
            probes = [(max(1, int(xn) - 1), c["below"]),
                      (int(xn) + 1, c["above"])]
        for n, want in probes:
            got = db.decide(n, lad, ns).engine
            if got != want:
                errs.append(f"decide(n={n}, {lad}, nshards={ns}) -> "
                            f"{got}, expected {want} "
                            f"(crossover n={xn})")
    if not checked:
        errs.append("no engine crossover found to verify")
    return errs


def decide(n: int, ladder: str, nshards: int = 1, *,
           backend: str = "cuda",
           db: TuningDB | None = None) -> TunedDecision:
    """Resolve tuned knobs, falling back to :data:`DEFAULTS`.

    ``db`` overrides the committed database (the tests inject one);
    otherwise the default of ``backend`` (the device type the factor runs
    on; ``"cuda"``, as the port's entry points default to the card) is
    used.
    """
    if db is None:
        db = get_default_db(backend)
    if db is None:
        return TunedDecision.defaults()
    return db.decide(n, ladder, nshards)
