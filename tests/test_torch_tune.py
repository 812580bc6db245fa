"""The port's census and tuner (core/census.py, tune/) against the JAX
reference's, on the CPU.

The census must count exactly what the reference counts; the database's
lookups, its validation and the search's fits must give the reference's
answers on the same payloads and grids; ``autotune`` under the reference
suite's order-dependent fake timer (tests/test_tune.py) must write the
reference's payload byte for byte. ``engine="auto"`` must resolve to the
database's engine and give that engine's bits. Databases are hand-built
payloads, the reference's committed ``src/repro/tune/data/cpu.json`` read
as data, and the port's committed ``cuda.json`` (measured on the card).
"""
import copy
import dataclasses
import json
import os
import warnings

import numpy as np
import pytest
import torch

import repro.core as rc
import repro.core.census as rcen
from repro import tune as rtune
import repro_torch.core as tc
from repro_torch import tune as ttune
from repro_torch.launch import drive
from repro_torch.serve import BatchScheduler, SolveOptions, SolverEngine
from repro_torch.tune import search as tsearch
from repro_torch.tune.__main__ import main as tune_main

torch.set_num_threads(2)

_TOL = {"f16": 5e-3, "bf16": 4e-2, "int8": 4e-2, "f32": 5e-6, "f64": 1e-12}
ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
REF_CPU_DB = os.path.join(ROOT, "src", "repro", "tune", "data", "cpu.json")
CUDA_DB = os.path.join(ROOT, "src", "repro_torch", "tune", "data",
                       "cuda.json")
LADDERS = sorted(tc.PAPER_CONFIGS)


# ---------------------------------------------------------------------------
# payload builders (tests/test_tune.py's)
# ---------------------------------------------------------------------------
def entry(n, ladder="bf16_f32", nshards=1, **choice):
    choice.setdefault("engine", "tree")
    return {"backend": "cpu", "n": n, "ladder": ladder, "nshards": nshards,
            "choice": choice, "measurements": {"us_probe": 1.0}}


def payload(entries, crossovers=()):
    return {"version": 1, "backend": "cpu", "smoke": True,
            "sizes": [e["n"] for e in entries],
            "nshards_dist": None, "entries": entries,
            "crossovers": list(crossovers)}


def xover(n, ladder="bf16_f32", nshards=1):
    return {"backend": "cpu", "ladder": ladder, "nshards": nshards,
            "knob": "engine", "below": "tree", "above": "blocked", "n": n}


def spd(n, seed):
    rng = np.random.default_rng(seed)
    m = rng.uniform(-1, 1, (n, n))
    return (m @ m.T + n * np.eye(n)).astype(np.float32)


# ---------------------------------------------------------------------------
# the census
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("leaf", [128, 256])
@pytest.mark.parametrize("n", [256, 1000, 2048, 16384])
@pytest.mark.parametrize("name", LADDERS)
def test_census_matches_reference(name, n, leaf):
    cr = dataclasses.replace(rc.PAPER_CONFIGS[name], leaf=leaf)
    ct = dataclasses.replace(tc.PAPER_CONFIGS[name], leaf=leaf)
    want = rcen.census_potrf(n, cr)
    got = tc.census_potrf(n, ct)
    for field in ("gemm_flops", "leaf_flops", "gemm_bytes"):
        assert dict(getattr(got, field)) == dict(getattr(want, field)), field
    assert (got.leaf_count, got.gemm_count) == (want.leaf_count,
                                                want.gemm_count)
    assert got.gemm_fraction == want.gemm_fraction
    # the throughput model on the card's peaks, summed by hand in its order
    hand = 0.0
    for flops in (got.gemm_flops, got.leaf_flops):
        for k, v in flops.items():
            hand += v / tc.PEAK_FLOPS[k]
    assert got.model_time_s() == hand


def test_peak_flops_are_the_cards():
    """The H100 SXM's data-sheet dense peaks, not the reference's TPU's."""
    assert tc.PEAK_FLOPS == {"int8": 1979e12, "f16": 989e12,
                             "bf16": 989e12, "f32": 67e12, "f64": 67e12}
    assert set(tc.PEAK_FLOPS) == set(tc.DTYPES)


# ---------------------------------------------------------------------------
# the database's lookups and validation
# ---------------------------------------------------------------------------
def _handbuilt():
    """Entries and crossovers that reach every step of the chain: exact,
    crossover, nearest (same ladder, no crossover), nearest across
    ladders, defaults (an nshards with no entry)."""
    return payload(
        [entry(512, engine="tree", leaf=128, max_batch=8),
         entry(2048, engine="blocked", leaf=256, max_wait_ms=2.5),
         entry(1024, ladder="f16_f32", engine="tree", max_batch=16),
         entry(4096, ladder="f16_f32", engine="blocked", leaf=128),
         entry(1024, ladder="int8_f32", nshards=4, engine="blocked",
               compress_comm=False, dist_threshold=1024)],
        [xover(1200), xover(None, ladder="int8_f32", nshards=4)])


def _payloads():
    with open(REF_CPU_DB, encoding="utf-8") as f:
        ref_cpu = json.load(f)
    null_x = payload([entry(512, engine="blocked"), entry(2048)],
                     [xover(None)])
    return {"reference_cpu_json": ref_cpu, "handbuilt": _handbuilt(),
            "null_crossover": null_x}


@pytest.mark.parametrize("which", ["reference_cpu_json", "handbuilt",
                                   "null_crossover"])
def test_decide_matches_reference(which):
    p = _payloads()[which]
    dbr, dbt = rtune.TuningDB(p), ttune.TuningDB(copy.deepcopy(p))
    sources = set()
    for n in (128, 200, 256, 500, 512, 1000, 1024, 1199, 1200, 1615, 1616,
              1617, 2000, 2048, 3000, 4096, 8192, 16384, 65536):
        for ladder in LADDERS:
            for nshards in (1, 4, 8):
                want = dbr.decide(n, ladder, nshards)
                got = dbt.decide(n, ladder, nshards)
                assert dataclasses.asdict(got) == dataclasses.asdict(want), \
                    (n, ladder, nshards)
                sources.add(got.source)
    if which == "handbuilt":
        assert sources == {"exact", "crossover", "nearest", "default"}


def _broken_payloads():
    good = payload([entry(512)], [xover(1200)])
    out = {"list": [], "empty": {}, "no_version": {"backend": "cpu",
                                                   "entries": [],
                                                   "crossovers": []}}
    out["wrong_version"] = {**copy.deepcopy(good), "version": 2}
    out["no_entries"] = {**copy.deepcopy(good), "entries": []}
    p = copy.deepcopy(good)
    p["entries"][0]["choice"] = {"leaf": 128}
    out["no_engine"] = p
    p = copy.deepcopy(good)
    p["entries"][0]["choice"] = "tree"
    out["choice_not_object"] = p
    p = copy.deepcopy(good)
    p["entries"][0]["measurements"] = {"us_probe": float("nan")}
    out["nan_time"] = p
    p = copy.deepcopy(good)
    p["entries"][0]["measurements"] = {"us_probe": -1.0, "us_x": True}
    out["negative_time"] = p
    p = copy.deepcopy(good)
    p["entries"][0]["measurements"] = {}
    out["no_measurements"] = p
    p = copy.deepcopy(good)
    del p["entries"][0]["ladder"]
    out["entry_key_missing"] = p
    p = copy.deepcopy(good)
    p["crossovers"][0]["n"] = -3
    out["bad_crossover_n"] = p
    p = copy.deepcopy(good)
    del p["crossovers"][0]["knob"]
    out["crossover_key_missing"] = p
    out["good"] = good
    return out


@pytest.mark.parametrize("which", sorted(_broken_payloads()))
def test_validate_db_matches_reference(which):
    p = _broken_payloads()[which]
    want = rtune.validate_db(copy.deepcopy(p))
    assert ttune.validate_db(copy.deepcopy(p)) == want
    assert (want == []) == (which == "good")


@pytest.mark.parametrize("seed", range(6))
def test_interp_crossover_and_refit_match_reference(seed):
    from repro.tune.search import _refit_engines as ref_refit
    rng = np.random.default_rng(seed)
    ns = [int(v) for v in sorted(rng.choice([256, 512, 1024, 2048, 4096,
                                             8192, 16384],
                                            size=rng.integers(2, 7),
                                            replace=False))]
    tt = [float(v) for v in rng.uniform(50.0, 150.0, len(ns))]
    tb = [float(v) for v in rng.uniform(50.0, 150.0, len(ns))]
    xn = rtune.interp_crossover(ns, tt, tb)
    assert tsearch.interp_crossover(ns, tt, tb) == xn
    assert [tsearch._won(a, b) for a, b in zip(tt, tb)] == [
        "blocked" if a - b > 0.03 * b else "tree" for a, b in zip(tt, tb)]
    entries = []
    for n, a, b in zip(ns, tt, tb):
        meas = {f"us_{e}_leaf{leaf}": round(float(t * rng.uniform(0.9, 1.1)),
                                             1)
                for e, t in (("tree", a), ("blocked", b))
                for leaf in (128, 256)}
        entries.append({"ladder": "bf16_f32", "nshards": 1, "n": n,
                        "choice": {"engine": tsearch._won(a, b),
                                   "leaf": 256},
                        "measurements": meas})
    entries.append({"ladder": "bf16_f32", "nshards": 4, "n": ns[0],
                    "choice": {"engine": "blocked", "leaf": 128},
                    "measurements": {"us_local_tree": 1.0}})
    want, got = copy.deepcopy(entries), copy.deepcopy(entries)
    ref_refit(want, "bf16_f32", 1, xn)
    tsearch._refit_engines(got, "bf16_f32", 1, xn)
    assert got == want


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------
#: tests/test_tune.py's fake timer: fixed, order-dependent
_fake_timer = drive.counting_timer


def _quiet(name, us, derived):
    pass


def test_autotune_payload_is_the_references():
    """tests/test_tune.py's fake timer, both packages: the same JSON, and
    the port's deterministic across two runs."""
    want = rtune.autotune("cpu", smoke=True, timer=_fake_timer(),
                          log=_quiet, nshards=0, serving=True)
    runs = [ttune.autotune("cpu", smoke=True, timer=_fake_timer(),
                           log=_quiet, nshards=0, serving=True,
                           device="cpu") for _ in range(2)]
    text = [json.dumps(p, sort_keys=True) for p in runs]
    assert text[0] == text[1] == json.dumps(want, sort_keys=True)
    assert ttune.validate_db(runs[0]) == []
    assert ttune.verify_consultation(ttune.TuningDB(runs[0])) == []


def test_autotune_distributed_grid_payload():
    """autotune(nshards=4) on 4 gloo ranks under the fake timer: the
    payload has the reference's keys (its committed cpu.json's nshards=4
    entries; its validator passes it), and decide(n, ladder, 4) reads each
    distributed entry back."""
    from repro_torch.launch import launch
    got = launch(drive.run_cases, 4,
                 ([{"kind": "tune", "fake_timer": True, "backend": "cpu"}],
                  "cpu"), device="cpu", timeout=300)[0][0]["payload"]
    with open(REF_CPU_DB, encoding="utf-8") as f:
        ref = json.load(f)
    want = rtune.autotune("cpu", smoke=True, timer=_fake_timer(), log=_quiet,
                          nshards=0, serving=True)
    assert set(got) == set(want) and got["nshards_dist"] == 4
    assert rtune.validate_db(got) == [] and ttune.validate_db(got) == []
    dist = [e for e in got["entries"] if e["nshards"] == 4]
    ref_dist = [e for e in ref["entries"] if e["nshards"] == 4]
    assert [e["n"] for e in dist] == list(tsearch.SMOKE_DIST_SIZES)
    for e in dist:
        r = ref_dist[0]
        assert set(e) == set(r)
        assert set(e["choice"]) == set(r["choice"])
        assert set(e["measurements"]) == set(r["measurements"])
        dec = ttune.decide(e["n"], e["ladder"], 4, db=ttune.TuningDB(got))
        assert dec.source == "exact"
        for k, v in e["choice"].items():
            assert getattr(dec, k) == v, (k, v)
    assert {(c["nshards"], c["knob"]) for c in got["crossovers"]} == {
        (1, "engine"), (4, "engine")}


def test_timeit_is_a_median_of_calls():
    calls = []
    us = tsearch.timeit(lambda x: calls.append(x), 7, warmup=2, iters=3,
                        device="cpu")
    assert calls == [7] * 5 and us >= 0.0


# ---------------------------------------------------------------------------
# resolution: engine="auto", SolverEngine(tuning_db=), BatchScheduler
# ---------------------------------------------------------------------------
def _tree_then_blocked():
    """Tree at n = 256, blocked at 512 (bf16_f32); max_batch 8."""
    return payload([entry(256, engine="tree", leaf=128, max_batch=8),
                    entry(512, engine="blocked", leaf=128, max_batch=8)],
                   [xover(384)])


@pytest.fixture
def tuned_env(tmp_path, monkeypatch):
    """Both packages' default databases pointed at _tree_then_blocked."""
    path = tmp_path / "db.json"
    path.write_text(json.dumps(_tree_then_blocked()), encoding="utf-8")
    monkeypatch.setenv(ttune.db.ENV_DB, str(path))
    monkeypatch.setenv(rtune.db.ENV_DB, str(path))
    ttune.clear_cache()
    rtune.clear_cache()
    yield path
    ttune.clear_cache()
    rtune.clear_cache()


def _auto(levels=("bf16", "f32"), leaf=128):
    return tc.PrecisionConfig(levels=levels, leaf=leaf, engine="auto")


@pytest.mark.parametrize("n, engine", [(200, "tree"), (256, "tree"),
                                       (512, "blocked")])
def test_auto_is_the_tuned_engine_bitwise(tuned_env, n, engine):
    cfg = _auto()
    npad = -(-n // 128) * 128
    assert ttune.resolve_cfg(cfg, npad, backend="cpu").engine == engine
    explicit = dataclasses.replace(cfg, engine=engine)
    a = spd(n, n)
    b = np.random.default_rng(n).standard_normal((n, 2)).astype(np.float32)
    assert torch.equal(tc.cholesky(a, cfg, device="cpu"),
                       tc.cholesky(a, explicit, device="cpu"))
    x = tc.cholesky_solve(a, b, cfg, device="cpu")
    assert torch.equal(x, tc.cholesky_solve(a, b, explicit, device="cpu"))
    res = tc.refine_solve(a, b, cfg, refine=2, device="cpu")
    want = tc.refine_solve(a, b, explicit, refine=2, device="cpu")
    assert torch.equal(res.x, want.x)
    # the reference resolves the same database to the same engine; its
    # solve (one jit compile a shape) is compared at one size
    ref_auto = rc.PrecisionConfig(levels=("bf16", "f32"), leaf=128,
                                  engine="auto")
    assert rtune.resolve_cfg(ref_auto, npad).engine == engine
    if n == 256:
        xr = np.asarray(rc.cholesky_solve(a, b, ref_auto), np.float64)
        rel = np.abs(x.double().numpy() - xr).max() / np.abs(xr).max()
        assert rel < _TOL["bf16"], rel


def test_solver_engine_resolves_per_size():
    db = ttune.TuningDB(_tree_then_blocked())
    eng = SolverEngine(_auto(), device="cpu", tuning_db=db)
    for n, engine in ((256, "tree"), (512, "blocked")):
        a = spd(n, n)
        b = (a @ np.random.default_rng(n).standard_normal(n)).astype(
            np.float32)
        assert eng._cfg_for(n).engine == engine
        _, linvs, _ = eng.factor(a, f"k{n}")
        assert (linvs is None) == (engine == "tree")
        x, info = eng.solve(a, b, SolveOptions(target_digits=5,
                                               cache_key=f"k{n}"))
        assert info.factor_cached and info.converged
        ex = SolverEngine(dataclasses.replace(_auto(), engine=engine),
                          device="cpu")
        assert torch.equal(x, ex.solve(a, b, SolveOptions(
            target_digits=5))[0])


def test_scheduler_max_batch_consults_db(tuned_env):
    eng = SolverEngine(_auto(), device="cpu",
                       tuning_db=ttune.TuningDB(_tree_then_blocked()))
    assert BatchScheduler(eng).max_batch == 8
    assert BatchScheduler(eng, max_batch=4).max_batch == 4  # explicit wins
    # the default database (tuned_env) holds max_batch 8 too
    assert BatchScheduler(SolverEngine(device="cpu")).max_batch == 8
    # an entry with no max_batch: the untuned default
    no_mb = ttune.TuningDB(payload([entry(99999)]))
    assert BatchScheduler(SolverEngine(device="cpu", tuning_db=no_mb)
                          ).max_batch == ttune.DEFAULTS["max_batch"] == 32


def test_no_cpu_database_means_defaults(monkeypatch):
    """The port packages no CPU database: on the CPU, auto is blocked and
    the scheduler's width the untuned 32, silently."""
    monkeypatch.delenv(ttune.db.ENV_DB, raising=False)
    ttune.clear_cache()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert ttune.decide(1024, "bf16_f32", backend="cpu") == \
                ttune.TunedDecision.defaults()
            assert BatchScheduler(SolverEngine(device="cpu")).max_batch == 32
    finally:
        ttune.clear_cache()


@pytest.mark.parametrize("kind, match", [("corrupt", "corrupt tuning DB"),
                                         ("schema", "corrupt tuning DB"),
                                         ("missing", "not found")])
def test_bad_database_warns_and_defaults(tmp_path, monkeypatch, kind, match):
    path = tmp_path / "db.json"
    if kind == "corrupt":
        path.write_text("{not json", encoding="utf-8")
    elif kind == "schema":
        path.write_text(json.dumps({"version": 1}), encoding="utf-8")
    monkeypatch.setenv(ttune.db.ENV_DB, str(path))
    ttune.clear_cache()
    try:
        with pytest.warns(UserWarning, match=match):
            d = ttune.decide(1024, "bf16_f32", backend="cpu")
        assert d == ttune.TunedDecision.defaults()
        # engine="auto" still solves, on the default (blocked) engine
        a = spd(256, 3)
        assert torch.equal(
            tc.cholesky(a, _auto(), device="cpu"),
            tc.cholesky(a, dataclasses.replace(_auto(), engine="blocked"),
                        device="cpu"))
    finally:
        ttune.clear_cache()


# ---------------------------------------------------------------------------
# the committed database and the CLI
# ---------------------------------------------------------------------------
def test_committed_cuda_db():
    """cuda.json: measured on the card at FULL_SIZES for the four main
    ladders, one device (nshards 1), valid and consulted as it says."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        db = ttune.load_db(CUDA_DB)
    assert db is not None and db.backend == "cuda"
    assert ttune.validate_db(db.payload) == []
    assert ttune.verify_consultation(db) == []
    assert db.payload["smoke"] is False
    ladders = {ttune.ladder_key(tc.PAPER_CONFIGS[name]) for name in
               ("pure_f32", "bf16_f32", "f16x3_f32", "int8_f32")}
    keys = sorted((e["ladder"], e["n"], e["nshards"]) for e in db.entries)
    assert keys == sorted((lad, n, 1) for lad in ladders
                          for n in tsearch.FULL_SIZES)
    assert {c["ladder"] for c in db.crossovers} == ladders


def test_cli_verify_and_smoke(tmp_path, monkeypatch, capsys):
    assert tune_main(["--verify", CUDA_DB]) == 0
    # --backend cpu --smoke writes a database that --verify accepts (the
    # race's timer replaced by the fake one: this is about the CLI)
    fake = _fake_timer()
    monkeypatch.setattr(tsearch, "timeit",
                        lambda fn, *args, **kw: fake(fn, *args))
    out = tmp_path / "cpu.json"
    assert tune_main(["--backend", "cpu", "--smoke", "--out", str(out),
                      "--ladders", "pure_f32,f16x3_f32,int8_f32"]) == 0
    assert tune_main(["--verify", str(out)]) == 0
    got = json.loads(out.read_text(encoding="utf-8"))
    assert got["backend"] == "cpu"
    # PAPER_CONFIGS names are stored under the key auto looks up
    assert {e["ladder"] for e in got["entries"]} == {
        "f32", "f16_f16_f16_f32", "int8_f32"}
    (tmp_path / "bad.json").write_text("[]", encoding="utf-8")
    with pytest.warns(UserWarning, match="corrupt"):
        assert tune_main(["--verify", str(tmp_path / "bad.json")]) == 1
    capsys.readouterr()

