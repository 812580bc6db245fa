"""The port's distributed factor and solve (core/distributed.py), its
mesh-mode serving (serve/) and the tuner's distributed grid (tune/)
against the JAX reference, on the CPU with 4 gloo ranks.

One group of 4 ranks (``repro_torch.launch.launch``) runs every port case
of this module once (``repro_torch.launch.drive.run_cases``; the ranks
import nothing of jax). This process computes the reference side:
``blocked_potrf`` per ladder, the contract of tests/test_distributed.py
(the distributed factor within ``_TOL[levels[0]]`` of the single-device
one, relative to max|L|), and one subprocess with 4 forced host devices
runs the reference's own ``dist_cholesky``, ``dist_cholesky_solve`` (both
under ``jax.jit``: the reference's shard_map called eagerly takes ~20 s a
call on the CPU) and ``autotune(nshards=4)`` under the fake timer.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.core as rc
from repro.core.plan import build_plan as ref_build_plan
from repro.core.plan import shard as ref_shard
import repro_torch.core as tc
from repro_torch import tune as ttune
from repro_torch.launch import drive, launch

torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
P = 4
N = 1024
SEED = 2
#: ladder-roundoff equivalence tolerance per coarsest level
#: (tests/test_distributed.py:32)
_TOL = {"f16": 5e-3, "bf16": 4e-2, "int8": 4e-2, "f32": 5e-6, "f64": 1e-12}
CONFIGS = [k for k in tc.PAPER_CONFIGS if "f64" not in k]
SCHEDULES = [(bd, cc) for bd in (True, False) for cc in (True, False)]
WIRE_LADDERS = ["bf16x3_f32", "int8_f32"]
LOWER_LADDERS = ["bf16_f32", "f16x3_f32", "int8_f32", "pure_f32"]
TARGETS = (6.0, 8.0, 10.0, 12.0)


def _spd64(n, seed):
    """``m m^T + n I`` in f64 with m uniform(-1, 1) (the reference suite's
    tests/test_distributed.py:_spd64)."""
    m = np.random.default_rng(seed).uniform(-1, 1, (n, n))
    return m @ m.T + n * np.eye(n)


def _data():
    """The arrays the ranks' cases name (repro_torch.launch.drive)."""
    rng = np.random.default_rng(1)
    gram = _spd64(N, SEED)
    a = _spd64(N, 7)
    return {"gram": gram,
            "gram_rhs": gram @ np.random.default_rng(0).standard_normal(
                (N, 3)),
            "a": a, "b": rng.standard_normal(N),
            "a_off": drive.off_fingerprint(torch.tensor(a), 11).numpy(),
            "a_small": _spd64(192, 9), "b_small": rng.standard_normal(192)}


def _factor(label, ladder, **kw):
    return (label, {"kind": "factor", "ladder": ladder, "n": N,
                    "seed": SEED, "matrix": "gram", "return_factor": True,
                    **kw})


CASES = (
    [_factor(("ladder", k), k) for k in CONFIGS]
    + [_factor(("schedule", bd, cc), "f16_f32", leaf=128,
               broadcast_diag_only=bd, compress_comm=cc)
       for bd, cc in SCHEDULES]
    + [_factor(("f64",), "f32x3_f64", dtype="f64"),
       _factor(("tree",), "f16_f32", leaf=128, engine="tree",
               compress_comm=True),
       _factor(("int8_vs_ref",), "int8_f32", compress_comm=True)]
    + [_factor(("wire", k), k, leaf=128, compress_comm=True)
       for k in WIRE_LADDERS]
    + [(("lower", k), {"kind": "factor", "ladder": k, "n": N // 2,
                       "leaf": 128, "seed": 3, "shift": (N // 2) ** 0.5,
                       "yardstick": True})
       for k in LOWER_LADDERS]
    + [(("solve",), {"kind": "solve", "ladder": tc.PrecisionConfig(
        levels=("f32",), leaf=128), "n": N, "seed": SEED, "k": 3,
        "matrix": "gram", "rhs": "gram_rhs"}),
       (("engine",), {"kind": "engine_spmd", "ladder": "bf16_f32",
                      "dist_threshold": 512}),
       (("serve",), {"kind": "serve", "ladder": "bf16_f32", "n": N,
                     "n_local": 256, "seed": 5, "targets": TARGETS,
                     "residual_dtype": "f64", "dist_threshold": 512,
                     "waves": (1, 3)}),
       (("tune",), {"kind": "tune", "fake_timer": True, "backend": "cpu"}),
       (("imports",), {"kind": "imports"})])

#: the reference's distributed path, in a process of its own with 4 forced
#: host devices; writes <out>.npz and <out>.json
_REFERENCE = textwrap.dedent("""
    import dataclasses, functools, json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    import repro.core as core
    from repro import tune
    from repro.core import distributed as dist
    from repro.launch.mesh import make_mesh
    out, n, seed = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    mesh = make_mesh((4,), ("model",))
    sh = NamedSharding(mesh, P("model", None))
    m = np.random.default_rng(seed).uniform(-1, 1, (n, n))
    a64 = m @ m.T + n * np.eye(n)      # _spd64
    a = jax.device_put(jnp.asarray(a64, jnp.float32), sh)
    def factor(cfg):
        return np.asarray(jax.jit(functools.partial(
            dist.dist_cholesky, mesh=mesh, cfg=cfg, compress_comm=True))(a))
    res = {"f16_f32_leaf128": factor(dataclasses.replace(
               core.PAPER_CONFIGS["f16_f32"], leaf=128)),
           "int8_f32": factor(core.PAPER_CONFIGS["int8_f32"])}
    xt = np.random.default_rng(0).standard_normal((n, 3))
    b = jax.device_put(jnp.asarray(a64 @ xt, jnp.float32), sh)
    res["solve_x"] = np.asarray(jax.jit(functools.partial(
        dist.dist_cholesky_solve, mesh=mesh,
        cfg=core.PrecisionConfig(levels=("f32",), leaf=128)))(a, b))
    np.savez(out + ".npz", **res)
    from repro_torch.launch.drive import counting_timer
    payload = tune.autotune("cpu", smoke=True, timer=counting_timer(),
                            log=lambda *a: None, nshards=4, serving=True)
    with open(out + ".json", "w") as f:
        json.dump(payload, f, sort_keys=True)
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every port case's result from one group of 4 ranks, and the
    reference's distributed results, computed side by side."""
    out = str(tmp_path_factory.mktemp("dist") / "reference")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("JAX_ENABLE_X64", None)
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE, out, str(N),
                            str(SEED)], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT)
    try:
        got = launch(drive.run_cases, P, ([spec for _, spec in CASES],
                                          "cpu", _data()),
                     device="cpu", timeout=300)[0]
        log, _ = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, log.decode(errors="replace")[-3000:]
    with np.load(out + ".npz") as z:
        reference = dict(z)
    with open(out + ".json", encoding="utf-8") as f:
        reference["payload"] = json.load(f)
    return {"port": dict(zip((label for label, _ in CASES), got)),
            "ref": reference}


def _a64(n=N, seed=SEED):
    return _spd64(n, seed)


def _rel(l, ref):
    l, ref = np.asarray(l, np.float64), np.asarray(ref, np.float64)
    return np.abs(l - ref).max() / np.abs(ref).max()


def _ref_blocked(cfg, dtype=jnp.float32):
    return np.asarray(rc.blocked_potrf(jnp.asarray(_a64(), dtype), cfg))


def _check_factor(res, ref, tol):
    l = res["l"]
    assert l.shape == (N, N) and np.isfinite(l).all()
    assert res["upper_zero"] and np.abs(np.triu(l, 1)).max() == 0.0
    rel = _rel(l, ref)
    assert rel < tol, rel


# ---------------------------------------------------------------------------
# dist_cholesky == blocked_potrf (tests/test_distributed.py:60,76,93)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", CONFIGS)
def test_dist_matches_blocked(runs, name):
    """Default schedule (diagonal broadcast, collectives compressed as the
    port's database decides: no CPU database, so compressed) against the
    reference's single-device blocked factor and the port's own."""
    res = runs["port"][("ladder", name)]
    tol = _TOL[tc.PAPER_CONFIGS[name].levels[0]]
    _check_factor(res, _ref_blocked(rc.PAPER_CONFIGS[name]), tol)
    own = tc.blocked_potrf(torch.tensor(_a64(), dtype=torch.float32),
                           tc.PAPER_CONFIGS[name]).numpy()
    assert _rel(res["l"], own) < tol


@pytest.mark.parametrize("bd, cc", SCHEDULES)
def test_dist_schedules_multitile(runs, bd, cc):
    """Both collective schedules x compressed/full gathers with 2 tile
    rows a rank (leaf 128: the local diagonal factor runs the fused panel
    update and each rank storage-rounds its slice of the panel)."""
    res = runs["port"][("schedule", bd, cc)]
    cfg = dataclasses.replace(rc.PAPER_CONFIGS["f16_f32"], leaf=128)
    _check_factor(res, _ref_blocked(cfg), _TOL["f16"])
    assert _rel(res["l"], np.linalg.cholesky(_a64())) < 5e-3


def test_dist_matches_blocked_f64(runs):
    res = runs["port"][("f64",)]
    assert res["l"].dtype == np.float64
    with jax.enable_x64():
        ref = _ref_blocked(rc.PAPER_CONFIGS["f32x3_f64"], jnp.float64)
    assert ref.dtype == np.float64
    _check_factor(res, ref, _TOL[rc.PAPER_CONFIGS["f32x3_f64"].levels[0]])


def test_dist_tree_engine(runs):
    """The tree local engine (level-0 collectives) against the reference's
    single-device tree factor and the true factor."""
    res = runs["port"][("tree",)]
    cfg = dataclasses.replace(rc.PAPER_CONFIGS["f16_f32"], leaf=128)
    ref = np.asarray(rc.tree_potrf(jnp.asarray(_a64(), jnp.float32), cfg))
    _check_factor(res, ref, _TOL["f16"])
    assert _rel(res["l"], np.linalg.cholesky(_a64())) < 5e-3


def test_dist_solve(runs):
    """dist_cholesky_solve, 3 right-hand sides (tests/test_distributed.py
    :113)."""
    x = runs["port"][("solve",)]["x"]
    xt = np.random.default_rng(0).standard_normal((N, 3))
    assert np.abs(x.astype(np.float64) - xt).max() / np.abs(xt).max() < 1e-4


@pytest.mark.parametrize("name", LOWER_LADDERS)
def test_dist_lower_part_matches_single(runs, name):
    """On paper §IV-A's matrix with sqrt(n) on the diagonal, where the
    trailing updates move the factor's entries below the diagonal by a
    sizable share of their size: those entries within _TOL of the port's
    single-device blocked factor relative to their own max (each rank
    compares its rows), beside the contract's max|L| (the dominant
    diagonal of the suite's matrices hides a faulty trailing update
    there)."""
    res = runs["port"][("lower", name)]
    tol = _TOL[tc.PAPER_CONFIGS[name].levels[0]]
    assert res["finite"] and res["upper_zero"]
    assert res["rel_to_single"] < tol, res["rel_to_single"]
    assert res["rel_lower_to_single"] < tol, res["rel_lower_to_single"]


# ---------------------------------------------------------------------------
# the wire format: bytes by collective and dtype, as the sharded plan says
# ---------------------------------------------------------------------------
_WIDTH = {"int8": 1, "f16": 2, "bf16": 2, "f32": 4, "f64": 8}


@pytest.mark.parametrize("name", WIRE_LADDERS)
def test_wire_bytes_follow_the_plan(runs, name):
    """Per rank: one (w, w) f32 broadcast a panel (the diagonal block), and
    for each panel but the last, the solved block at the reference plan's
    comm_name (16-bit at 2 bytes, int8 at 1, f32 raw) plus one f32 scale
    where comm_quant says so."""
    cfg = dataclasses.replace(rc.PAPER_CONFIGS[name], leaf=128)
    sp = ref_shard(ref_build_plan(N, cfg), P)
    w = N // P
    want = {"broadcast": {"f32": P * w * w * 4}, "all_gather": {},
            "scatter": {}}
    gather = want["all_gather"]
    for j in range(P - 1):
        nm = sp.comm_name(j)
        gather[nm] = gather.get(nm, 0) + w * w * _WIDTH[nm]
        if sp.comm_quant(j):
            gather["f32"] = gather.get("f32", 0) + 4
    assert len({sp.comm_name(j) for j in range(P - 1)} - {"f32"}) == 1
    for rank in runs["port"][("wire", name)]["ranks"]:
        assert rank["wire"] == want


# ---------------------------------------------------------------------------
# against the reference's own distributed path
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("label, key, tol", [
    (("schedule", True, True), "f16_f32_leaf128", _TOL["f16"]),
    (("int8_vs_ref",), "int8_f32", _TOL["int8"])])
def test_factor_matches_reference_dist(runs, label, key, tol):
    """The port's dist_cholesky against the reference's, same matrix, same
    schedule (diagonal broadcast, compressed collectives), within the
    ladder's _TOL relative to max|L|."""
    ref = runs["ref"][key]
    assert _rel(runs["port"][label]["l"], ref) < tol
    assert np.abs(np.triu(ref, 1)).max() == 0.0


def test_solve_matches_reference_dist(runs):
    """pure f32 at leaf 128: the two solves' x agree to f32 roundoff of a
    well-conditioned system (the backward sweep sums in another order)."""
    x, ref = runs["port"][("solve",)]["x"], runs["ref"]["solve_x"]
    assert np.abs(x - ref).max() / np.abs(ref).max() < 1e-5


def test_tune_payload_is_the_references(runs):
    """autotune(nshards=4) under tests/test_tune.py's fake timer: the
    reference's payload byte for byte, and a valid database."""
    got = runs["port"][("tune",)]["payload"]
    assert json.dumps(got, sort_keys=True) == json.dumps(
        runs["ref"]["payload"], sort_keys=True)
    assert got["nshards_dist"] == P
    assert ttune.validate_db(got) == []
    assert ttune.verify_consultation(ttune.TuningDB(got)) == []


def test_ranks_import_no_jax(runs):
    """The spawned ranks ran every case above without loading jax or the
    JAX package (this process has both)."""
    assert runs["port"][("imports",)] == [[]] * P


# ---------------------------------------------------------------------------
# mesh-mode serving
# ---------------------------------------------------------------------------
def test_engine_mesh_mode_routes_and_caches(runs):
    """tests/test_distributed.py:178, every rank calling the engine: the
    large request runs distributed, the second one reuses the sharded
    factor, the small one stays local."""
    big, again, _, small = runs["port"][("engine",)]
    data = _data()
    a = data["a"].astype(np.float32).astype(np.float64)
    b = data["b"].astype(np.float32)
    info = big["info"]
    assert info["distributed"] and info["converged"]
    assert not info["factor_cached"]
    rel = np.abs(a @ big["x"].astype(np.float64) - b).max() / np.abs(b).max()
    assert rel < 1e-6, rel
    assert again["info"]["distributed"] and again["info"]["factor_cached"]
    assert again["info"]["converged"]
    assert not small["info"]["distributed"] and small["info"]["converged"]


def test_engine_mesh_mode_refines_against_the_requests_matrix(runs):
    """The key "big" again with a matrix that differs from the cached one
    off the fingerprint's samples: the sharded factor is reused (same
    fingerprint), and the residuals are formed from the request's matrix,
    so x solves it and not the cached one."""
    _, _, off, _ = runs["port"][("engine",)]
    data = _data()
    a_off = data["a_off"].astype(np.float32).astype(np.float64)
    a = data["a"].astype(np.float32).astype(np.float64)
    b = data["b"].astype(np.float32)
    info = off["info"]
    assert info["distributed"] and info["factor_cached"] and info["converged"]
    x = off["x"].astype(np.float64)
    rel = np.abs(a_off @ x - b).max() / np.abs(b).max()
    assert rel < 1e-6, rel
    assert np.abs(a @ x - b).max() / np.abs(b).max() > 1e-4


def test_scheduler_with_rank0_leading(runs):
    """Rank 0's BatchScheduler serves the requests while the other ranks
    follow: every future resolves, in submission order within its window,
    on its target; the later window finds the sharded factor cached; the
    small request stays local; each x is bitwise what engine.solve gives
    for the same request."""
    res = runs["port"][("serve",)]
    sched, direct = res["scheduled"], res["direct"]
    assert len(sched) == len(direct) == 4
    assert [s["info"]["batch_index"] for s in sched] == [0, 0, 1, 2]
    assert [s["info"]["batch_size"] for s in sched] == [1, 3, 3, 3]
    assert [s["info"]["factor_cached"] for s in sched] == [False] + [True] * 3
    for s, d, t in zip(sched, direct, res["targets"]):
        assert s["info"]["distributed"] and s["info"]["converged"]
        assert s["digits"] >= t - 0.05, (s["digits"], t)
        assert d["info"]["factor_cached"]
        assert np.array_equal(s["x"], d["x"])
    assert not res["local"]["info"]["distributed"]
    assert res["local"]["info"]["converged"]
    assert np.array_equal(res["local"]["x"], res["direct_local"]["x"])


def test_scheduler_survives_a_failed_call(runs):
    """A request that one follower fails reaches its future as a
    MeshCallError naming that rank; the next request (the key "big" with
    a matrix that differs off the fingerprint's samples) is still served,
    on the cached factor, against its own matrix; a matrix of the wrong
    shape is refused on rank 0 before any collective; every follower ran
    the same calls."""
    res = runs["port"][("serve",)]
    fault = res["fault"]
    assert fault["type"] == "MeshCallError", fault
    assert "rank 1: RuntimeError: fault injected" in fault["message"]
    assert res["wrong_shape"]["type"] == "ValueError"
    off = res["off_fingerprint"]
    info = off["info"]
    assert info["distributed"] and info["factor_cached"] and info["converged"]
    assert off["digits"] >= off["target"] - 0.05, off["digits"]
    assert off["digits_against_a"] < off["target"] - 2, off
    followed = [r["followed"] for r in res["ranks"][1:]]
    assert followed[0] >= 1 and followed == [followed[0]] * (P - 1)
