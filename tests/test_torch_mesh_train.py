"""Training under a device mesh (``launch.sharding.opt_state_shardings``,
the sharded train step, mesh-elastic checkpoints) against the JAX
reference, on the CPU.

Without ranks: the optimizer state's placements against the reference's
``opt_state_shardings`` on abstract meshes 16x16, 2x16x16 and 2x2, for
the 10 architectures' full configs (the reference's shapes by
``jax.eval_shape`` of its ``init_state``, the port's from ``init_state``
on the ``meta`` device): AdamW's moments spec for spec (a layer's port
leaf takes the stacked spec without its layers entry), TreeNewton's
statistics and factors by the bytes each rank holds, which must be the
reference's on every ``data`` coordinate.

One launch of 4 gloo ranks as a (2, 2) ``data x model`` mesh runs every
case (``drive.run_mesh_cases``) while this process computes the
reference's unsharded steps: one AdamW step of the smoke configs of
gemma-2b, pixtral-12b, musicgen-large and deepseek-v2-lite-16b (f32, 2
layers, lr 1e-2, the MoE dropless) under ``tp``, and gemma-2b under
``ddp``; gemma-2b with ``accum=2``; one TreeNewton step of gemma-2b with
a refactor (block 64); and the reference's elastic test (3 steps on (2,
2), a save, 2 more; restored onto (4, 1) under ``ddp`` and onto one
process with no mesh, 2 steps each). Tolerances, the reference's
(tests/test_moe_sharded.py:99-102, tests/test_elastic.py:76-81,
tests/test_torch_train.py's TreeNewton step):

  * loss within 1e-4; the gradient's norm within 1e-4 of the
    reference's, relative, and the first moments m = (1 - b1) g within
    1e-4 of each leaf's largest |m| (AdamW's first update, about lr
    sign(g), cannot see a gradient's size; under TreeNewton the
    whitened leaves' m is the whitening's, and their statistics hold
    their gradients);
  * parameters within 1e-4 where the reference's gradient is resolved
    (|g| > 100 eps, read from its first moment m = (1 - b1) g); where |g|
    is within 100 eps of 0, AdamW's first step g / (|g| + eps) moves
    with the last bits of g (measured: 2.9e-4 at |g| = 4e-9), and the
    entry is held to one step's size, lr (1 + wd |p|);
  * TreeNewton's statistics within 1e-5 and factors within 1e-4 of each
    matrix's largest entry, and every rank holding its share (one layer
    of the two);
  * elastic: the resumed runs' losses and parameters within 1e-4 of the
    uninterrupted mesh run's, and the mesh's saved files byte for byte a
    one-process save of the same state gathered whole.
"""
import functools
import os
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro.configs import get_config as ref_config
from repro.launch import sharding as RS
from repro.optim import adamw as radamw
from repro.optim import kfac as rkfac
from repro.train import TrainConfig as RTrainConfig
from repro.train import init_state as rinit_state
from repro.train import make_train_step as rmake
from repro.train import reshape_for_accum as rreshape
from repro_torch import convert
from repro_torch.configs import ARCHS
from repro_torch.configs import get_config as port_config
from repro_torch.launch import AbstractMesh, drive, launch
from repro_torch.launch import sharding as PS
from repro_torch.models import transformer as PT
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, init_state

torch.set_num_threads(2)

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model"))}
OPTIMIZERS = ("adamw", "tree_newton")
ATOL = 1e-4
B, S, SEED, LR, BLOCK = 4, 16, 0, 1e-2, 64
ARCHS4 = ("gemma-2b", "pixtral-12b", "musicgen-large", "deepseek-v2-lite-16b")
STEPS = [(a, "tp") for a in ARCHS4] + [("gemma-2b", "ddp")]
#: the MoE runs dropless at EP = 2 (tests/test_torch_mesh_serve.py)
OVER = {"deepseek-v2-lite-16b": {"moe_capacity_factor": 2.0}}
_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True}


# ---------------------------------------------------------------------------
# the rules, without ranks
# ---------------------------------------------------------------------------
def _entry(e):
    if isinstance(e, tuple):
        return None if not e else (e[0] if len(e) == 1 else e)
    return e


def _norm(spec, ndim):
    spec = tuple(spec)
    return tuple(_entry(e) for e in spec) + (None,) * (ndim - len(spec))


@functools.lru_cache(maxsize=None)
def _ref_opt(arch, optimizer):
    cfg = ref_config(arch)
    st = jax.eval_shape(lambda k: rinit_state(
        k, cfg, RTrainConfig(optimizer=optimizer)), jax.random.PRNGKey(0))
    return cfg, st


@functools.lru_cache(maxsize=None)
def _port_opt(arch, optimizer):
    cfg = port_config(arch)
    st = init_state(cfg, TrainConfig(optimizer=optimizer), device="meta")
    return cfg, st


def _flat(tree):
    return {RS._path_str(p): l
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _stats_bytes(specs, shapes, data_axis, nd, mesh_shape):
    """Bytes of every statistics leaf held at ``data`` coordinate ``c``,
    for each c: a spec's local shape, an ``Owned`` leaf whole where its
    index is c."""
    out = []
    for c in range(nd):
        n = 0
        for path, spec in specs.items():
            numel = int(np.prod(shapes[path]))
            if isinstance(spec, PS.Owned):
                n += 4 * numel if spec.index == c else 0
            else:
                cut = 1
                for entry in spec:
                    for a in ((entry,) if isinstance(entry, str)
                              else entry or ()):
                        cut *= mesh_shape[a]
                n += 4 * numel // cut
        out.append(n)
    return out


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_shardings_match_reference(arch, mesh, optimizer):
    shape, axes = MESHES[mesh]
    rmesh, pmesh = JaxAbstractMesh(shape, axes), AbstractMesh(shape, axes)
    rcfg, rst = _ref_opt(arch, optimizer)
    pcfg, pst = _port_opt(arch, optimizer)
    rp = RS.param_shardings(rst["params"], rcfg, rmesh)
    want = _flat(RS.opt_state_shardings(rst["opt"], rp, rmesh))
    rshape = _flat(rst["opt"])
    pp = PS.param_shardings(pst["params"], pcfg, pmesh)
    got = PS.spec_items(PS.opt_state_shardings(pst["opt"], pp, pmesh))
    moments = 0
    for path, sh in want.items():
        head = path.split("/", 1)[0]
        if head in ("stats", "factors") or path.endswith("count"):
            continue
        w = _norm(sh.spec, len(rshape[path].shape))
        pre, _, rest = path.partition(
            "/layers/" if "/layers/" in path else
            ("/dense_layers/" if "/dense_layers/" in path else "\0"))
        if rest:
            group = "dense_layers" if "/dense_layers/" in path else "layers"
            for i in sorted({0, rshape[path].shape[0] - 1}):
                assert got[f"{pre}/{group}/{i}/{rest}"] == w[1:], path
        else:
            assert got[path] == w, path
        moments += 1
    assert moments == 2 * len(jax.tree_util.tree_leaves(rst["params"]))
    if optimizer == "adamw":
        return
    nd = dict(zip(axes, shape))["data"]
    for part in ("stats", "factors"):
        rspecs = {p: _norm(s.spec, len(rshape[p].shape))
                  for p, s in want.items() if p.startswith(part + "/")}
        rshapes = {p: rshape[p].shape for p in rspecs}
        pspecs = {p: s for p, s in got.items() if p.startswith(part + "/")}
        pshapes = {p: tuple(t.shape) for p, t in
                   ((f"{part}/{k}", v) for k, v in pst["opt"][part].items())}
        mshape = dict(zip(axes, shape))
        assert (_stats_bytes(pspecs, pshapes, "data", nd, mshape)
                == _stats_bytes(rspecs, rshapes, "data", nd, mshape)), part


# ---------------------------------------------------------------------------
# the sharded step against the reference's unsharded one: one launch
# ---------------------------------------------------------------------------
def _cfg(arch):
    return ref_config(arch, smoke=True).replace(
        n_layers=2, param_dtype="f32", activ_dtype="f32",
        **OVER.get(arch, {}))


def _params(arch):
    """Random parameters in the reference's layout, drawn by the port."""
    cfg = port_config(arch, smoke=True).replace(
        n_layers=2, param_dtype="f32", activ_dtype="f32",
        **OVER.get(arch, {}))
    return convert.model_params_to_numpy(
        PT.init_params(cfg, seed=SEED, device="cpu"))


def _ref_tcfg(optimizer="adamw", accum=1):
    adam = radamw.AdamWConfig(lr=LR, warmup=0, total_steps=100)
    tn = rkfac.TreeNewtonConfig(adam=adam, block=BLOCK, factor_every=1,
                                stats_every=1)
    return RTrainConfig(optimizer=optimizer, adam=adam, tree_newton=tn,
                        accum=accum)


def _reference(data, arch, optimizer="adamw", accum=1):
    """The reference's unsharded step on the ranks' first batch
    (``drive._batches``): (state, metrics) as numpy."""
    cfg = _cfg(arch)
    tcfg = _ref_tcfg(optimizer, accum)
    params = jax.tree_util.tree_map(jnp.asarray, data[arch])
    opt = (rkfac.init(params, tcfg.tree_newton)
           if optimizer == "tree_newton" else radamw.init(params, tcfg.adam))
    state = {"params": params, "opt": opt, "step": jnp.zeros((), jnp.int32)}
    batch = {k: jnp.asarray(v)
             for k, v in drive._batches(cfg, B, S, SEED + 1)(0).items()}
    state, m = jax.jit(rmake(cfg, tcfg), compiler_options=_FAST_COMPILE)(
        state, rreshape(batch, accum))
    return jax.tree_util.tree_map(np.asarray, (state, m))


@pytest.fixture(scope="module")
def runs():
    data = {arch: _params(arch) for arch in ARCHS4}
    cases = [{"kind": "mesh_train", "arch": arch, "layout": layout,
              "over": OVER.get(arch), "params": arch, "B": B, "S": S,
              "seed": SEED, "lr": LR, "return_state": True}
             for arch, layout in STEPS]
    cases.append({"kind": "mesh_train", "arch": "gemma-2b", "accum": 2,
                  "params": "gemma-2b", "B": B, "S": S, "seed": SEED,
                  "lr": LR, "return_state": True})
    cases.append({"kind": "mesh_train", "arch": "gemma-2b",
                  "optimizer": "tree_newton", "block": BLOCK,
                  "place_whole": True,
                  "params": "gemma-2b", "B": B, "S": S, "seed": SEED,
                  "lr": LR, "return_state": True})
    tmp = tempfile.mkdtemp(prefix="mesh_train_")
    cases.append({"kind": "elastic", "arch": "gemma-2b", "B": B, "S": S,
                  "seed": SEED, "lr": LR, "byte_check": True,
                  "ckpt_dir": os.path.join(tmp, "ckpt")})
    box = {}
    ranks = threading.Thread(target=lambda: box.update(got=launch(
        drive.run_mesh_cases, 4, (cases, "cpu", data), device="cpu",
        timeout=300)[0]))
    ranks.start()
    try:     # the reference runs while the ranks do
        refs = {arch: _reference(data, arch) for arch in ARCHS4}
        refs["accum"] = _reference(data, "gemma-2b", accum=2)
        refs["tree_newton"] = _reference(data, "gemma-2b", "tree_newton")
    finally:
        ranks.join()
        os.rmdir(tmp)
    got = box["got"]
    keys = STEPS + ["accum", "tree_newton", "elastic"]
    return dict(zip(keys, got)), refs


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {} if tree is None else {prefix: np.asarray(tree)}


def _check_step(res, ref, moments, whitened=()):
    """Loss, gradient norm, first moments (but of the ``whitened``
    leaves: their statistics hold the gradient) and parameters (module
    docstring)."""
    rstate, rm = ref
    assert abs(res["losses"][0] - float(rm["loss"])) < ATOL
    gn = float(rm["grad_norm"])
    assert abs(res["grad_norms"][0] - gn) <= ATOL * gn
    got = _leaves(res["state"]["params"])
    want = _leaves(rstate["params"])
    m = _leaves(moments(rstate["opt"]))
    got_m = _leaves(moments(res["state"]["opt"]))
    adam = AdamWConfig()
    assert set(got) == set(want) == set(got_m)
    for p, w in want.items():
        assert p in whitened or (np.abs(got_m[p] - m[p]).max()
                                 <= ATOL * np.abs(m[p]).max()), p
        err = np.abs(got[p] - w)
        resolved = np.abs(m[p]) / (1 - adam.b1) > 100 * adam.eps
        assert err[resolved].max(initial=0.0) < ATOL, p
        step = LR * (1 + adam.weight_decay * np.abs(w))
        assert (err[~resolved] <= step[~resolved] + 1e-7).all(), p


@pytest.mark.parametrize("arch,layout", STEPS)
def test_sharded_step_matches_reference(runs, arch, layout):
    got, refs = runs
    _check_step(got[(arch, layout)], refs[arch], lambda o: o["m"])


def test_sharded_accumulation_matches_reference(runs):
    got, refs = runs
    _check_step(got["accum"], refs["accum"], lambda o: o["m"])


def test_sharded_tree_newton_matches_reference(runs):
    got, refs = runs
    res, (rstate, _) = got["tree_newton"], refs["tree_newton"]
    whitened = set(_leaves(rstate["opt"]["stats"]))
    _check_step(res, refs["tree_newton"], lambda o: o["adam"]["m"],
                whitened)
    assert res["held"] == [7, 7, 7, 7]      # one layer's 7 matrices each
    # each gradient goes whole to its layer's two owners alone: no
    # all-gather beyond the AdamW step's, and fewer bytes sent than two
    # whole copies of the eligible matrices
    eligible = sum(v.size for p, v in _leaves(rstate["params"]).items()
                   if p in whitened)
    sent = 0
    for r, a in zip(res["ranks"], got[("gemma-2b", "tp")]["ranks"]):
        assert r["wire"][0]["all_gather"] == a["wire"][0]["all_gather"]
        sent += r["wire"][0]["gather"]["float32"]
    assert 0 < sent < 2 * 4 * eligible
    opt = res["state"]["opt"]
    assert opt["count"] == int(rstate["opt"]["count"]) == 1
    for part, rel in (("stats", 1e-5), ("factors", 1e-4)):
        want = {p: v for p, v in _leaves(rstate["opt"][part]).items()}
        assert set(opt[part]) == set(want)
        for p, w in want.items():
            g = np.asarray(opt[part][p], np.float64)
            assert np.abs(g - w).max() / np.abs(w).max() <= rel, (part, p)


def test_elastic_resume_across_meshes(runs):
    res = runs[0]["elastic"]
    assert res["byte_equal"]
    for where in ("mesh_4x1", "one_process"):
        r = res[where]
        assert r["start"] == 3
        assert np.abs(np.subtract(r["losses"], res["ref_losses"])).max() \
            < ATOL, where
        assert r["params_gap"]["max_abs"] < ATOL, where
