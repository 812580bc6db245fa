"""Model serving under a device mesh (``repro_torch.launch.sharding``,
the models' ``Sharder``, the MoE's expert parallelism) on 4 gloo CPU
ranks as a (2, 2) ``data x model`` mesh, against the JAX reference's
unsharded run computed in this process.

One ``launch`` runs every case (``drive.run_mesh_cases``): the smoke
configs of gemma-2b (dense), pixtral-12b (vlm), musicgen-large (audio)
and deepseek-v2-lite-16b (moe) at f32 and 2 layers under the ``tp``
layout, and gemma-2b under ``ddp``, each on the reference's parameters
(``convert.place_params``); and the reference's ``MOE_CFG``
(tests/test_moe_sharded.py) under expert parallelism. Tolerances:

  * prefill and decode logits: 1e-4 absolute (tests/test_torch_models.py's
    ``LOGIT_ATOL``: f32 sums in other orders; the mesh adds the partial
    sums of the model axis);
  * generate: the mesh's tokens equal the one-rank port's, and the
    one-rank port fed the mesh's tokens picks them again (teacher
    forcing);
  * the MoE's routed output: within 2e-4 of the reference's dense oracle
    (rtol and atol, as the reference's test), and finite at capacity 1.0;
  * every parameter and cache shard has the shape its rule gives.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import moe as rmoe
from repro.models import transformer as RT
from repro.serve import engine as RE
from repro_torch import convert
from repro_torch.configs import get_config as port_config
from repro_torch.launch import drive, launch
from repro_torch.models import transformer as PT

torch.set_num_threads(2)

ARCHS = ("gemma-2b", "pixtral-12b", "musicgen-large", "deepseek-v2-lite-16b")
RUNS = [(a, "tp") for a in ARCHS] + [("gemma-2b", "ddp")]
LOGIT_ATOL = 1e-4
B, S, N_TOKENS, SEED = 4, 16, 3, 0
MOE_FIELDS = dict(name="moe-tiny", family="moe", n_layers=2, d_model=64,
                  d_ff=128, vocab=128, n_heads=4, n_kv=4, mla=True,
                  kv_lora=32, rope_head_dim=16, nope_head_dim=32,
                  v_head_dim=32, moe_experts=8, moe_topk=2, moe_shared=1,
                  moe_dff=96, moe_first_dense=0, moe_capacity_factor=16.0,
                  max_seq=32)


#: the MoE runs dropless at EP = 2 (capacity factor 2): with expert
#: parallelism the reference's capacity, ceil(T K / ep) x factor a shard,
#: drops assignments that one shard keeps, so the one-rank port and the
#: unsharded reference would differ by design
OVER = {"deepseek-v2-lite-16b": {"moe_capacity_factor": 2.0}}


def _cfg(arch):
    return ref_config(arch, smoke=True).replace(
        n_layers=2, param_dtype="f32", activ_dtype="f32",
        **OVER.get(arch, {}))


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _params(arch):
    """Random parameters in the reference's layout (numpy, the layers
    stacked), drawn by the port's ``init_params`` from SEED (the
    reference's own init runs eagerly for seconds an arch here)."""
    cfg = port_config(arch, smoke=True).replace(
        n_layers=2, param_dtype="f32", activ_dtype="f32")
    return convert.model_params_to_numpy(
        PT.init_params(cfg, seed=SEED, device="cpu"))


@pytest.fixture(scope="module")
def runs():
    data = {arch: _params(arch) for arch in ARCHS}
    cases = []
    for arch, layout in RUNS:
        cases.append({"kind": "mesh_serve", "arch": arch, "layout": layout,
                      "dtype": "f32", "n_layers": 2, "B": B, "S": S,
                      "over": OVER.get(arch),
                      "n_tokens": N_TOKENS, "params": arch, "seed": SEED})
    mcfg = rmoe.ModelConfig(**MOE_FIELDS)
    data["moe_params"] = _numpy(rmoe.moe_params(jax.random.PRNGKey(0), mcfg))
    data["moe_x"] = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                                 (8, 16, 64), jnp.float32))
    cases.append({"kind": "moe_ep", "cfg": MOE_FIELDS})
    box = {}
    ranks = threading.Thread(target=lambda: box.update(got=launch(
        drive.run_mesh_cases, 4, (cases, "cpu", data), device="cpu",
        timeout=300)[0]))
    ranks.start()
    try:     # the reference runs while the ranks do
        refs = {arch: _reference(data, arch) for arch in ARCHS}
    finally:
        ranks.join()
    return data, dict(zip(RUNS + ["moe"], box["got"])), refs


def _reference(data, arch):
    """The reference's unsharded prefill of the prompt the ranks draw
    (``drive._prompt``) and its decode of its greedy token at position
    S: (prefill logits, greedy token, decode logits)."""
    cfg = _cfg(arch)
    params = jax.tree_util.tree_map(jnp.asarray, data[arch])
    prompt = drive._prompt(cfg, B, S, SEED + 1, "cpu")
    batch = {k: jnp.asarray(v.numpy()) for k, v in prompt.items()}
    last, caches = RE.prefill_step(params, batch, cfg)
    caches = RT.pad_caches(caches, S + N_TOKENS)
    tok = jnp.argmax(last, axis=-1)
    tok = tok[:, None, :] if cfg.family == "audio" else tok[:, None]
    logits, _ = RE.serve_step(params, caches, tok, jnp.int32(S), cfg)
    return np.asarray(last), np.asarray(tok), np.asarray(logits)


@pytest.mark.parametrize("arch,layout", RUNS)
def test_mesh_logits_match_reference(runs, arch, layout):
    data, got, refs = runs
    res = got[(arch, layout)]
    want_prefill, want_tok, want_decode = refs[arch]
    np.testing.assert_array_equal(res["decode_token"], want_tok)
    assert res["prefill_logits"].shape == want_prefill.shape
    assert np.isfinite(res["prefill_logits"]).all()
    assert np.abs(res["prefill_logits"] - want_prefill).max() < LOGIT_ATOL
    assert np.abs(res["decode_logits"] - want_decode).max() < LOGIT_ATOL


@pytest.mark.parametrize("arch,layout", RUNS)
def test_mesh_generate_equals_one_rank(runs, arch, layout):
    res = runs[1][(arch, layout)]
    np.testing.assert_array_equal(res["generated"],
                                  res["one_rank"]["generated"])
    assert res["teacher_forced"]
    assert np.abs(res["prefill_logits"]
                  - res["one_rank"]["prefill_logits"]).max() < LOGIT_ATOL


@pytest.mark.parametrize("arch,layout", RUNS)
def test_mesh_shards_follow_rules(runs, arch, layout):
    res = runs[1][(arch, layout)]
    cfg = _cfg(arch)
    n_params = len(jax.tree_util.tree_leaves(runs[0][arch]))
    stacked = sum(1 for k in ("layers", "dense_layers")
                  if k in runs[0][arch]
                  for _ in jax.tree_util.tree_leaves(runs[0][arch][k]))
    n_layer_leaves = stacked and sum(
        leaf.shape[0] for k in ("layers", "dense_layers")
        if k in runs[0][arch]
        for leaf in jax.tree_util.tree_leaves(runs[0][arch][k]))
    assert res["param_shards"] == n_params - stacked + n_layer_leaves
    assert res["cache_shards"] == (4 if cfg.moe_first_dense else 2)


def test_moe_expert_parallel_matches_dense(runs):
    data, got, _ = runs
    mcfg = rmoe.ModelConfig(**MOE_FIELDS)
    dense = np.asarray(rmoe.moe_ffn_dense_reference(
        jnp.asarray(data["moe_x"]),
        jax.tree_util.tree_map(jnp.asarray, data["moe_params"]), mcfg))
    case = got["moe"]["cases"][0]
    np.testing.assert_allclose(case["routed"], dense, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got["moe"]["dense"], dense, rtol=2e-4,
                               atol=2e-4)
    assert np.isfinite(case["aux"])


def test_moe_capacity_one_stays_finite(runs):
    case = runs[1]["moe"]["cases"][1]
    assert case["capacity_factor"] == 1.0
    assert case["finite"] and np.isfinite(case["routed"]).all()
