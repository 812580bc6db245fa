"""The port's vlm, audio and moe families against the JAX reference, on the
CPU, at the smoke configs of pixtral-12b (patch embeddings), musicgen-large
(codebooks), deepseek-v2-lite-16b (MLA, shared + routed experts, one dense
layer) and deepseek-v3-671b (MLA with a query LoRA, two dense layers). The
weights are the reference's ``init_params`` carried over by
``convert.model_params_from_reference``; tokens and patch embeddings come
from numpy with a seed; everything in f32.

Tolerances:
  * MLA and the MoE block alone: 1e-5 absolute and relative — one layer's
    f32 products in other orders (a few 1e-7 of values of order 1);
  * routing: the top-k experts and the kept assignments equal, with the
    margin between each token's k-th and (k+1)-th router probability
    asserted (an ulp of the router's f32 logits cannot swap them);
  * logits: 1e-4 absolute, decode vs prefill < 5e-4 (the reference's
    contract, tests/test_archs.py:test_smoke_prefill_decode), generated
    tokens equal — as tests/test_torch_models.py holds the dense family;
  * loss_fn's ce and aux: 1e-5 relative.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import mla as tmla
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as TT
from repro_torch.serve import engine as tengine

torch.set_num_threads(2)

ZOO = ["pixtral-12b", "musicgen-large", "deepseek-v2-lite-16b",
       "deepseek-v3-671b"]
MLA = ["deepseek-v2-lite-16b", "deepseek-v3-671b"]
LOGIT_ATOL = 1e-4
TOL = dict(rtol=1e-5, atol=1e-5)
B, PROMPT, N_NEW = 2, 12, 3
S = PROMPT + 1          # the decode checks prefill PROMPT tokens
MAX_LEN = PROMPT + N_NEW
#: least gap between a token's k-th and (k+1)-th router probability:
#: 1e-4 is ~1000 ulps of probabilities below 1, far above what f32 sums
#: in other orders move them
MARGIN = 1e-4


@pytest.fixture(scope="module")
def jx():
    """jax, the reference's configs, models and serving engine."""
    jax = pytest.importorskip("jax")
    from repro import configs
    from repro.models import common, mla, moe
    from repro.models import transformer as RT
    from repro.serve import engine
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, configs=configs,
                                 common=common, mla=mla, moe=moe, T=RT,
                                 engine=engine)


def _batch(cfg, seed, length=S):
    """numpy tokens ([B, length], audio [B, length, C]) and, for vlm,
    patch embeddings [B, n_img_tokens, d] in f32."""
    rng = np.random.default_rng(seed)
    shape = (B, length) + ((cfg.n_codebooks,) if cfg.family == "audio"
                           else ())
    batch = {"tokens": rng.integers(0, cfg.vocab, shape)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _prefix(batch, n):
    return {k: (v[:, :n] if k == "tokens" else v) for k, v in batch.items()}


_RUNS = {}
#: XLA's CPU backend without LLVM's costly passes: compiling the
#: reference's programs is most of this file's time, and these options
#: leave IEEE f32 arithmetic as it is
_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True}


def _jit(jx, fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` with _FAST_COMPILE, called."""
    return jx.jax.jit(fn).lower(*args).compile(
        compiler_options=_FAST_COMPILE)(*args)


def _run(jx, arch):
    """The reference's and the port's model on the same weights and
    inputs, and the reference's results (computed once per arch, in one
    compiled program: init_params, the prefix's prefill, a decode step
    against its padded caches, loss_fn, generate, and the single-layer
    checks' references)."""
    if arch in _RUNS:
        return _RUNS[arch]
    jnp, T = jx.jnp, jx.T
    cfg = jx.configs.get_config(arch, smoke=True)
    tcfg = tconfigs.get_config(arch, smoke=True)
    batch = _batch(cfg, 1)
    xs = _layer_inputs(cfg)

    def reference(key, jb, xs):
        params = T.init_params(key, cfg)
        pre, _, caches = T.forward(params, _prefix(jb, S - 1), cfg,
                                   mode="prefill")
        caches = T.pad_caches(caches, MAX_LEN)
        dec, _, _ = T.forward(params, {"tokens": jb["tokens"][:, -1:]}, cfg,
                              mode="decode", caches=caches,
                              pos=jnp.int32(S - 1))
        _, parts = T.loss_fn(params, {**jb, "labels": jb["tokens"]}, cfg)
        gen = jx.engine.generate(params, _prefix(jb, PROMPT), cfg,
                                 n_tokens=N_NEW, max_len=MAX_LEN)
        return (params, pre, dec, parts, gen,
                _layer_reference(jx, cfg, params, jb, xs))
    params, pre, dec, parts, gen, alone = _jit(
        jx, reference, jx.jax.random.PRNGKey(0),
        {k: jnp.asarray(v) for k, v in batch.items()},
        {k: jnp.asarray(v) for k, v in xs.items()})
    ref_np = jx.jax.tree.map(np.asarray, params)
    tparams = convert.model_params_from_reference(ref_np, tcfg,
                                                  device="cpu")
    run = types.SimpleNamespace(
        cfg=tcfg, ref_cfg=cfg, ref=params, ref_np=ref_np, params=tparams,
        batch={k: torch.from_numpy(v) for k, v in batch.items()},
        pre=np.asarray(pre), dec=np.asarray(dec)[:, 0],
        gen=np.asarray(gen), ce=float(parts["ce"]), aux=float(parts["aux"]),
        xs=xs, alone=jx.jax.tree.map(np.asarray, alone))
    _RUNS[arch] = run
    return run


def _port_decode(run):
    """Prefill S - 1 tokens, pad the caches to MAX_LEN, decode the last
    token."""
    cfg, p, b = run.cfg, run.params, run.batch
    _, _, caches = TT.forward(p, _prefix(b, S - 1), cfg, mode="prefill")
    caches = TT.pad_caches(caches, MAX_LEN)
    logits, _, _ = TT.forward(p, {"tokens": b["tokens"][:, -1:]}, cfg,
                              mode="decode", caches=caches, pos=S - 1)
    return logits[:, 0]


def _first(tree):
    """Layer 0 of a reference stack (nested dicts of [L, ...] arrays)."""
    if isinstance(tree, dict):
        return {k: _first(v) for k, v in tree.items()}
    return tree[0]


FACTORS = (8.0, 0.5)     # capacity factors: dropless, and with drops
N_ROUTED = 24            # tokens of the MoE checks


def _layer_inputs(cfg):
    """numpy inputs of the single-layer checks: MLA's x [B, S, d], the MoE
    block's two [2, N_ROUTED / 2, d], the head's [B, 3, d]."""
    def x(seed, shape):
        return np.random.default_rng(seed).standard_normal(
            shape + (cfg.d_model,)).astype(np.float32)
    if cfg.family == "moe":
        return {"mla": x(3, (B, S)), "moe": x(4, (2, N_ROUTED // 2)),
                "block": x(5, (2, N_ROUTED // 2))}
    return {"head": x(6, (B, 3))}


def _layer_reference(jx, cfg, params, jb, xs):
    """The reference's results for the single-layer checks (traced inside
    _run's program): MLA's prefill and one absorbed decode step, the
    routed experts and their routing at each of FACTORS, the MoE block
    and the dense oracle; for the stubs, embed_inputs (both modes) and
    lm_logits."""
    jax, jnp, no = jx.jax, jx.jnp, jx.common.NO_SHARD
    if cfg.family != "moe":
        short = _prefix(jb, 4)      # shorter than pixtral's n_img_tokens
        return {"embed": [jx.T.embed_inputs(params, jb, cfg, no, decode=d)
                          for d in (False, True)],
                "short": jx.T.embed_inputs(params, short, cfg, no),
                "head": jx.T.lm_logits(params, xs["head"], cfg, no)}
    rp, x = _first(params["layers"]["attn"]), xs["mla"]
    full = jx.mla.mla_attention(x, rp, cfg, no)
    _, wc = jx.mla.mla_attention(x[:, :-1], rp, cfg, no)
    cache = {k: jnp.pad(v, ((0, 0), (0, MAX_LEN - S + 1), (0, 0)))
             for k, v in wc.items()}
    step = jx.mla.mla_attention(x[:, -1:], rp, cfg, no,
                                pos=jnp.int32(S - 1), cache=cache)
    mp, x = _first(params["layers"]["moe"]), xs["moe"]
    T, K = N_ROUTED, cfg.moe_topk
    # the routing, as _moe_local computes it
    probs = jax.nn.softmax(jnp.einsum("td,de->te", x.reshape(T, -1),
                                      mp["router"]), axis=-1)
    _, idx = jax.lax.top_k(probs, K)
    routed = [jx.moe._moe_local(
        x, mp["router"], mp["w_in"], mp["w_gate"], mp["w_out"],
        cfg=cfg.replace(moe_capacity_factor=f), ep=1, axis=None)
        for f in FACTORS]
    return {"mla": (full, step), "probs": probs, "idx": idx,
            "order": jnp.argsort(idx.reshape(T * K)), "routed": routed,
            "block": jx.moe.moe_ffn(xs["block"], mp, cfg, no),
            "dense": jx.moe.moe_ffn_dense_reference(xs["block"], mp, cfg)}


# ---------------------------------------------------------------------------
# MLA and MoE alone
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MLA)
def test_mla_matches_reference(jx, arch):
    """Prefill output and caches, then one absorbed decode step against
    the padded prefix caches, written in place."""
    run = _run(jx, arch)
    tcfg, x = run.cfg, run.xs["mla"]
    tp = run.params["layers"][0]["attn"]
    (want, wc), (want_step, wc_step) = run.alone["mla"]
    got, gc = tmla.mla_attention(torch.from_numpy(x), tp, tcfg)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for key in ("c", "kr"):
        np.testing.assert_allclose(gc[key].numpy(), wc[key], **TOL)
    # decode position S - 1 against the prefix's caches, in place
    _, gc = tmla.mla_attention(torch.from_numpy(x[:, :-1]), tp, tcfg)
    cache = tmla.init_mla_cache(tcfg, B, MAX_LEN, device="cpu")
    for k in cache:
        cache[k][:, :S - 1] = gc[k]
    got, gc = tmla.mla_attention(torch.from_numpy(x[:, -1:]), tp, tcfg,
                                 pos=S - 1, cache=cache)
    np.testing.assert_allclose(got.numpy(), want_step, **TOL)
    for key in ("c", "kr"):
        assert gc[key] is cache[key]
        np.testing.assert_allclose(cache[key].numpy(), wc_step[key], **TOL)


@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("arch", MLA)
def test_moe_routing_matches_reference(jx, arch, factor):
    """``moe_local`` against the reference's ``_moe_local`` (ep = 1): the
    routed output, aux, the top-k experts and, at capacity factor 0.5,
    which assignments are dropped."""
    run = _run(jx, arch)
    ref, tp = run.alone, run.params["layers"][0]["moe"]
    want, waux = ref["routed"][FACTORS.index(factor)]
    got, gaux, routing = tmoe.moe_local(
        torch.from_numpy(run.xs["moe"]), tp["router"], tp["w_in"],
        tp["w_gate"], tp["w_out"],
        cfg=run.cfg.replace(moe_capacity_factor=factor))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=1e-5)
    T, K = N_ROUTED, run.cfg.moe_topk
    srt = np.sort(ref["probs"], axis=-1)[:, ::-1]
    assert float((srt[:, K - 1] - srt[:, K]).min()) > MARGIN
    np.testing.assert_array_equal(routing["idx"].numpy(), ref["idx"])
    cap = tmoe.capacity(T, K, factor)
    np.testing.assert_array_equal(routing["kept"].numpy(),
                                  ref["order"][:cap])
    assert (cap < T * K) == (factor < 1)


@pytest.mark.parametrize("arch", MLA)
def test_moe_block_matches_reference(jx, arch):
    """``moe_ffn`` (routed + shared) against the reference's, and the routed
    path against both packages' dense per-expert oracles."""
    run = _run(jx, arch)
    x, tp = torch.from_numpy(run.xs["block"]), run.params["layers"][0]["moe"]
    want, waux = run.alone["block"]
    got, gaux = tmoe.moe_ffn(x, tp, run.cfg)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=1e-5)
    routed, _, _ = tmoe.moe_local(x, tp["router"], tp["w_in"],
                                  tp["w_gate"], tp["w_out"], cfg=run.cfg)
    dense = tmoe.moe_ffn_dense_reference(x, tp, run.cfg)
    np.testing.assert_allclose(routed.numpy(), dense.numpy(), **TOL)
    np.testing.assert_allclose(dense.numpy(), run.alone["dense"], **TOL)


# ---------------------------------------------------------------------------
# the modality stubs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["pixtral-12b", "musicgen-large"])
def test_embed_and_head_match_reference(jx, arch):
    run = _run(jx, arch)
    for decode, want in zip((False, True), run.alone["embed"]):
        got = TT.embed_inputs(run.params, run.batch, run.cfg, decode=decode)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        if arch == "pixtral-12b":
            # the image positions are the projected patches, except in
            # decode
            n = run.cfg.n_img_tokens
            emb = run.params["embed"][run.batch["tokens"]]
            assert torch.equal(got[:, :n], emb[:, :n]) == decode
            assert torch.equal(got[:, n:], emb[:, n:])
    # a prompt shorter than n_img_tokens: the reference's stub gives
    # n_img_tokens positions (all patches), and so does the port
    got = TT.embed_inputs(run.params, _prefix(run.batch, 4), run.cfg)
    assert got.shape == run.alone["short"].shape
    np.testing.assert_allclose(got.numpy(), run.alone["short"], **TOL)
    got = TT.lm_logits(run.params, torch.from_numpy(run.xs["head"]),
                       run.cfg)
    want = run.alone["head"]
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ---------------------------------------------------------------------------
# each arch through the entry points
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ZOO)
def test_prefill_logits_match_reference(jx, arch):
    """The prefill of the first S - 1 positions (the decode check's
    prefix): logits, caches and their padding."""
    run = _run(jx, arch)
    cfg = run.cfg
    prefix = _prefix(run.batch, S - 1)
    logits, aux, caches = TT.forward(run.params, prefix, cfg,
                                     mode="prefill")
    np.testing.assert_allclose(logits.numpy(), run.pre, rtol=0,
                               atol=LOGIT_ATOL)
    if cfg.family == "moe":
        nd = cfg.moe_first_dense
        assert caches["dense"]["c"].shape == (nd, B, S - 1, cfg.kv_lora)
        assert caches["main"]["kr"].shape == (cfg.n_layers - nd, B, S - 1,
                                              cfg.rope_head_dim)
        padded = TT.pad_caches(caches, MAX_LEN)
        assert padded["main"]["c"].shape[2] == MAX_LEN
        assert torch.equal(padded["main"]["c"][:, :, :S - 1],
                           caches["main"]["c"])
    else:
        assert float(aux) == 0.0
    last, _ = tengine.prefill_step(run.params, prefix, cfg)
    np.testing.assert_allclose(last.numpy(), run.pre[:, -1], rtol=0,
                               atol=LOGIT_ATOL)


@pytest.mark.parametrize("arch", ZOO)
def test_decode_logits_match_reference(jx, arch):
    run = _run(jx, arch)
    np.testing.assert_allclose(_port_decode(run).numpy(), run.dec, rtol=0,
                               atol=LOGIT_ATOL)


@pytest.mark.parametrize("arch", ZOO)
def test_prefill_decode_contract(jx, arch):
    run = _run(jx, arch)
    full, _, _ = TT.forward(run.params, run.batch, run.cfg, mode="prefill")
    err = float((_port_decode(run) - full[:, -1]).abs().max())
    assert err < 5e-4, f"{arch}: decode/full mismatch {err}"


@pytest.mark.parametrize("arch", ZOO)
def test_generate_matches_reference(jx, arch):
    run = _run(jx, arch)
    got = tengine.generate(run.params, _prefix(run.batch, PROMPT), run.cfg,
                           n_tokens=N_NEW)
    shape = (B, N_NEW) + ((run.cfg.n_codebooks,)
                          if run.cfg.family == "audio" else ())
    assert got.shape == shape
    np.testing.assert_array_equal(got.numpy(), run.gen)


@pytest.mark.parametrize("arch", ZOO)
def test_loss_matches_reference(jx, arch):
    """The forward value (training these families is a later slice)."""
    run = _run(jx, arch)
    with torch.no_grad():
        loss, parts = TT.loss_fn(
            run.params, {**run.batch, "labels": run.batch["tokens"]},
            run.cfg)
    np.testing.assert_allclose(float(parts["ce"]), run.ce, rtol=1e-5)
    np.testing.assert_allclose(float(parts["aux"]), run.aux, rtol=1e-5)
    assert (run.aux > 0) == (run.cfg.family == "moe")
    np.testing.assert_allclose(
        float(loss), float(parts["ce"]) + TT.AUX_LOSS_W * float(parts["aux"]),
        rtol=1e-6)


@pytest.mark.parametrize("arch", ZOO)
def test_convert_round_trip(jx, arch):
    """The reference's pytree crosses into the port and back bit for bit:
    the layer stacks as lists, a layer's experts stacked [E, d, F], the
    router in f32."""
    run = _run(jx, arch)
    cfg = run.cfg
    if cfg.family == "moe":
        nd = cfg.moe_first_dense
        assert len(run.params["dense_layers"]) == nd
        assert len(run.params["layers"]) == cfg.n_layers - nd
        m = run.params["layers"][0]["moe"]
        assert m["router"].dtype == torch.float32
        assert m["w_in"].shape == (cfg.moe_experts, cfg.d_model,
                                   cfg.moe_dff)
    if cfg.family == "audio":
        assert run.params["embed"].shape == (cfg.n_codebooks, cfg.vocab,
                                             cfg.d_model)
    back = convert.model_params_to_numpy(run.params)

    def same(a, b, path=""):
        if isinstance(b, dict):
            assert set(a) == set(b), path
            for k in b:
                same(a[k], b[k], f"{path}/{k}")
            return
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    same(back, run.ref_np)
    # the port's own init gives the same structure
    own = TT.init_params(cfg, seed=0, device="cpu")
    same(jx.jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), run.ref_np),
         jx.jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                         convert.model_params_to_numpy(own)))


@pytest.mark.parametrize("arch", ["pixtral-12b", "musicgen-large",
                                  "deepseek-v2-lite-16b", "rwkv6-3b",
                                  "zamba2-2.7b"])
def test_train_step_refuses_the_served_families(arch):
    """The step factory refuses none of these families any more (it did
    until their gradients were held to the reference,
    tests/test_torch_train.py::test_family_grads): one step of each
    optimizer on the smoke config gives a finite loss and advances the
    step."""
    from repro_torch.train import TrainConfig, init_state, make_train_step
    cfg = tconfigs.get_config(arch, smoke=True)
    batch = _batch(cfg, 4)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    batch["labels"] = batch["tokens"]
    for opt in ("adamw", "tree_newton"):
        tcfg = TrainConfig(optimizer=opt)
        state = init_state(cfg, tcfg, seed=0, device="cpu")
        state, m = make_train_step(cfg, tcfg)(state, batch)
        assert state["step"] == 1 and torch.isfinite(m["loss"])
