"""The port's model zoo and its serving loop against the JAX reference, on
the CPU, at the smoke configs of the dense family: gemma-2b (GeGLU, MQA),
granite-34b (GELU, MQA), nemotron-4-15b and nemotron-4-340b (squared
ReLU, GQA). The weights are the reference's ``init_params`` carried over
by ``convert.model_params_from_reference``; token ids come from numpy.

Tolerances (f32 throughout):
  * primitives (rms_norm, RoPE, MLPs): 1e-5 absolute and relative — one
    op chain over at most a few hundred products in f32;
  * logits: 1e-4 absolute — f32 sums of at most d_ff = 384 products in
    other orders through at most 3 layers and the vocabulary head, which
    moves logits by a few 1e-6; a wrong mask, head order or cast moves
    them by 1e-2 or more;
  * decode vs prefill: < 5e-4, the reference's own contract
    (tests/test_archs.py:test_smoke_prefill_decode);
  * generated tokens: equal.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as TT
from repro_torch.serve import engine as tengine

torch.set_num_threads(2)

DENSE = ["gemma-2b", "granite-34b", "nemotron-4-15b", "nemotron-4-340b"]
LOGIT_ATOL = 1e-4
B, PROMPT, N_NEW = 2, 12, 6
S = PROMPT + 1          # the decode checks prefill PROMPT tokens
MAX_LEN = PROMPT + N_NEW


@pytest.fixture(scope="module")
def jx():
    """jax, the reference's configs, models and serving engine."""
    jax = pytest.importorskip("jax")
    from repro import configs
    from repro.models import common
    from repro.models import transformer as RT
    from repro.serve import engine
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, configs=configs,
                                 common=common, T=RT, engine=engine)


_RUNS = {}


def _run(jx, arch):
    """The reference's and the port's model on the same weights and
    tokens, and the reference's results (computed once per arch)."""
    if arch in _RUNS:
        return _RUNS[arch]
    jnp = jx.jnp
    cfg = jx.configs.get_config(arch, smoke=True)
    tcfg = tconfigs.get_config(arch, smoke=True)
    params = jx.T.init_params(jx.jax.random.PRNGKey(0), cfg)
    tparams = convert.model_params_from_reference(
        jx.jax.tree.map(np.asarray, params), tcfg, device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, S))
    full, _, _ = jx.T.forward(params, {"tokens": jnp.asarray(toks)}, cfg,
                              mode="prefill")
    _, _, caches = jx.T.forward(params, {"tokens": jnp.asarray(toks[:, :-1])},
                                cfg, mode="prefill")
    caches = jx.T.pad_caches(caches, MAX_LEN)
    dec, _, _ = jx.T.forward(params, {"tokens": jnp.asarray(toks[:, -1:])},
                             cfg, mode="decode", caches=caches,
                             pos=jnp.int32(S - 1))
    gen = jx.engine.generate(params, {"tokens": jnp.asarray(toks[:, :PROMPT])},
                             cfg, n_tokens=N_NEW, max_len=MAX_LEN)
    run = types.SimpleNamespace(
        cfg=tcfg, params=tparams, toks=torch.from_numpy(toks),
        full=np.asarray(full), dec=np.asarray(dec)[:, 0],
        gen=np.asarray(gen))
    _RUNS[arch] = run
    return run


def _port_decode(run):
    """Prefill S - 1 tokens, pad the caches to MAX_LEN, decode the last
    token."""
    cfg, p, toks = run.cfg, run.params, run.toks
    _, _, caches = TT.forward(p, {"tokens": toks[:, :-1]}, cfg,
                              mode="prefill")
    caches = TT.pad_caches(caches, MAX_LEN)
    logits, _, _ = TT.forward(p, {"tokens": toks[:, -1:]}, cfg,
                              mode="decode", caches=caches, pos=S - 1)
    return logits[:, 0]


# ---------------------------------------------------------------------------
# configs and primitives
# ---------------------------------------------------------------------------
def test_configs_match_reference(jx):
    assert tconfigs.ARCHS == jx.configs.ARCHS
    assert tconfigs.cells() == jx.configs.cells()
    for arch in tconfigs.ARCHS:
        for smoke in (False, True):
            ours = tconfigs.get_config(arch, smoke=smoke)
            ref = jx.configs.get_config(arch, smoke=smoke)
            assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
            assert ours.hd == ref.hd
            assert str(ours.adt).replace("torch.", "") == \
                jx.jnp.dtype(ref.adt).name


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "relu2", "gelu"])
def test_primitives_match_reference(jx, kind):
    jnp = jx.jnp
    rng = np.random.default_rng(2)
    d, f = 48, 96
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    gamma = (0.1 * rng.standard_normal(d)).astype(np.float32)
    w_in, w_gate = (rng.standard_normal((d, f)).astype(np.float32) / 7
                    for _ in range(2))
    w_out = rng.standard_normal((f, d)).astype(np.float32) / 10
    gate = w_gate if kind in ("swiglu", "geglu") else None
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(gamma),
                         1e-5).numpy(),
        np.asarray(jx.common.rms_norm(jnp.asarray(x), jnp.asarray(gamma),
                                      1e-5)), **tol)
    pos = np.arange(7)
    tc, ts = tcommon.rope_freqs(torch.from_numpy(pos), 16, 1e6)
    rc, rs = jx.common.rope_freqs(jnp.asarray(pos), 16, 1e6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(rc), **tol)
    xr = rng.standard_normal((7, 3, 16)).astype(np.float32)
    np.testing.assert_allclose(
        tcommon.apply_rope(torch.from_numpy(xr), tc[:, None], ts[:, None])
        .numpy(),
        np.asarray(jx.common.apply_rope(jnp.asarray(xr), rc[:, None],
                                        rs[:, None])), **tol)
    got = tcommon.mlp_apply(torch.from_numpy(x), torch.from_numpy(w_in),
                            None if gate is None else torch.from_numpy(gate),
                            torch.from_numpy(w_out), kind)
    want = jx.common.mlp_apply(jnp.asarray(x), jnp.asarray(w_in),
                               None if gate is None else jnp.asarray(gate),
                               jnp.asarray(w_out), kind, jx.common.NO_SHARD)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


# ---------------------------------------------------------------------------
# forward, decode, generate against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_logits_match_reference(jx, arch):
    run = _run(jx, arch)
    logits, aux, caches = TT.forward(run.params, {"tokens": run.toks},
                                     run.cfg, mode="prefill")
    np.testing.assert_allclose(logits.numpy(), run.full, rtol=0,
                               atol=LOGIT_ATOL)
    assert float(aux) == 0.0
    k = caches["main"]["k"]
    assert k.shape == (run.cfg.n_layers, B, S, run.cfg.n_kv, run.cfg.hd)
    last, _ = tengine.prefill_step(run.params, {"tokens": run.toks}, run.cfg)
    np.testing.assert_allclose(last.numpy(), run.full[:, -1], rtol=0,
                               atol=LOGIT_ATOL)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_logits_match_reference(jx, arch):
    run = _run(jx, arch)
    got = _port_decode(run)
    np.testing.assert_allclose(got.numpy(), run.dec, rtol=0,
                               atol=LOGIT_ATOL)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_contract(jx, arch):
    """The reference's contract on the port alone: decoding the last token
    against the prefix's caches gives the full prefill's last logits."""
    run = _run(jx, arch)
    full, _, _ = TT.forward(run.params, {"tokens": run.toks}, run.cfg,
                            mode="prefill")
    err = float((_port_decode(run) - full[:, -1]).abs().max())
    assert err < 5e-4, f"{arch}: decode/full mismatch {err}"


@pytest.mark.parametrize("arch", DENSE)
def test_generate_matches_reference(jx, arch):
    run = _run(jx, arch)
    got = tengine.generate(run.params, {"tokens": run.toks[:, :PROMPT]},
                           run.cfg, n_tokens=N_NEW)
    assert got.shape == (B, N_NEW)
    np.testing.assert_array_equal(got.numpy(), run.gen)


def test_generate_matches_teacher_forcing(jx):
    """tests/test_serve.py's contract on the port: greedy generate equals
    re-running the full prefill for every new token."""
    run = _run(jx, "gemma-2b")
    prompt = run.toks[:, :PROMPT]
    got = tengine.generate(run.params, {"tokens": prompt}, run.cfg,
                           n_tokens=N_NEW)
    toks = prompt
    for _ in range(N_NEW):
        last, _ = tengine.prefill_step(run.params, {"tokens": toks}, run.cfg)
        toks = torch.cat([toks, last.argmax(-1)[:, None]], dim=1)
    assert torch.equal(got, toks[:, PROMPT:])


def test_sampling_follows_the_generator(jx):
    run = _run(jx, "gemma-2b")
    prompt = {"tokens": run.toks[:, :PROMPT]}

    def draw(seed):
        return tengine.generate(run.params, prompt, run.cfg, n_tokens=4,
                                temperature=0.8,
                                rng=torch.Generator().manual_seed(seed))
    a, b = draw(3), draw(3)
    assert torch.equal(a, b) and a.shape == (B, 4)
    assert int(a.max()) < run.cfg.vocab and int(a.min()) >= 0
    with pytest.raises(ValueError, match="rng"):
        tengine.generate(run.params, prompt, run.cfg, n_tokens=2,
                         temperature=1.0)


# ---------------------------------------------------------------------------
# caches, conversion, limits
# ---------------------------------------------------------------------------
def test_pad_caches_pads_the_sequence_axis():
    k = torch.randn(3, 2, 5, 1, 4)
    caches = {"main": {"k": k, "v": k + 1}, "other": torch.ones(2, 5)}
    out = TT.pad_caches(caches, 9)
    assert out["main"]["k"].shape == (3, 2, 9, 1, 4)
    assert torch.equal(out["main"]["k"][:, :, :5], k)
    assert not out["main"]["v"][:, :, 5:].any()
    assert out["other"] is caches["other"]


def test_bf16_convert_round_trip(jx):
    """bf16 reference weights cross into the port bit for bit, and the
    port's tensors read back as the same bits."""
    cfg = jx.configs.get_config("gemma-2b", smoke=True).replace(
        param_dtype="bf16", activ_dtype="bf16")
    tcfg = tconfigs.get_config("gemma-2b", smoke=True).replace(
        param_dtype="bf16", activ_dtype="bf16")
    ref = jx.jax.tree.map(np.asarray,
                          jx.T.init_params(jx.jax.random.PRNGKey(4), cfg))
    ours = convert.model_params_from_reference(ref, tcfg, device="cpu")

    def bits(t):
        assert t.dtype == torch.bfloat16
        return t.view(torch.int16).numpy().tobytes()
    for name in ("embed", "lm_head", "final_ln"):
        assert bits(ours[name]) == ref[name].tobytes(), name
    for i, layer in enumerate(ours["layers"]):
        for group, leaves in layer.items():
            for key, t in (leaves.items() if isinstance(leaves, dict)
                           else [(None, leaves)]):
                r = ref["layers"][group]
                r = r[i] if key is None else r[key][i]
                assert t.shape == r.shape and bits(t) == r.tobytes(), \
                    (i, group, key)
    logits, _, _ = TT.forward(ours, {"tokens": torch.zeros(1, 4,
                                                           dtype=torch.long)},
                              tcfg, mode="prefill")
    assert bool(torch.isfinite(logits).all())


def test_attention_keeps_the_chunk_limit():
    """models/attention.py:_chunked_causal accepts T % min(chunk, T) == 0
    only; the port accepts the same prompts."""
    from repro_torch.models import attention
    cfg = tconfigs.get_config("gemma-2b", smoke=True)
    p = attention.attn_params(cfg, generator=torch.Generator(),
                              device="cpu")
    x = torch.randn(1, 12, cfg.d_model)
    out, kv = attention.attention(x, p, cfg, chunk=4)
    assert out.shape == x.shape and kv["k"].shape == (1, 12, 1, cfg.hd)
    with pytest.raises(ValueError, match="chunk"):
        attention.attention(x, p, cfg, chunk=8)


def test_unknown_family_raises():
    """Every family of the configs runs; a config naming another is
    refused by init_params, forward and convert alike."""
    cfg = tconfigs.get_config("gemma-2b", smoke=True).replace(
        family="ssm")
    with pytest.raises(ValueError, match="ssm"):
        TT.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="ssm"):
        convert.model_params_from_reference({}, cfg, device="cpu")
    with pytest.raises(ValueError, match="ssm"):
        TT.forward({"embed": torch.zeros(4, 4)},
                   {"tokens": torch.zeros(1, 2, dtype=torch.long)}, cfg)


def test_default_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TT.init_params(tconfigs.get_config("gemma-2b", smoke=True))
