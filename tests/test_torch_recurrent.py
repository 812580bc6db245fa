"""The port's recurrent families against the JAX reference, on the CPU, at
the smoke configs of rwkv6-3b (RWKV-6 blocks) and zamba2-2.7b (Mamba-2
blocks and one shared attention block after each group of two). The
weights are the reference's ``init_params`` carried over by
``convert.model_params_from_reference``, with every leaf that init sets
to zero or one drawn anew, nonzero, from numpy with a seed, in both
packages alike (rwkv's ``mu``, ``mu_c`` in (0, 1), ``w0``, ``u`` of order
1, ``ln_x``; mamba's ``A_log`` of order 0.5, ``D``, ``dt_bias``): at zero
the token shift is a no-op and the bonus vanishes, so a wrong carry would
pass every check. Tokens and the single blocks' inputs and states come
from numpy; everything in f32.

Tolerances:
  * a block alone (output and new states): 1e-5 absolute and relative —
    one block's f32 products and scans in other orders (a few 1e-7 of
    values of order 1, the scans adding one rounding a step);
  * logits: 1e-4 absolute and caches 1e-5, decode vs prefill < 5e-4 (the
    reference's contract, tests/test_archs.py:test_smoke_prefill_decode),
    generated tokens equal — as tests/test_torch_zoo.py holds the other
    families;
  * loss_fn's value: 1e-5 relative.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import mamba2 as tmamba
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models import transformer as TT
from repro_torch.serve import engine as tengine

torch.set_num_threads(2)

ARCHS = ["rwkv6-3b", "zamba2-2.7b"]
LOGIT_ATOL = 1e-4
TOL = dict(rtol=1e-5, atol=1e-5)
B, PROMPT, N_NEW = 2, 12, 3
S = PROMPT + 1          # the decode checks prefill PROMPT tokens
MAX_LEN = PROMPT + N_NEW
#: the mamba block alone: two SSD chunks of 128 (the carried state's
#: term and update run), and a length the SSD refuses
S_TWO_CHUNKS, S_REFUSED = 256, 200


@pytest.fixture(scope="module")
def jx():
    """jax, the reference's configs, models and serving engine."""
    jax = pytest.importorskip("jax")
    from repro import configs
    from repro.models import common, mamba2, rwkv6
    from repro.models import transformer as RT
    from repro.serve import engine
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, configs=configs,
                                 common=common, mamba2=mamba2, rwkv6=rwkv6,
                                 T=RT, engine=engine)


#: XLA's CPU backend without LLVM's costly passes, as
#: tests/test_torch_zoo.py compiles the reference: IEEE f32 arithmetic as
#: it is
_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True}


def _jit(jx, fn, *args):
    return jx.jax.jit(fn).lower(*args).compile(
        compiler_options=_FAST_COMPILE)(*args)


def _nonzero(ref_np, cfg, seed):
    """The reference's numpy pytree with the leaves that init sets to zero
    or one drawn anew (the same arrays go to both packages)."""
    rng = np.random.default_rng(seed)
    layers = dict(ref_np["layers"])

    def draw(key, fn):
        shape = layers[key].shape
        layers[key] = fn(shape).astype(layers[key].dtype)
    if cfg.family == "rwkv":
        draw("mu", lambda s: rng.uniform(0.05, 0.95, s))
        draw("mu_c", lambda s: rng.uniform(0.05, 0.95, s))
        draw("w0", lambda s: rng.uniform(-1.0, 1.0, s))
        draw("u", lambda s: rng.standard_normal(s))
        draw("ln_x", lambda s: 0.2 * rng.standard_normal(s))
    else:
        draw("A_log", lambda s: 0.5 * rng.standard_normal(s))
        draw("D", lambda s: rng.uniform(0.5, 1.5, s))
        draw("dt_bias", lambda s: 0.5 * rng.standard_normal(s))
    return {**ref_np, "layers": layers}


def _first(tree):
    """Layer 0 of a reference stack (nested dicts of [L, ...] arrays)."""
    if isinstance(tree, dict):
        return {k: _first(v) for k, v in tree.items()}
    return tree[0]


def _block_inputs(cfg):
    """numpy inputs of the single-block checks: x [B, S, d] and a nonzero
    starting state; for mamba also x at two chunks and at the refused
    length."""
    rng = np.random.default_rng(5)
    d = cfg.d_model

    def x(n):
        return rng.standard_normal((B, n, d)).astype(np.float32)
    if cfg.family == "rwkv":
        N = cfg.ssm_head_dim
        state = {"s": rng.standard_normal((B, d // N, N, N)),
                 "x_tm": rng.standard_normal((B, d)),
                 "x_cm": rng.standard_normal((B, d))}
        return {"x": x(S), "state": {k: v.astype(np.float32)
                                     for k, v in state.items()}}
    d_inner, H, P, N = tmamba._dims(cfg)
    state = {"ssm": rng.standard_normal((B, H, N, P)),
             "conv": rng.standard_normal((B, 3, d_inner + 2 * N))}
    return {"x": x(S), "x2": x(S_TWO_CHUNKS),
            "state": {k: v.astype(np.float32) for k, v in state.items()}}


_RUNS = {}


def _run(jx, arch):
    """The reference's and the port's model on the same weights and
    inputs, and the reference's results (computed once per arch, in one
    compiled program: the prefix's prefill, a decode step against its
    padded caches, the full prefill, loss_fn, generate, and the single
    blocks)."""
    if arch in _RUNS:
        return _RUNS[arch]
    jnp, T = jx.jnp, jx.T
    cfg = jx.configs.get_config(arch, smoke=True)
    tcfg = tconfigs.get_config(arch, smoke=True)
    init = _jit(jx, lambda key: T.init_params(key, cfg),
                jx.jax.random.PRNGKey(0))
    ref_np = _nonzero(jx.jax.tree.map(np.asarray, init), cfg, 3)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, S))
    xs = _block_inputs(cfg)
    no = jx.common.NO_SHARD

    def reference(params, toks, xs):
        full, _, full_caches = T.forward(params, {"tokens": toks}, cfg,
                                         mode="prefill")
        pre, _, caches = T.forward(params, {"tokens": toks[:, :-1]}, cfg,
                                   mode="prefill")
        padded = T.pad_caches(caches, MAX_LEN)
        dec, _, dec_caches = T.forward(params, {"tokens": toks[:, -1:]}, cfg,
                                       mode="decode", caches=padded,
                                       pos=jnp.int32(S - 1))
        _, parts = T.loss_fn(params, {"tokens": toks, "labels": toks}, cfg)
        gen = jx.engine.generate(params, {"tokens": toks[:, :PROMPT]}, cfg,
                                 n_tokens=N_NEW, max_len=MAX_LEN)
        p0 = _first(params["layers"])
        if cfg.family == "rwkv":
            alone = {"block": jx.rwkv6.rwkv_block(xs["x"], p0, cfg, no,
                                                  state=xs["state"])}
        else:
            alone = {"block": jx.mamba2.mamba_block(xs["x"], p0, cfg, no,
                                                    state=xs["state"]),
                     "two_chunks": jx.mamba2.mamba_block(
                         xs["x2"], p0, cfg, no, state=xs["state"])}
        return (full, full_caches, pre, caches, dec, dec_caches, parts, gen,
                alone)
    out = _jit(jx, reference, jx.jax.tree.map(jnp.asarray, ref_np),
               jnp.asarray(toks), jx.jax.tree.map(jnp.asarray, xs))
    (full, full_caches, pre, caches, dec, dec_caches, parts, gen,
     alone) = jx.jax.tree.map(np.asarray, out)
    run = types.SimpleNamespace(
        cfg=tcfg, ref_cfg=cfg, ref_np=ref_np,
        params=convert.model_params_from_reference(ref_np, tcfg,
                                                   device="cpu"),
        toks=torch.from_numpy(toks), full=full, full_caches=full_caches,
        pre=pre, caches=caches, dec=dec[:, 0], dec_caches=dec_caches,
        ce=float(parts["ce"]), gen=gen, xs=xs, alone=alone)
    _RUNS[arch] = run
    return run


def _assert_tree_close(got, want, path="", **tol):
    """Nested dicts of tensors against nested dicts of numpy arrays: the
    same keys, shapes and values within tol."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_close(got[k], want[k], f"{path}/{k}", **tol)
        return
    assert tuple(got.shape) == want.shape, (path, tuple(got.shape),
                                            want.shape)
    np.testing.assert_allclose(got.numpy(), want, err_msg=path, **tol)


def _state(xs):
    return {k: torch.from_numpy(v) for k, v in xs["state"].items()}


def _port_decode(run):
    """Prefill S - 1 tokens, pad the caches to MAX_LEN, decode the last
    token: (logits [B, V], the caches after the step)."""
    cfg, p, toks = run.cfg, run.params, run.toks
    _, _, caches = TT.forward(p, {"tokens": toks[:, :-1]}, cfg,
                              mode="prefill")
    caches = TT.pad_caches(caches, MAX_LEN)
    logits, _, out = TT.forward(p, {"tokens": toks[:, -1:]}, cfg,
                                mode="decode", caches=caches, pos=S - 1)
    assert out is caches
    return logits[:, 0], out


# ---------------------------------------------------------------------------
# the blocks alone
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_block_matches_reference(jx, arch):
    """Layer 0's block from a nonzero state (the carried token shift and
    recurrent state, the conv carry): output and new state."""
    run = _run(jx, arch)
    x, p0 = torch.from_numpy(run.xs["x"]), run.params["layers"][0]
    block = (trwkv.rwkv_block if run.cfg.family == "rwkv"
             else tmamba.mamba_block)
    want_y, want_state = run.alone["block"]
    y, state = block(x, p0, run.cfg, state=_state(run.xs))
    np.testing.assert_allclose(y.numpy(), want_y, **TOL)
    _assert_tree_close(state, want_state, **TOL)


def test_mamba_block_two_chunks(jx):
    """S = 256: two SSD chunks, so the carried state's term and the state
    update between chunks run."""
    run = _run(jx, "zamba2-2.7b")
    want_y, want_state = run.alone["two_chunks"]
    y, state = tmamba.mamba_block(torch.from_numpy(run.xs["x2"]),
                                  run.params["layers"][0], run.cfg,
                                  state=_state(run.xs))
    np.testing.assert_allclose(y.numpy(), want_y, **TOL)
    _assert_tree_close(state, want_state, **TOL)


def test_mamba_block_refuses_a_ragged_length(jx):
    """S = 200 is longer than a chunk and no multiple of it: the reference
    asserts, the port raises ValueError (no padding)."""
    run = _run(jx, "zamba2-2.7b")
    x = np.zeros((1, S_REFUSED, run.cfg.d_model), np.float32)
    with pytest.raises(ValueError, match="chunk"):
        tmamba.mamba_block(torch.from_numpy(x), run.params["layers"][0],
                           run.cfg)
    # the reference's scan asserts before it computes anything
    d_inner, H, P, N = tmamba._dims(run.cfg)
    zeros = np.zeros
    with pytest.raises(AssertionError):
        jx.mamba2._ssd_chunk_scan(
            zeros((1, S_REFUSED, H, P)), zeros((1, S_REFUSED, N)),
            zeros((1, S_REFUSED, N)), zeros((1, S_REFUSED, H)),
            zeros((1, S_REFUSED, H)), zeros((1, H, N, P)))


# ---------------------------------------------------------------------------
# each arch through the entry points
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_caches_match_reference(jx, arch):
    """The prefill of the first S - 1 positions (the decode check's
    prefix): logits, the recurrent states and keys and values, and their
    padding (attention leaves only)."""
    run = _run(jx, arch)
    cfg = run.cfg
    prefix = {"tokens": run.toks[:, :-1]}
    logits, aux, caches = TT.forward(run.params, prefix, cfg,
                                     mode="prefill")
    np.testing.assert_allclose(logits.numpy(), run.pre, rtol=0,
                               atol=LOGIT_ATOL)
    assert float(aux) == 0.0
    _assert_tree_close(caches, run.caches, **TOL)
    padded = TT.pad_caches(caches, MAX_LEN)
    if cfg.family == "hybrid":
        n_apps = max(cfg.n_layers // cfg.attn_every, 1)
        assert padded["attn"]["k"].shape == (n_apps, B, MAX_LEN, cfg.n_kv,
                                             cfg.hd)
        assert torch.equal(padded["attn"]["v"][:, :, :S - 1],
                           caches["attn"]["v"])
        states, padded_states = caches["mamba"], padded["mamba"]
    else:
        states, padded_states = caches, padded
    # the recurrent states carry no sequence axis: passed through
    assert all(padded_states[k] is v for k, v in states.items())
    last, _ = tengine.prefill_step(run.params, prefix, cfg)
    np.testing.assert_allclose(last.numpy(), run.pre[:, -1], rtol=0,
                               atol=LOGIT_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(jx, arch):
    """One decode step against the padded prefix caches: logits, and the
    caches the port updated in place against the reference's new ones."""
    run = _run(jx, arch)
    logits, caches = _port_decode(run)
    np.testing.assert_allclose(logits.numpy(), run.dec, rtol=0,
                               atol=LOGIT_ATOL)
    _assert_tree_close(caches, run.dec_caches, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_contract(jx, arch):
    run = _run(jx, arch)
    full, _, caches = TT.forward(run.params, {"tokens": run.toks}, run.cfg,
                                 mode="prefill")
    np.testing.assert_allclose(full.numpy(), run.full, rtol=0,
                               atol=LOGIT_ATOL)
    _assert_tree_close(caches, run.full_caches, **TOL)
    err = float((_port_decode(run)[0] - full[:, -1]).abs().max())
    assert err < 5e-4, f"{arch}: decode/full mismatch {err}"


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference(jx, arch):
    run = _run(jx, arch)
    got = tengine.generate(run.params, {"tokens": run.toks[:, :PROMPT]},
                           run.cfg, n_tokens=N_NEW)
    assert got.shape == (B, N_NEW)
    np.testing.assert_array_equal(got.numpy(), run.gen)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference(jx, arch):
    """The forward value (training these families is a later slice)."""
    run = _run(jx, arch)
    with torch.no_grad():
        loss, parts = TT.loss_fn(
            run.params, {"tokens": run.toks, "labels": run.toks}, run.cfg)
    np.testing.assert_allclose(float(parts["ce"]), run.ce, rtol=1e-5)
    assert float(parts["aux"]) == 0.0 and float(loss) == float(parts["ce"])


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_round_trip(jx, arch):
    """The reference's pytree (the nonzero leaves included) crosses into
    the port and back bit for bit: the layers as a list, the hybrid's
    shared block as one dict; the port's own init has the same
    structure."""
    run = _run(jx, arch)
    cfg = run.cfg
    assert len(run.params["layers"]) == cfg.n_layers
    if cfg.family == "hybrid":
        shared = run.params["shared_attn"]
        assert set(shared) == {"ln1", "ln2", "attn", "mlp"}
        assert set(shared["mlp"]) == {"w_in", "w_gate", "w_out"}
    else:
        assert run.params["layers"][0]["mu"].shape == (5, cfg.d_model)
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
    own = convert.model_params_to_numpy(TT.init_params(cfg, seed=0,
                                                       device="cpu"))
    shapes = jx.jax.tree.map(lambda a: (a.shape, a.dtype.name), run.ref_np)
    assert jx.jax.tree.map(lambda a: (a.shape, a.dtype.name),
                           own) == shapes
