"""The port's training path against the JAX reference, on the CPU: the loss
and its gradients, one AdamW step, TreeNewton's init, refactor, whitening
and a whole step, gradient accumulation, the batched solver's per-block
quantization, and the int8 error-feedback all-reduce on 4 gloo ranks.

Then every family: loss_fn's gradients against jax.grad of the
reference at each family's smoke config (one arch a family), remat's
gradients bitwise the unchecked ones (rwkv6, zamba2), the reference's
NaN SSD gradient over 128 positions (a fault of the reference),
TreeNewton's matrices against the reference's for all 10 archs, and a
MoE TreeNewton state through ``convert`` both ways.

A tiny dense config (2 layers, d_model 128, d_ff 256, vocab 128, GQA
4 / 2 heads, SwiGLU, per-layer remat). The weights and the optimizer's
state are the reference's, carried over by ``convert``; tokens, labels
and matrices come from numpy. Tolerances, each stated at its check:

  * f32 loss: 2e-6 relative; f32 gradients: 2e-4 of each leaf's largest
    entry (f32 sums of at most 256 products in other orders through two
    layers, their backward and the softmax; a wrong mask, cast or
    transpose moves a leaf by 1e-2 or more of its largest entry);
  * bf16 loss: 2e-3 relative, bf16 gradients: 8e-2 of each leaf's largest
    entry (bf16 products and roundings at other places in the two
    frameworks; a norm scale's gradient sums B S = 128 bf16-rounded terms
    in bf16, about sqrt(128) units of 2^-8);
  * an optimizer step: where the reference's first moment says |g| >
    100 eps, parameters within 2e-6 + 1e-3 lr of the reference's (AdamW's
    first step is lr g / (|g| + eps) + lr wd p, flat in g there); where
    |g| is within 100 eps of 0, g / (|g| + eps) moves with the last bits
    of g, and the step is held to its own size, 1 + wd |p| lr; moments at
    2e-4 of each leaf's largest entry, as the gradients;
  * factors: 1e-4 of each block's largest entry (both packages run the
    same bf16_f32 ladder; only f32 sums differ), and their product within
    the bf16 ladder's 4e-2 of the damped statistics
    (tests/test_train.py:187-189 holds the reference's factors to it);
  * whitened gradients: 4e-2 of each matrix's largest entry, the bf16
    ladder's tolerance: a last-bit difference flips a bf16 rounding of
    the level-0 product or of its stored result, one bf16 unit (2^-8) of
    an entry;
  * accum = 2 against accum = 1: the reference's own bounds
    (tests/test_train.py:64-67), loss 1e-4 and parameters 1e-5.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import PAPER_CONFIGS, blocked_potrf, tree_trsm_left
from repro_torch.launch import launch
from repro_torch.launch.drive import run_cases
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import kfac as tkfac
from repro_torch.train import TrainConfig, make_train_step, reshape_for_accum

torch.set_num_threads(2)

FIELDS = dict(name="tiny", family="dense", n_layers=2, d_model=128, d_ff=256,
              vocab=128, n_heads=4, n_kv=2, mlp="swiglu", max_seq=64,
              remat=True)
B, S = 4, 32


@pytest.fixture(scope="module")
def jx():
    """jax and the reference's training modules."""
    jax = pytest.importorskip("jax")
    from repro.core import PAPER_CONFIGS as RPAPER
    from repro.core.blocked import blocked_potrf as rblocked
    from repro.core.tree import tree_trsm_left as rtrsm
    from repro.models import attention as rattn
    from repro.models import transformer as RT
    from repro.models.common import ModelConfig
    from repro.optim import adamw, kfac
    from repro.train import TrainConfig as RTrainConfig
    from repro.train import compress, init_state
    from repro.train import make_train_step as rmake
    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, T=RT, attn=rattn, adamw=adamw, kfac=kfac,
        compress=compress, init_state=init_state, make=rmake,
        TrainConfig=RTrainConfig, ModelConfig=ModelConfig, PAPER=RPAPER,
        blocked=rblocked, trsm=rtrsm)


def _cfgs(jx, **kw):
    return (jx.ModelConfig(**{**FIELDS, **kw}),
            tcommon.ModelConfig(**{**FIELDS, **kw}))


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, FIELDS["vocab"], (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :5] = -100                      # masked positions
    return {"tokens": toks[:, :-1], "labels": labels}


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else np.asarray(v, np.float64)
            for k, v in tree.items()}


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(_leaves(v, p) if isinstance(v, dict) else {p: v})
    return out


def _close_leaves(got, want, rel, what=""):
    """Each leaf within ``rel`` of its largest entry."""
    g, w = _leaves(_np(got)), _leaves(_np(want))
    assert set(g) == set(w), (what, sorted(set(g) ^ set(w)))
    for p in w:
        scale = max(np.abs(w[p]).max(), 1e-30)
        err = np.abs(g[p] - w[p]).max() / scale
        assert err <= rel, (what, p, err)


def _tstate(jx, state, tcfg_port):
    """The reference's train state, carried to the port."""
    params_np = jx.jax.tree.map(np.asarray, state["params"])
    return {"params": convert.model_params_from_reference(
                params_np, tcfg_port, device="cpu"),
            "opt": convert.opt_state_from_reference(
                jx.jax.tree.map(np.asarray, state["opt"]), params_np,
                tcfg_port, device="cpu"),
            "step": int(state["step"])}


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------
def test_cross_entropy(jx):
    """The z-regularized, masked LM loss at 1e-6 relative (f32 sums over
    128 logits and 64 rows in other orders)."""
    from repro.models.common import cross_entropy
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((2, 32, 128)) * 4).astype(np.float32)
    labels = rng.integers(0, 128, (2, 32))
    labels[1, 3:9] = -100
    want = float(cross_entropy(jx.jnp.asarray(logits),
                               jx.jnp.asarray(labels)))
    got = float(tcommon.cross_entropy(torch.from_numpy(logits),
                                      torch.from_numpy(labels)))
    assert abs(got - want) <= 1e-6 * abs(want)
    none = np.full_like(labels, -100)
    assert float(tcommon.cross_entropy(torch.from_numpy(logits),
                                       torch.from_numpy(none))) == 0.0


def test_flash_causal_gradient(jx):
    """FlashCausal's backward (the reference's scan recomputed chunk by
    chunk) against jax.grad of the reference's _chunked_causal, 4 key
    chunks, GQA 4 / 2: output and each gradient at 2e-5 of its largest
    entry (f32 sums of 32 products)."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 32, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    w = rng.standard_normal((2, 32, 4, 16)).astype(np.float32)
    jnp = jx.jnp

    def rloss(q, k, v):
        out = jx.attn._chunked_causal(q.reshape(2, 32, 2, 2, 16), k, v,
                                      q_pos0=0, chunk=8)
        return jnp.sum(out.reshape(2, 32, 4, 16) * w), out
    (_, rout), rg = jx.jax.jit(jx.jax.value_and_grad(
        rloss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tattn.FlashCausal.apply(qt, kt, vt, 8)
    tg = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (qt, kt, vt))
    want = np.asarray(rout).reshape(out.shape)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0,
                               atol=2e-5 * np.abs(want).max())
    for g, r in zip(tg, rg):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=2e-5 * np.abs(r).max())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_loss_and_grads(jx, dtype):
    """loss_fn and every gradient leaf (remat on in both packages)."""
    cfg, tcfg = _cfgs(jx, param_dtype=dtype, activ_dtype=dtype)
    params = jx.T.init_params(jx.jax.random.PRNGKey(0), cfg)
    batch = _batch()
    jb = {k: jx.jnp.asarray(v) for k, v in batch.items()}
    (loss, m), grads = jx.jax.jit(jx.jax.value_and_grad(
        lambda p: jx.T.loss_fn(p, jb, cfg), has_aux=True))(params)
    tparams = convert.model_params_from_reference(
        jx.jax.tree.map(np.asarray, params), tcfg, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tloss, tm = TT.loss_fn(tparams, tb, tcfg)
    from repro_torch.train.step import _value_and_grad
    gloss, _, tgrads = _value_and_grad(tparams, tb, tcfg)
    assert float(gloss) == float(tloss)
    rel_loss, rel_grad = (2e-6, 2e-4) if dtype == "f32" else (2e-3, 8e-2)
    assert abs(float(tloss) - float(loss)) <= rel_loss * abs(float(loss))
    assert abs(float(tm["ce"]) - float(m["ce"])) <= rel_loss * float(m["ce"])
    assert float(tm["aux"]) == float(m["aux"]) == 0.0
    for _, g in tadamw.leaves(tgrads):
        assert g.dtype == tcfg.pdt
    _close_leaves(convert.model_params_to_numpy(tgrads),
                  jx.jax.tree.map(lambda x: np.asarray(x, np.float32), grads),
                  rel_grad, "grads")


# ---------------------------------------------------------------------------
# optimizer steps
# ---------------------------------------------------------------------------
def _one_step(jx, tcfg_r, tcfg_t, cfg, tcfg, seed=0):
    """The same state and batch through one step of each package."""
    state = jx.init_state(jx.jax.random.PRNGKey(seed), cfg, tcfg_r)
    tstate = _tstate(jx, state, tcfg)
    batch = _batch()
    rstate, rm = jx.jax.jit(jx.make(cfg, tcfg_r))(
        state, {k: jx.jnp.asarray(v) for k, v in batch.items()})
    tstate, tm = make_train_step(tcfg, tcfg_t)(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    return rstate, rm, tstate, tm


def _check_step(jx, rstate, rm, tstate, tm, adam_t, state_m):
    """Metrics at 2e-5 relative; parameters as the module docstring
    says, from the reference's first moment (m = (1 - b1) g after one
    step)."""
    for k in ("loss", "ce", "lr", "grad_norm"):
        assert abs(float(tm[k]) - float(rm[k])) <= 2e-5 * abs(float(rm[k])), k
    lr = float(rm["lr"])
    got = _leaves(_np(convert.model_params_to_numpy(tstate["params"])))
    want = _leaves(_np(jx.jax.tree.map(np.asarray, rstate["params"])))
    g = _leaves(_np(jx.jax.tree.map(np.asarray, state_m)))
    for p in want:
        err = np.abs(got[p] - want[p])
        flat = np.abs(g[p]) / (1 - adam_t.b1) > 100 * adam_t.eps
        assert err[flat].max(initial=0) <= 2e-6 + 1e-3 * lr, p
        own = lr * (1 + adam_t.weight_decay * np.abs(want[p]))
        assert (err[~flat] <= 2e-6 + own[~flat]).all(), p


@pytest.mark.parametrize("state_dtype", ["f32", "bf16"])
def test_adamw_step(jx, state_dtype):
    """One AdamW step with f32 and bf16 moments: metrics at 2e-5
    relative, parameters (module docstring), moments at 2e-4 of each
    leaf's largest entry in f32 and at one bf16 unit, 2^-8, in bf16 (a
    last-bit difference of the f32 moment can flip its rounding)."""
    cfg, tcfg = _cfgs(jx)
    kw = dict(lr=1e-2, warmup=2, total_steps=100, state_dtype=state_dtype)
    adam_r = jx.adamw.AdamWConfig(**kw)
    adam_t = tadamw.AdamWConfig(**kw)
    rstate, rm, tstate, tm = _one_step(
        jx, jx.TrainConfig(optimizer="adamw", adam=adam_r),
        TrainConfig(optimizer="adamw", adam=adam_t), cfg, tcfg)
    _check_step(jx, rstate, rm, tstate, tm, adam_t, rstate["opt"]["m"])
    opt = convert.opt_state_to_numpy(tstate["opt"])
    assert opt["count"] == int(rstate["opt"]["count"]) == 1
    for k in ("m", "v"):
        _close_leaves(opt[k], jx.jax.tree.map(np.asarray, rstate["opt"][k]),
                      2e-4 if state_dtype == "f32" else 2.0 ** -8, k)


def test_kfac_init(jx):
    """kfac.init: identity statistics and factors for exactly the
    reference's eligible matrices, carried across bitwise."""
    cfg, tcfg = _cfgs(jx)
    tn_r = jx.kfac.TreeNewtonConfig(block=128)
    tn_t = tkfac.TreeNewtonConfig(block=128)
    params = jx.T.init_params(jx.jax.random.PRNGKey(0), cfg)
    want = jx.kfac.init(params, tn_r)
    tparams = convert.model_params_from_reference(
        jx.jax.tree.map(np.asarray, params), tcfg, device="cpu")
    got = tkfac.init(tparams, tn_t)
    carried = convert.opt_state_from_reference(
        jx.jax.tree.map(np.asarray, want), jx.jax.tree.map(np.asarray,
                                                           params), tcfg,
        device="cpu")
    assert set(got["stats"]) == set(carried["stats"]) == {
        f"layers/{i}/{k}" for i in range(2)
        for k in ("attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/w_in",
                  "mlp/w_gate", "mlp/w_out")}
    for p in got["stats"]:
        for part in ("stats", "factors"):
            assert torch.equal(got[part][p], carried[part][p]), (part, p)
    assert got["count"] == carried["count"] == 0


def _spd_stats(rng, nb, n):
    m = rng.uniform(-1, 1, (nb, n, n))
    a = (m + m.transpose(0, 2, 1)) / 2
    a[:, np.arange(n), np.arange(n)] += n
    return a.astype(np.float32)


@pytest.mark.parametrize("path", ["blocked", "tree"])
def test_refactor(jx, path):
    """_refactor on the blocked path (block 512, leaf 128: 4 panels, one
    batched launch a kernel a panel) and on the tree path (block 64 <
    leaf 128: the tree's batched base case), 3 blocks, against the
    reference's vmapped factor: within 1e-4 of each block's largest entry
    (the same bf16_f32 ladder in both: only f32 sums differ), and the
    factors reconstruct the damped statistics within the bf16 ladder's
    4e-2 (tests/test_train.py:187-189)."""
    block = 512 if path == "blocked" else 64
    a = _spd_stats(np.random.default_rng(0), 3, block)
    rcfg = jx.kfac.TreeNewtonConfig(block=block)
    tcfg = tkfac.TreeNewtonConfig(block=block)
    want = np.asarray(jx.kfac._refactor(jx.jnp.asarray(a), rcfg), np.float64)
    got = tkfac._refactor(torch.from_numpy(a), tcfg).double().numpy()
    for i in range(3):
        scale = np.abs(want[i]).max()
        assert np.abs(got[i] - want[i]).max() / scale < 1e-4
    damped = tkfac._damped(torch.from_numpy(a), tcfg).double().numpy()
    rec = np.einsum("bij,bkj->bik", got, got)
    assert np.abs(rec - damped).max() / np.abs(damped).max() < 4e-2


def test_refactor_engines_on_stacks(jx, monkeypatch):
    """The tree engine factors a stack of blocks larger than the leaf
    (the reference's vmapped recursion); engine="auto" naming it for such
    blocks factors them on the tree engine, as the reference's _refactor
    does: bitwise tree_potrf of the damped stack, and within the bf16
    ladder's 4e-2 of each block's largest entry of the reference's
    factor under the same resolution."""
    from repro import tune as rtune
    from repro_torch import tune
    from repro_torch.core import tree_potrf
    a = torch.from_numpy(_spd_stats(np.random.default_rng(4), 2, 256))
    tcfg = tkfac.TreeNewtonConfig(block=256)
    tree = dataclasses.replace(tcfg.precision, engine="tree")
    assert tree_potrf(a, tree).shape == a.shape
    monkeypatch.setattr(tune, "resolve_cfg", lambda c, n, **kw:
                        dataclasses.replace(c, engine="tree"))
    monkeypatch.setattr(rtune, "resolve_cfg", lambda c, n, **kw:
                        dataclasses.replace(c, engine="tree"))
    auto = dataclasses.replace(
        tcfg, precision=dataclasses.replace(tcfg.precision, engine="auto"))
    got = tkfac._refactor(a, auto)
    assert torch.equal(got, tree_potrf(tkfac._damped(a, tcfg), tree))
    rauto = jx.kfac.TreeNewtonConfig(block=256, precision=dataclasses.replace(
        jx.kfac.TreeNewtonConfig().precision, engine="auto"))
    want = np.asarray(jx.kfac._refactor(jx.jnp.asarray(a.numpy()), rauto),
                      np.float64)
    g = got.double().numpy()
    for i in range(2):
        assert np.abs(g[i] - want[i]).max() / np.abs(want[i]).max() < 4e-2


@pytest.mark.parametrize("sweeps", [0, 1])
def test_whiten(jx, sweeps):
    """_whiten with refine_sweeps 0 and 1: a (1024, 96) gradient, two
    blocks of 512, the factors of its statistics made stale by a later
    update; within the bf16 ladder's 4e-2 of the matrix's largest entry
    (module docstring); with a sweep, closer to the exact grafted solve
    (f64) than without."""
    rng = np.random.default_rng(sweeps)
    a = _spd_stats(rng, 2, 512)
    g = rng.standard_normal((1024, 96)).astype(np.float32)
    rcfg = jx.kfac.TreeNewtonConfig(refine_sweeps=sweeps)
    tcfg = tkfac.TreeNewtonConfig(refine_sweeps=sweeps)
    l = np.asarray(jx.kfac._refactor(jx.jnp.asarray(a), rcfg))
    a2 = a * 1.05 + np.eye(512, dtype=np.float32)     # the stats moved on
    want = np.asarray(jx.kfac._whiten(jx.jnp.asarray(g), jx.jnp.asarray(l),
                                      jx.jnp.asarray(a2), rcfg))
    def whiten(c):
        return tkfac._whiten(torch.from_numpy(g), torch.from_numpy(l),
                             torch.from_numpy(a2), c).double().numpy()
    got = whiten(tcfg)
    assert np.abs(got - want).max() / np.abs(want).max() < 4e-2
    if sweeps:
        damped = tkfac._damped(torch.from_numpy(a2), tcfg).double().numpy()
        exact = np.linalg.solve(damped, g.reshape(2, 512, 96)).reshape(g.shape)
        exact *= np.linalg.norm(g) / np.linalg.norm(exact)
        none = whiten(dataclasses.replace(tcfg, refine_sweeps=0))
        assert np.abs(got - exact).max() < np.abs(none - exact).max()


def test_tree_newton_step(jx):
    """One whole TreeNewton step with a refactor (factor_every 1, block
    128 = leaf: one batched potrf_leaf a refactor), from the same
    reference state: metrics and parameters (module docstring), the
    statistics at 1e-5 and the factors at 1e-4 of each matrix's largest
    entry."""
    cfg, tcfg = _cfgs(jx)
    adam_r = jx.adamw.AdamWConfig(lr=1e-2, warmup=2, total_steps=100)
    adam_t = tadamw.AdamWConfig(lr=1e-2, warmup=2, total_steps=100)
    tn_r = jx.kfac.TreeNewtonConfig(adam=adam_r, block=128, factor_every=1)
    tn_t = tkfac.TreeNewtonConfig(adam=adam_t, block=128, factor_every=1)
    rstate, rm, tstate, tm = _one_step(
        jx, jx.TrainConfig(optimizer="tree_newton", tree_newton=tn_r),
        TrainConfig(optimizer="tree_newton", tree_newton=tn_t), cfg, tcfg)
    _check_step(jx, rstate, rm, tstate, tm, adam_t,
                rstate["opt"]["adam"]["m"])
    opt = convert.opt_state_to_numpy(tstate["opt"])
    ropt = rstate["opt"]
    assert opt["count"] == int(ropt["count"]) == 1
    for part, rel in (("stats", 1e-5), ("factors", 1e-4)):
        want = {p: np.asarray(v) for p, v in _leaves(ropt[part]).items()
                if v is not None}
        assert set(opt[part]) == set(want)
        for p, w in want.items():
            g = np.asarray(opt[part][p], np.float64)
            assert np.abs(g - w).max() / np.abs(w).max() <= rel, (part, p)


def test_accum_equivalence():
    """accum=2 matches accum=1 on the same global batch within the
    reference's bounds (tests/test_train.py:64-67)."""
    tcfg = tcommon.ModelConfig(**FIELDS)
    adam = tadamw.AdamWConfig(lr=1e-3, warmup=0, total_steps=100)
    # no masked labels: a microbatch's loss is a mean over its own tokens,
    # so equal weights need equal counts, as in the reference's test
    batch = {k: torch.from_numpy(v) for k, v in _batch(3).items()}
    batch["labels"] = torch.roll(batch["tokens"], -1, dims=1)
    out = []
    for accum in (1, 2):
        t = TrainConfig(optimizer="adamw", adam=adam, accum=accum)
        params = TT.init_params(tcfg, seed=0, device="cpu")
        state = {"params": params, "opt": tadamw.init(params, adam),
                 "step": 0}
        state, m = make_train_step(tcfg, t)(state,
                                            reshape_for_accum(batch, accum))
        out.append((float(m["loss"]), state["params"]))
    assert abs(out[0][0] - out[1][0]) < 1e-4
    d = max(float((a - b).abs().max()) for (_, a), (_, b) in zip(
        tadamw.leaves(out[0][1]), tadamw.leaves(out[1][1])))
    assert d < 1e-5, d


# ---------------------------------------------------------------------------
# the batched solver quantizes each block on its own
# ---------------------------------------------------------------------------
def test_int8_batched_blocks_quantized_each_on_its_own(jx):
    """int8_f32 at leaf 128: a batch of three 512 blocks at scales 1, 1e3
    and 1e-3 through the batched factor and both batched solves. Each
    block's result is bitwise the one-block call's and within the int8
    ladder's 4e-2 of its largest entry of the reference's function under
    jax.vmap. An absmax taken over the whole batch would put the 1e-3
    block on the 1e3 block's int8 grid, where its entries round to 0."""
    cfg = dataclasses.replace(PAPER_CONFIGS["int8_f32"], leaf=128)
    rcfg = dataclasses.replace(jx.PAPER["int8_f32"], leaf=128)
    rng = np.random.default_rng(11)
    sc = np.array([1.0, 1e3, 1e-3], np.float32)[:, None, None]
    a = _spd_stats(rng, 3, 512) * sc
    g = rng.standard_normal((3, 512, 40)).astype(np.float32) * sc
    l = blocked_potrf(torch.from_numpy(a), cfg)
    y = tree_trsm_left(torch.from_numpy(g), l, cfg, trans=False)
    x = tree_trsm_left(y, l, cfg, trans=True)
    for i in range(3):
        li = blocked_potrf(torch.from_numpy(a[i]), cfg)
        assert torch.equal(l[i], li)
        yi = tree_trsm_left(torch.from_numpy(g[i]), li, cfg, trans=False)
        assert torch.equal(x[i], tree_trsm_left(yi, li, cfg, trans=True))
    jnp = jx.jnp
    rl = jx.jax.vmap(lambda m: jx.blocked(m, rcfg))(jnp.asarray(a))
    rx = jx.jax.vmap(lambda r, m: jx.trsm(jx.trsm(r, m, rcfg, trans=False),
                                          m, rcfg, trans=True))(
        jnp.asarray(g), rl)
    for got, want in ((l, rl), (x, rx)):
        want = np.asarray(want, np.float64)
        for i in range(3):
            err = np.abs(got[i].double().numpy() - want[i]).max()
            assert err / np.abs(want[i]).max() < 4e-2, i


# ---------------------------------------------------------------------------
# int8 error-feedback all-reduce on 4 gloo ranks
# ---------------------------------------------------------------------------
def test_ef_allreduce_4_ranks(jx):
    """ef_allreduce_mean on 4 gloo ranks against the reference's under
    jax.vmap(axis_name="dp"), two rounds carrying the residual: the
    reduced gradient within 1e-6 of its largest entry (the same int8 codes
    and scales; the mean of 4 terms summed in another order) and every
    rank's residual equal to the reference's replica's at 1e-6; in the
    same group, the reference's mini data-parallel trainer (600 steps) to
    its bound, max|w - w_true| < 5e-2 (tests/test_train.py:152)."""
    rng = np.random.default_rng(2)
    grads = rng.standard_normal((4, 16, 4)).astype(np.float32)
    grads[2] *= 50                       # one rank's scale dominates
    res0 = (rng.standard_normal((4, 16, 4)) * 1e-2).astype(np.float32)
    fn = jx.jax.vmap(lambda g, r: jx.compress.ef_allreduce_mean(
        {"w": g}, {"w": r}, "dp"), axis_name="dp")
    r = jx.jnp.asarray(res0)
    for _ in range(2):
        red, res = fn(jx.jnp.asarray(grads), r)
        r = res["w"]
    want_red, want_res = np.asarray(red["w"]), np.asarray(r)
    out = launch(run_cases, 4, ([{"kind": "ef_allreduce", "rounds": 2},
                                 {"kind": "train_dp"}], "cpu",
                                {"grad": grads, "residual": res0}),
                 device="cpu", timeout=300)[0]
    ranks, dp = out
    for i, rk in enumerate(ranks):
        np.testing.assert_allclose(rk["reduced"], want_red[i], rtol=0,
                                   atol=1e-6 * np.abs(want_red).max())
        np.testing.assert_allclose(rk["residual"], want_res[i], rtol=0,
                                   atol=1e-6 * np.abs(want_res[i]).max())
    assert dp["err"] < 5e-2, dp


# ---------------------------------------------------------------------------
# every family: gradients, remat, TreeNewton's matrices
# ---------------------------------------------------------------------------
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import rwkv6 as trwkv  # noqa: E402

FAMILY_ARCHS = ["gemma-2b", "pixtral-12b", "musicgen-large",
                "deepseek-v2-lite-16b", "rwkv6-3b", "zamba2-2.7b"]
#: XLA's CPU backend without LLVM's costly passes, as
#: tests/test_torch_zoo.py compiles the reference: IEEE f32 as it is
_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(scope="module")
def rzoo():
    """jax, the reference's configs, model and TreeNewton."""
    jax = pytest.importorskip("jax")
    from repro import configs
    from repro.models import transformer as RT
    from repro.optim import kfac
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, configs=configs,
                                 T=RT, kfac=kfac)


def _family_batch(cfg, seed, length):
    """numpy tokens and next-token labels ([B, S], audio [B, S, C], a few
    labels masked) and, for vlm, patch embeddings [B, n, d] f32."""
    rng = np.random.default_rng(seed)
    shape = (2, length + 1) + ((cfg.n_codebooks,) if cfg.family == "audio"
                               else ())
    toks = rng.integers(0, cfg.vocab, shape).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    batch["labels"][0, :3] = -100
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (2, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _draw_nonzero(layers, family, rng):
    """The recurrent layers' leaves that init sets to zero or one, drawn
    anew (tests/test_torch_recurrent.py): at zero the token shift, the
    bonus and the decay's offset do nothing, and their gradients would go
    unchecked. ``layers`` maps names to numpy arrays, changed in place."""
    draws = {"rwkv": {"mu": lambda s: rng.uniform(0.05, 0.95, s),
                      "mu_c": lambda s: rng.uniform(0.05, 0.95, s),
                      "w0": lambda s: rng.uniform(-1.0, 1.0, s),
                      "u": lambda s: rng.standard_normal(s),
                      "ln_x": lambda s: 0.2 * rng.standard_normal(s)},
             "hybrid": {"A_log": lambda s: 0.5 * rng.standard_normal(s),
                        "D": lambda s: rng.uniform(0.5, 1.5, s),
                        "dt_bias": lambda s: 0.5 * rng.standard_normal(s)}}
    for key, fn in draws.get(family, {}).items():
        layers[key] = fn(layers[key].shape).astype(layers[key].dtype)


def _family_params(rzoo, cfg, weak_decay=False):
    """The reference's smoke parameters as numpy, the recurrent leaves
    drawn nonzero; ``weak_decay`` lowers mamba's A_log by 4 (decays
    exp(-dt e^A_log) near 1), so that the reference's SSD backward stays
    finite over 128 positions (test_reference_fault_ssd_gradient)."""
    jax = rzoo.jax
    ref_np = jax.tree.map(np.asarray, jax.jit(
        lambda k: rzoo.T.init_params(k, cfg))(jax.random.PRNGKey(0)))
    ref_np["layers"] = dict(ref_np["layers"])
    _draw_nonzero(ref_np["layers"], cfg.family, np.random.default_rng(7))
    if weak_decay:
        ref_np["layers"]["A_log"] = ref_np["layers"]["A_log"] - 4
    return ref_np


def _ref_value_and_grad(rzoo, cfg, ref_np, batch):
    jax, jnp = rzoo.jax, rzoo.jnp
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    fn = jax.value_and_grad(lambda p, b: rzoo.T.loss_fn(p, b, cfg),
                            has_aux=True)
    jp = jax.tree.map(jnp.asarray, ref_np)
    return jax.jit(fn).lower(jp, jb).compile(
        compiler_options=_FAST_COMPILE)(jp, jb)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_grads(rzoo, arch):
    """loss_fn and every gradient leaf of each family's smoke config (f32,
    remat on in both packages; S = 32, the hybrid's S = 256: two SSD
    chunks of 128, with weak decays, see _family_params) against
    jax.value_and_grad of the reference: the loss at 1e-5 relative, the
    aux loss at 1e-5 relative, each gradient within 2e-4 of its leaf's
    largest entry, as the dense family above (f32 sums in other orders;
    the MoE's routing is the same in both, the expert loop and its
    combine differentiated)."""
    jax = rzoo.jax
    cfg = rzoo.configs.get_config(arch, smoke=True)
    tcfg = tconfigs.get_config(arch, smoke=True)
    hybrid = cfg.family == "hybrid"
    ref_np = _family_params(rzoo, cfg, weak_decay=hybrid)
    batch = _family_batch(cfg, 8, 256 if hybrid else 32)
    (loss, m), grads = _ref_value_and_grad(rzoo, cfg, ref_np, batch)
    from repro_torch.train.step import _value_and_grad
    tparams = convert.model_params_from_reference(ref_np, tcfg,
                                                  device="cpu")
    tloss, tm, tgrads = _value_and_grad(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    assert abs(float(tloss) - float(loss)) <= 1e-5 * abs(float(loss))
    assert abs(float(tm["aux"]) - float(m["aux"])) <= 1e-5 * abs(
        float(m["aux"]))
    _close_leaves(convert.model_params_to_numpy(tgrads),
                  jax.tree.map(lambda x: np.asarray(x, np.float32), grads),
                  2e-4, arch)


def test_reference_fault_ssd_gradient(rzoo):
    """A fault of the reference: its SSD takes exp of the whole [Q, Q]
    segment sums and zeroes the upper triangle after it; over 128
    positions of the smoke config's decays those sums pass f32's range,
    exp gives inf, and the backward's 0 * inf makes the gradients NaN, so
    the reference cannot train zamba2 on a sequence of 128 or more. The
    port masks the exponent first: the same loss (1e-5 relative) and
    finite gradients."""
    jax = rzoo.jax
    arch = "zamba2-2.7b"
    cfg = rzoo.configs.get_config(arch, smoke=True)
    tcfg = tconfigs.get_config(arch, smoke=True)
    ref_np = jax.tree.map(np.asarray, rzoo.T.init_params(
        jax.random.PRNGKey(0), cfg))
    batch = _family_batch(cfg, 8, 128)
    (loss, _), grads = _ref_value_and_grad(rzoo, cfg, ref_np, batch)
    assert not np.isfinite(np.asarray(grads["embed"])).all()
    from repro_torch.train.step import _value_and_grad
    tloss, _, tgrads = _value_and_grad(
        convert.model_params_from_reference(ref_np, tcfg, device="cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    assert abs(float(tloss) - float(loss)) <= 1e-5 * abs(float(loss))
    for p, g in tadamw.leaves(tgrads):
        assert torch.isfinite(g).all(), p


def _counting(monkeypatch, module):
    """Count the calls of ``module.checkpoint`` (still checkpointing)."""
    calls = []
    real = module.checkpoint

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(module, "checkpoint", counted)
    return calls


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-2.7b"])
def test_remat_grads_bitwise(arch, monkeypatch):
    """Remat has no numeric effect: loss and gradients with per-layer
    remat (and rwkv's checkpointed TIME_CHUNK chunks) bitwise equal to a
    run without any checkpoint, at S = 256 (rwkv: two chunks; the SSD:
    two chunks of 128); the checkpoints did run."""
    tcfg = tconfigs.get_config(arch, smoke=True)
    params = TT.init_params(tcfg, seed=0, device="cpu")
    rng = np.random.default_rng(9)
    for layer in params["layers"]:
        drawn = {k: v.numpy().copy() for k, v in layer.items()}
        _draw_nonzero(drawn, tcfg.family, rng)
        if "A_log" in drawn:        # decays near 1 over the 256 positions
            drawn["A_log"] -= 4
        for k, v in drawn.items():
            layer[k] = torch.from_numpy(v)
    batch = {k: torch.from_numpy(v)
             for k, v in _family_batch(tcfg, 10, 256).items()}
    from repro_torch.train.step import _value_and_grad
    layer_calls = _counting(monkeypatch, TT)
    chunk_calls = _counting(monkeypatch, trwkv)
    on = _value_and_grad(params, batch, tcfg.replace(remat=True))
    n_ckpt = tcfg.n_layers + (2 if tcfg.family == "hybrid" else 0)
    assert len(layer_calls) == n_ckpt
    if tcfg.family == "rwkv":
        assert trwkv.TIME_CHUNK == 128
        # two chunks a layer in the forward and in the layer's recompute
        assert len(chunk_calls) == 2 * 2 * tcfg.n_layers

    def direct(fn, *a, use_reentrant=None, **kw):
        return fn(*a, **kw)
    monkeypatch.setattr(trwkv, "checkpoint", direct)
    off = _value_and_grad(params, batch, tcfg.replace(remat=False))
    assert torch.isfinite(on[0]) and torch.equal(on[0], off[0])
    for (p, g), (_, h) in zip(tadamw.leaves(on[2]), tadamw.leaves(off[2])):
        assert torch.isfinite(g).all() and torch.equal(g, h), p


def _ref_tree_newton_paths(rzoo, cfg, block):
    """The port's paths of the matrices the reference's kfac.init keeps
    statistics for, each with its per-matrix shape (nb, block, block)."""
    jax = rzoo.jax
    shapes = jax.eval_shape(lambda: rzoo.kfac.init(
        rzoo.T.init_params(jax.random.PRNGKey(0), cfg),
        rzoo.kfac.TreeNewtonConfig(block=block)))
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            shapes["stats"])[0]:
        name = "/".join(str(k.key) for k in path)
        key, _, rest = name.partition("/")
        if key in ("layers", "dense_layers"):
            for i in range(leaf.shape[0]):
                out[f"{key}/{i}/{rest}"] = tuple(leaf.shape[1:])
        else:
            out[name] = tuple(leaf.shape)
    return out


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_tree_newton_paths_match_reference(rzoo, arch):
    """TreeNewton whitens exactly the reference's matrices for every arch
    (smoke config, block 32): the same paths and per-matrix shapes in
    kfac.init and in the whitening's groups; the MoE expert stacks
    ([E, d, F] a layer, [L, E, d, F] stacked) go to AdamW."""
    block = 32
    want = _ref_tree_newton_paths(
        rzoo, rzoo.configs.get_config(arch, smoke=True), block)
    tcfg = tconfigs.get_config(arch, smoke=True)
    tn = tkfac.TreeNewtonConfig(block=block)
    params = TT.init_params(tcfg, seed=0, device="cpu")
    got = tkfac.init(params, tn)
    assert {p: tuple(s.shape) for p, s in got["stats"].items()} == want
    grouped = [p for ps in tkfac.whiten_groups(params, tn).values()
               for p in ps]
    assert sorted(grouped) == sorted(want)
    assert not [p for p in want if p.endswith(("moe/w_in", "moe/w_out"))]


def test_convert_moe_tree_newton_state(rzoo):
    """A TreeNewton state of deepseek-v2-lite's smoke config (one dense
    layer, two MoE layers), its statistics and factors drawn at random,
    crosses to the port (``dense_layers/0/...`` and ``layers/<i>/...``)
    and back to the reference's layout bitwise."""
    jax = rzoo.jax
    arch = "deepseek-v2-lite-16b"
    cfg = rzoo.configs.get_config(arch, smoke=True)
    tcfg = tconfigs.get_config(arch, smoke=True)
    params = jax.tree.map(np.asarray, rzoo.T.init_params(
        jax.random.PRNGKey(0), cfg))
    state = jax.tree.map(np.asarray, rzoo.kfac.init(
        params, rzoo.kfac.TreeNewtonConfig(block=32)))
    rng = np.random.default_rng(12)
    for part in ("stats", "factors"):
        state[part] = jax.tree.map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32),
            state[part])
    state["count"] = np.int32(5)
    port = convert.opt_state_from_reference(state, params, tcfg,
                                            device="cpu")
    assert port["count"] == 5
    assert "dense_layers/0/mlp/w_in" in port["stats"]
    assert {f"layers/{i}/attn/wo" for i in range(2)} <= set(port["stats"])
    np.testing.assert_array_equal(
        port["stats"]["layers/1/attn/wo"].numpy(),
        state["stats"]["layers"]["attn"]["wo"][1])
    back = convert.opt_state_to_numpy(port)
    want = {p: a for p, a in _leaves(state["stats"]).items()
            if a is not None}
    assert set(back["stats"]) == set(want)
    for p, a in want.items():
        assert np.array_equal(back["stats"][p], a), p
        assert np.array_equal(back["factors"][p],
                              _leaves(state["factors"])[p]), p
    for k in ("m", "v"):
        for p, a in _leaves(state["adam"][k]).items():
            assert np.array_equal(_leaves(back["adam"][k])[p], a), (k, p)
    assert back["count"] == 5 and back["adam"]["count"] == 0
