"""The port's training path against the JAX reference, on the CPU: the loss
and its gradients, one AdamW step, TreeNewton's init, refactor, whitening
and a whole step, gradient accumulation, the batched solver's per-block
quantization, and the int8 error-feedback all-reduce on 4 gloo ranks.

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


def test_refactor_engines_on_stacks(monkeypatch):
    """The tree engine refuses a stack of blocks larger than the leaf (no
    batched recursion: one recursion a block would cost thousands of
    launches); engine="auto" naming it for such blocks factors them on
    the blocked engine, bitwise blocked_potrf of the damped stack."""
    from repro_torch import tune
    from repro_torch.core import tree_potrf
    a = torch.from_numpy(_spd_stats(np.random.default_rng(4), 2, 256))
    tcfg = tkfac.TreeNewtonConfig(block=256)
    with pytest.raises(NotImplementedError):
        tree_potrf(a, dataclasses.replace(tcfg.precision, engine="tree"))
    monkeypatch.setattr(tune, "resolve_cfg", lambda c, n, **kw:
                        dataclasses.replace(c, engine="tree"))
    auto = dataclasses.replace(
        tcfg, precision=dataclasses.replace(tcfg.precision, engine="auto"))
    got = tkfac._refactor(a, auto)
    assert torch.equal(got, blocked_potrf(tkfac._damped(a, tcfg),
                                          tcfg.precision))


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
