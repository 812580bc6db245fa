"""Model backbone, in torch: the transformer families of the zoo.

Counterpart of ``repro/models/transformer.py`` for the families
  dense — attention + MLP (nemotron, gemma, granite)
  vlm   — dense backbone, the first ``n_img_tokens`` positions fed by
          projected patch embeddings (pixtral's stub frontend;
          ``batch["patch_embeds"]`` [B, n, d], except in decode)
  audio — dense backbone over summed codebook embeddings, one logit head
          per codebook (musicgen's stub frontend; tokens [B, S, C],
          logits [B, S, C, V])
  moe   — MLA attention (``mla.py``) + shared and routed experts
          (``moe.py``); the first ``moe_first_dense`` layers keep a dense
          MLP (deepseek v2/v3)
  rwkv   — RWKV-6 blocks (``rwkv6.py``; attention-free)
  hybrid — Mamba-2 blocks (``mamba2.py``) with one *param-shared*
          attention + MLP block (``shared_attn``) applied after each of
          ``max(L // attn_every, 1)`` groups of blocks (zamba2)

Parameters are a plain dict with the reference's names and its weight
layout ``[d_in, d_out]`` (``x @ w`` is the reference's
``einsum("bsd,dq->bsq")``), except that the layers (and moe's
``dense_layers``) are lists of per-layer dicts where the reference
stacks them ``[L, ...]`` for ``lax.scan``: the layers run in a Python
loop. A layer's expert weights stay stacked ``[E, d, F]``; the hybrid's
``shared_attn`` is one layer dict.
:func:`repro_torch.convert.model_params_from_reference` unstacks a
reference pytree into this form.

Execution modes:
  train   — full sequence, no KV caches; differentiable (``loss_fn``):
            with ``cfg.remat`` each layer runs under
            ``torch.utils.checkpoint`` (non-reentrant), the counterpart of
            the reference's per-layer ``jax.checkpoint``, so the backward
            pass recomputes a layer's activations from its input
  prefill — full sequence, returns per-layer caches of length S
  decode  — one token at position ``pos`` against caller-provided caches,
            which are updated IN PLACE (the reference returns new arrays),
            the recurrent states too

Caches keep the reference's layout: ``{"main": {"k", "v"}}`` with leaves
``[L, B, S, KV, hd]``; MLA's ``{"c", "kr"}`` leaves ``[L, B, S, R]``, and
moe with dense layers ``{"dense": ..., "main": ...}``; rwkv's
``{"s", "x_tm", "x_cm"}`` leaves ``[L, B, ...]`` (no sequence axis); the
hybrid's ``{"mamba": {"ssm", "conv"}, "attn": {"k", "v"}}``, the mamba
leaves ``[L, B, ...]`` and the attention ones ``[n_apps, B, S, KV, hd]``.

Under a mesh (``sharder`` from ``launch.sharding.make_sharder``) the
parameters, batch and caches are DTensors (``convert.place_params``,
``place_batch``, ``place_caches``) and each block keeps the reference's
sequence-parallel discipline (``_tf_block``'s ``pin``). The dense, vlm,
audio and moe families run under a mesh; rwkv and hybrid raise there
(ROADMAP A3).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import mamba2, mla, moe, rwkv6
from repro_torch.models.common import (NO_SHARD, ModelConfig, Sharder,
                                       _init, cross_entropy, matmul,
                                       mlp_apply, mlp_params, rms_norm,
                                       sharded_cross_entropy)

FAMILIES = ("dense", "vlm", "audio", "moe", "rwkv", "hybrid")
AUX_LOSS_W = 0.01


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"family {cfg.family!r} ({cfg.name}) is none of "
                         f"{FAMILIES}")


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------
def _tf_layer_params(cfg: ModelConfig, *, use_moe: bool, generator,
                     device):
    kw = dict(generator=generator, device=device)
    p = {"ln1": torch.zeros((cfg.d_model,), dtype=cfg.pdt, device=device),
         "ln2": torch.zeros((cfg.d_model,), dtype=cfg.pdt, device=device),
         "attn": (mla.mla_params(cfg, **kw) if cfg.mla
                  else attn.attn_params(cfg, **kw))}
    if use_moe:
        p["moe"] = moe.moe_params(cfg, **kw)
    else:
        p["mlp"] = mlp_params(cfg.d_model, cfg.d_ff, cfg.mlp, cfg.pdt, **kw)
    return p


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    """Random parameters drawn on ``device`` from a ``torch.Generator``
    there seeded with ``seed``. Raises if ``device`` is CUDA and there is
    none. On ``"meta"`` the parameters have shapes and dtypes only (a
    template for ``checkpoint.restore``)."""
    _check_family(cfg)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' asked for, but torch sees no CUDA "
                           "device; pass device='cpu' to run on the CPU")
    generator = (None if device.type == "meta" else
                 torch.Generator(device=device).manual_seed(seed))
    kw = dict(generator=generator, device=device)
    d = cfg.d_model
    params: dict[str, Any] = {
        "final_ln": torch.zeros((d,), dtype=cfg.pdt, device=device)}
    if cfg.family == "audio":
        params["embed"] = _init((cfg.n_codebooks, cfg.vocab, d), cfg.pdt,
                                **kw)
        params["lm_head"] = _init((cfg.n_codebooks, d, cfg.vocab), cfg.pdt,
                                  **kw)
    else:
        params["embed"] = _init((cfg.vocab, d), cfg.pdt, **kw)
        params["lm_head"] = _init((d, cfg.vocab), cfg.pdt, **kw)
    if cfg.family == "vlm":
        params["patch_proj"] = _init((d, d), cfg.pdt, **kw)
    if cfg.family == "rwkv":
        params["layers"] = [rwkv6.rwkv_params(cfg, **kw)
                            for _ in range(cfg.n_layers)]
        return params
    if cfg.family == "hybrid":
        params["layers"] = [mamba2.mamba_params(cfg, **kw)
                            for _ in range(cfg.n_layers)]
        params["shared_attn"] = _tf_layer_params(cfg, use_moe=False, **kw)
        return params
    use_moe = cfg.family == "moe"
    n_dense = cfg.moe_first_dense if use_moe else 0
    if n_dense:
        params["dense_layers"] = [
            _tf_layer_params(cfg, use_moe=False, **kw)
            for _ in range(n_dense)]
    params["layers"] = [_tf_layer_params(cfg, use_moe=use_moe, **kw)
                        for _ in range(cfg.n_layers - n_dense)]
    return params


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def _tf_block(x, p, cfg: ModelConfig, sharder: Sharder = NO_SHARD, *,
              use_moe: bool, pos=None, cache=None):
    """Returns (x, kv_or_cache, aux); aux is None without experts.

    Sequence-parallel discipline (the reference's): the residual stream
    is seq-sharded, the norms run in the sharded domain, and where the
    heads divide the model axis (``pin``) the gather is pinned to the
    norm's output (``act_full(act_bsd(h))``) and each branch output is
    constrained seq-sharded before its residual add."""
    pin = sharder._fits(cfg.n_heads) if cfg.n_heads else False

    def norm_then_gather(x, gamma):
        h = rms_norm(x, gamma, cfg.norm_eps)
        if not pin:
            return h
        return sharder.act_full(sharder.act_bsd(h))

    h = norm_then_gather(x, p["ln1"])
    attn_fn = mla.mla_attention if cfg.mla else attn.attention
    a, kv = attn_fn(h, p["attn"], cfg, sharder, pos=pos, cache=cache)
    x = x + (sharder.act_bsd(a) if pin else a)
    h = norm_then_gather(x, p["ln2"])
    aux = None
    if use_moe:
        f, aux = moe.moe_ffn(h, p["moe"], cfg, sharder)
    else:
        f = mlp_apply(h, p["mlp"]["w_in"], p["mlp"].get("w_gate"),
                      p["mlp"]["w_out"], cfg.mlp, sharder)
    x = (x + sharder.act_bsd(f)) if pin else sharder.act_bsd(x + f)
    return x, kv, aux


# ---------------------------------------------------------------------------
# embedding / heads (the modality stubs)
# ---------------------------------------------------------------------------
def embed_inputs(params, batch, cfg: ModelConfig,
                 sharder: Sharder = NO_SHARD, *, decode: bool = False):
    _check_family(cfg)
    dev = params["embed"].device
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    # F.embedding, not indexing: on the CPU the backward of an indexed
    # gather accumulates the rows of repeated tokens in a varying order,
    # embedding's backward always in the tokens' order
    if sharder.enabled:
        # the ids gathered (a few bytes), the table never: see _lookup
        tokens = sharder.local(tokens, (None,) * tokens.ndim)
    if cfg.family == "audio":
        # 0 + e_0 + e_1 + ..., each add in the parameters' dtype
        emb = params["embed"]
        x = _lookup(tokens[..., 0], emb[0], sharder)
        for i in range(1, cfg.n_codebooks):
            x = x + _lookup(tokens[..., i], emb[i], sharder)
    else:
        x = _lookup(tokens, params["embed"], sharder)
    if cfg.family == "vlm" and cfg.n_img_tokens and not decode:
        # patch embeddings, projected as JAX promotes (f32 embeddings and
        # bf16 weights multiply in f32), then cast to the embedding dtype
        pe = torch.as_tensor(batch["patch_embeds"], device=dev)
        pe = matmul(pe, params["patch_proj"]).to(x.dtype)
        n = cfg.n_img_tokens
        x = torch.cat([pe[:, :n], x[:, n:]], dim=1)
    return sharder.act_bsd(x.to(cfg.adt))


def _lookup(tokens, table, sharder: Sharder):
    """``F.embedding(tokens, table)``. Under a mesh ``tokens`` is every
    rank's whole [B, S] and ``table`` [V, D] a DTensor: each rank looks
    up the rows of its own vocab range (other ids give zeros) and its own
    columns, so the result is Partial over the axes that shard the vocab
    and sharded on D over those that shard D; the next constraint reduces
    it (one nonzero term an element: the sum is exact)."""
    if not sharder.enabled:
        return F.embedding(tokens, table)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    local = table.to_local()
    rows, out = local.shape[0], []
    lo = 0
    for i, pl in enumerate(table.placements):
        if pl == Shard(0):
            lo = lo * table.device_mesh.size(i) + table.device_mesh \
                .get_local_rank(i)
            out.append(Partial())
        elif pl == Shard(1):
            out.append(Shard(tokens.ndim))
        else:
            out.append(Replicate())
    idx = tokens - lo * rows
    ok = (idx >= 0) & (idx < rows)
    x = F.embedding(torch.where(ok, idx, 0), local)
    x = torch.where(ok[..., None], x, torch.zeros((), dtype=x.dtype,
                                                  device=x.device))
    return DTensor.from_local(x, table.device_mesh, out, run_check=False)


def lm_logits(params, x, cfg: ModelConfig, sharder: Sharder = NO_SHARD):
    # the sequence gathered first: DTensor (torch 2.11) cannot flatten a
    # sequence-sharded [B, S, D] into the head's product
    x = sharder.act_full(rms_norm(x, params["final_ln"], cfg.norm_eps))
    head = params["lm_head"]
    if cfg.family == "audio":
        dt = torch.promote_types(x.dtype, head.dtype)
        return torch.einsum("bsd,cdv->bscv", x.to(dt), head.to(dt)).float()
    return sharder.logits(matmul(x, head)).float()


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _layer_groups(params, cfg: ModelConfig):
    """(cache key, layers, use_moe) in the order they run."""
    use_moe = cfg.family == "moe"
    groups = []
    if use_moe and params.get("dense_layers"):
        groups.append(("dense", params["dense_layers"], False))
    groups.append(("main", params["layers"], use_moe))
    return groups


def forward(params, batch, cfg: ModelConfig, sharder: Sharder = NO_SHARD,
            *, mode: str = "train", caches=None, pos=None,
            last_only: bool = False):
    """Returns (logits, aux_loss, new_caches).

    mode='train'  : caches/pos ignored; new_caches is None (rwkv: the
                    final recurrent states, which it always collects).
    mode='prefill': new_caches hold per-layer caches (length S) and
                    recurrent states.
    mode='decode' : batch tokens have S=1; ``caches`` required and written
                    in place; ``pos`` is the absolute write/attend position.
    last_only     : compute logits for the final position only (prefill
                    serving path — avoids the [B, S, V] tensor).
    aux_loss is the experts' load-balance loss summed in f32 over the
    layers in order (0 without experts).

    The recurrent families start from the states in ``caches`` where
    they are given, as the reference does.
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(mode)
    if sharder.enabled and cfg.family in ("rwkv", "hybrid"):
        raise NotImplementedError(f"the {cfg.family} family under a mesh "
                                  "(ROADMAP A3)")
    decode = mode == "decode"
    x = embed_inputs(params, batch, cfg, sharder, decode=decode)
    if cfg.family == "rwkv":
        x, new_caches = _forward_rwkv(params, x, cfg, caches=caches,
                                      decode=decode, remat=_remat(mode, cfg))
    elif cfg.family == "hybrid":
        x, new_caches = _forward_hybrid(params, x, cfg, mode=mode,
                                        caches=caches, pos=pos)
    else:
        return _forward_tf(params, x, cfg, sharder, mode=mode,
                           caches=caches, pos=pos, last_only=last_only)
    logits = lm_logits(params, x[:, -1:] if last_only else x, cfg)
    return logits, torch.zeros((), dtype=torch.float32,
                               device=x.device), new_caches


def _forward_tf(params, x, cfg: ModelConfig, sharder: Sharder, *, mode,
                caches, pos, last_only):
    """The transformer families' layers and head (``forward``'s
    result)."""
    decode = mode == "decode"
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = _remat(mode, cfg)
    new_caches: dict[str, Any] = {}
    for name, layers, use_moe in _layer_groups(params, cfg):
        group = caches[name] if decode else None
        collected = []
        acc = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, p_l in enumerate(layers):
            if remat:
                x, a = checkpoint(_train_block, x, p_l, cfg, use_moe,
                                  sharder, use_reentrant=False)
            else:
                x, kv, a = _tf_block(x, p_l, cfg, sharder, use_moe=use_moe,
                                     pos=pos if decode else None,
                                     cache=_layer_states(group, i))
                if mode == "prefill":
                    collected.append(kv)
            if a is not None:
                acc = acc + a
        aux = aux + acc
        if mode == "prefill":
            new_caches[name] = _stacked(collected)
    logits = lm_logits(params, x[:, -1:] if last_only else x, cfg, sharder)
    if mode == "train":
        return logits, aux, None
    if decode:
        return logits, aux, caches
    return logits, aux, new_caches


def _remat(mode, cfg: ModelConfig) -> bool:
    """Per-layer remat: a train forward under ``cfg.remat`` that is to be
    differentiated runs each layer under ``torch.utils.checkpoint``."""
    return mode == "train" and cfg.remat and torch.is_grad_enabled()


def _layer_states(states, i):
    """Layer i's views of stacked ``[L, ...]`` states (None stays)."""
    return None if states is None else {k: v[i] for k, v in states.items()}


def _stacked(per_layer):
    """Per-layer dicts of tensors -> one dict of ``[L, ...]`` stacks."""
    return {k: torch.stack([d[k] for d in per_layer]) for k in per_layer[0]}


def _write_states(states, i, new):
    """Layer i's new states written into the stacked ones, in place."""
    for k, v in new.items():
        states[k][i].copy_(v)


def _forward_rwkv(params, x, cfg: ModelConfig, *, caches, decode,
                  remat=False):
    """RWKV-6: the blocks in order, each from its state in ``caches``
    (zeros where there are none), each under a checkpoint with ``remat``.
    The new states are always collected, as the reference collects them
    (they are small): stacked ``[L, ...]``, or in decode written into
    ``caches`` in place."""
    collected = []
    for i, p_l in enumerate(params["layers"]):
        state = _layer_states(caches, i)
        if remat:
            x, st = checkpoint(rwkv6.rwkv_block, x, p_l, cfg, state=state,
                               use_reentrant=False)
        else:
            x, st = rwkv6.rwkv_block(x, p_l, cfg, state=state)
        if decode:
            _write_states(caches, i, st)
        else:
            collected.append(st)
    if decode:
        return x, caches
    return x, _stacked(collected)


def _forward_hybrid(params, x, cfg: ModelConfig, *, mode, caches, pos):
    """Zamba2: ``n_apps = max(L // attn_every, 1)`` groups of ``L //
    n_apps`` mamba blocks, each group followed by the shared attention +
    MLP block (one set of parameters; each application has its own KV
    cache). Returns (x, caches): in prefill the mamba states stacked
    ``[n_apps * (L // n_apps), ...]`` and the applications' keys and
    values ``[n_apps, B, S, KV, hd]``; in decode ``caches``, updated in
    place; in train None. Under per-layer remat each mamba block and each
    application of the shared block runs under its own checkpoint, as the
    reference checkpoints the shared block apart from its layer scan."""
    decode = mode == "decode"
    remat = _remat(mode, cfg)
    k = cfg.attn_every or cfg.n_layers
    n_apps = max(cfg.n_layers // k, 1)
    Lg = cfg.n_layers // n_apps
    m_states = caches["mamba"] if caches is not None else None
    new_m, new_a = [], []
    for g in range(n_apps):
        for i in range(g * Lg, (g + 1) * Lg):
            state = _layer_states(m_states, i)
            if remat:
                x, st = checkpoint(mamba2.mamba_block, x, params["layers"][i],
                                   cfg, state=state, use_reentrant=False)
            else:
                x, st = mamba2.mamba_block(x, params["layers"][i], cfg,
                                           state=state)
            if decode:
                _write_states(m_states, i, st)
            else:
                new_m.append(st)
        if remat:
            x, _ = checkpoint(_train_block, x, params["shared_attn"], cfg,
                              False, use_reentrant=False)
        else:
            ac = _layer_states(caches["attn"], g) if decode else None
            x, kv, _ = _tf_block(x, params["shared_attn"], cfg,
                                 use_moe=False, pos=pos if decode else None,
                                 cache=ac)
            new_a.append(kv)
    if decode:
        return x, caches
    if mode == "train":
        return x, None
    return x, {"mamba": _stacked(new_m), "attn": _stacked(new_a)}


def _train_block(x, p, cfg: ModelConfig, use_moe: bool,
                 sharder: Sharder = NO_SHARD):
    x, _, aux = _tf_block(x, p, cfg, sharder, use_moe=use_moe)
    return x, aux


def pad_caches(caches, to_len: int):
    """Grow prefill caches (length S) to a decode buffer of ``to_len``.

    Only sequence-indexed attention leaves (k/v/c/kr) with at least four
    axes are padded, with zeros, along axis 2; others pass through. A
    DTensor leaf is padded shard by shard (no cache spec shards axis 2).
    """
    seq_leaves = {"k", "v", "c", "kr"}

    def grow(leaf):
        shape = list(leaf.shape)
        shape[2] = to_len
        out = leaf.new_zeros(shape)
        out[:, :, :leaf.shape[2]] = leaf
        return out

    def pad(key, leaf: Any):
        if isinstance(leaf, dict):
            return {k: pad(k, v) for k, v in leaf.items()}
        if key in seq_leaves and leaf.dim() >= 4 and leaf.shape[2] < to_len:
            from torch.distributed.tensor import DTensor
            if isinstance(leaf, DTensor):
                return DTensor.from_local(grow(leaf.to_local()),
                                          leaf.device_mesh, leaf.placements,
                                          run_check=False)
            return grow(leaf)
        return leaf

    return pad(None, caches)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def loss_fn(params, batch, cfg: ModelConfig, sharder: Sharder = NO_SHARD):
    """``(ce + AUX_LOSS_W * aux, {"ce": ce, "aux": aux})`` of the train
    forward, ``batch`` holding ``tokens`` and ``labels`` [B, S] (audio:
    [B, S, C], ce the mean of the C codebooks' cross-entropies; vlm also
    ``patch_embeds``). Under a mesh the parameters and batch are
    DTensors, the cross-entropy is vocab-parallel over the sharder's
    logits (``common.sharded_cross_entropy``) and the results are plain
    scalar tensors, equal on every rank."""
    logits, aux, _ = forward(params, batch, cfg, sharder, mode="train")
    if sharder.enabled:
        ce = sharded_cross_entropy(logits, batch["labels"], sharder)
        return ce + AUX_LOSS_W * aux, {"ce": ce, "aux": aux}
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    if cfg.family == "audio":
        ce = cross_entropy(logits[:, :, 0], labels[..., 0])
        for i in range(1, cfg.n_codebooks):
            ce = ce + cross_entropy(logits[:, :, i], labels[..., i])
        ce = ce / cfg.n_codebooks
    else:
        ce = cross_entropy(logits, labels)
    return ce + AUX_LOSS_W * aux, {"ce": ce, "aux": aux}
