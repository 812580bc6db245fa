"""Model backbone, in torch: the dense family (attention + MLP).

Counterpart of ``repro/models/transformer.py`` for ``family="dense"``
(nemotron, gemma, granite). The other families (``vlm``, ``audio``,
``moe``, ``rwkv``, ``hybrid``) raise ``NotImplementedError`` naming
ROADMAP A12.

Parameters are a plain dict with the reference's names and its weight
layout ``[d_in, d_out]`` (``x @ w`` is the reference's
``einsum("bsd,dq->bsq")``), except that the layers are a list of
per-layer dicts where the reference stacks them ``[L, ...]`` for
``lax.scan``: the layers run in a Python loop.
:func:`repro_torch.convert.model_params_from_reference` unstacks a
reference pytree into this form.

Execution modes:
  train   — full sequence, no KV caches
  prefill — full sequence, returns per-layer caches of length S
  decode  — one token at position ``pos`` against caller-provided caches,
            which are updated IN PLACE (the reference returns new arrays)

Caches keep the reference's layout: ``{"main": {"k", "v"}}`` with leaves
``[L, B, S, KV, hd]``.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import attention as attn
from repro_torch.models.common import (ModelConfig, _init, matmul,
                                       mlp_apply, mlp_params, rms_norm)

FAMILY_ITEM = "ROADMAP A12 (model zoo: the non-dense families)"


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} ({cfg.name}) is "
                                  f"{FAMILY_ITEM}")


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------
def _tf_layer_params(cfg: ModelConfig, *, generator, device):
    kw = dict(generator=generator, device=device)
    return {"ln1": torch.zeros((cfg.d_model,), dtype=cfg.pdt, device=device),
            "ln2": torch.zeros((cfg.d_model,), dtype=cfg.pdt, device=device),
            "attn": attn.attn_params(cfg, **kw),
            "mlp": mlp_params(cfg.d_model, cfg.d_ff, cfg.mlp, cfg.pdt, **kw)}


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    """Random parameters drawn on ``device`` from a ``torch.Generator``
    there seeded with ``seed``. Raises if ``device`` is CUDA and there is
    none."""
    _check_family(cfg)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' asked for, but torch sees no CUDA "
                           "device; pass device='cpu' to run on the CPU")
    generator = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=generator, device=device)
    d = cfg.d_model
    return {"final_ln": torch.zeros((d,), dtype=cfg.pdt, device=device),
            "embed": _init((cfg.vocab, d), cfg.pdt, **kw),
            "lm_head": _init((d, cfg.vocab), cfg.pdt, **kw),
            "layers": [_tf_layer_params(cfg, **kw)
                       for _ in range(cfg.n_layers)]}


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def _tf_block(x, p, cfg: ModelConfig, *, pos=None, cache=None):
    """Returns (x, kv_or_cache)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a, kv = attn.attention(h, p["attn"], cfg, pos=pos, cache=cache)
    x = x + a
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    f = mlp_apply(h, p["mlp"]["w_in"], p["mlp"].get("w_gate"),
                  p["mlp"]["w_out"], cfg.mlp)
    return x + f, kv


def embed_inputs(params, batch, cfg: ModelConfig):
    _check_family(cfg)
    tokens = torch.as_tensor(batch["tokens"], device=params["embed"].device)
    return params["embed"][tokens].to(cfg.adt)


def lm_logits(params, x, cfg: ModelConfig):
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return matmul(x, params["lm_head"]).float()


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def forward(params, batch, cfg: ModelConfig, *, mode: str = "train",
            caches=None, pos=None, last_only: bool = False):
    """Returns (logits, aux_loss, new_caches).

    mode='train'  : caches/pos ignored; new_caches is None.
    mode='prefill': new_caches hold per-layer KV (length S).
    mode='decode' : batch tokens have S=1; ``caches`` required and written
                    in place; ``pos`` is the absolute write/attend position.
    last_only     : compute logits for the final position only (prefill
                    serving path — avoids the [B, S, V] tensor).
    The dense family has no auxiliary loss: aux_loss is a 0 in f32.
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(mode)
    decode = mode == "decode"
    x = embed_inputs(params, batch, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    main = caches["main"] if decode else None
    ks, vs = [], []
    for i, p_l in enumerate(params["layers"]):
        c_l = ({"k": main["k"][i], "v": main["v"][i]} if decode else None)
        x, kv = _tf_block(x, p_l, cfg, pos=pos if decode else None,
                          cache=c_l)
        if mode == "prefill":
            ks.append(kv["k"])
            vs.append(kv["v"])
    logits = lm_logits(params, x[:, -1:] if last_only else x, cfg)
    if mode == "train":
        return logits, aux, None
    if decode:
        return logits, aux, caches
    return logits, aux, {"main": {"k": torch.stack(ks), "v": torch.stack(vs)}}


def pad_caches(caches, to_len: int):
    """Grow prefill caches (length S) to a decode buffer of ``to_len``.

    Only sequence-indexed attention leaves (k/v/c/kr) with at least four
    axes are padded, with zeros, along axis 2; others pass through.
    """
    seq_leaves = {"k", "v", "c", "kr"}

    def pad(key, leaf: Any):
        if isinstance(leaf, dict):
            return {k: pad(k, v) for k, v in leaf.items()}
        if key in seq_leaves and leaf.dim() >= 4 and leaf.shape[2] < to_len:
            shape = list(leaf.shape)
            shape[2] = to_len
            out = leaf.new_zeros(shape)
            out[:, :, :leaf.shape[2]] = leaf
            return out
        return leaf

    return pad(None, caches)
