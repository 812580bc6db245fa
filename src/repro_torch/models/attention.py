"""GQA/MQA/MHA attention with a KV cache, in torch.

Counterpart of ``repro/models/attention.py``. Prefill (``pos is None``)
runs the flash-attention kernel through
:func:`repro_torch.kernels.ops.flash_attention_bshd`, where the reference
runs its online-softmax scan ``_chunked_causal`` (the kernel's oracle, the
same function): on a CUDA tensor the hand-written kernel, on the CPU its
plain version, which walks the reference scan's blocks (all query rows at
once, key chunks of ``min(chunk, T)``). Decode is a grouped product and a
softmax against the cache, in f32, in plain torch as in the reference.

The causal attention of train and prefill is a ``torch.autograd.Function``
(:class:`FlashCausal`): its forward is the kernel call, and its backward
recomputes the reference's online-softmax scan (:func:`chunked_causal`,
``repro/models/attention.py:_chunked_causal``) key chunk by key chunk in
plain torch and differentiates it, which is what XLA does with the
reference's checkpointed scan. The reference has no backward kernel, so
none is written here.

Query head ``h`` reads kv head ``h // G`` (``h = kv * G + g``), so
repeated keys and values are never materialized. No ``sharder`` argument:
the model's mesh path (DTensor) is ROADMAP A3.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import (ModelConfig, _init, apply_rope,
                                       matmul, rope_freqs)

NEG_INF = -1e30


def attn_params(cfg: ModelConfig, *, generator, device):
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    kw = dict(generator=generator, device=device)
    return {"wq": _init((d, H * hd), cfg.pdt, **kw),
            "wk": _init((d, KV * hd), cfg.pdt, **kw),
            "wv": _init((d, KV * hd), cfg.pdt, **kw),
            "wo": _init((H * hd, d), cfg.pdt, **kw)}


def chunked_causal(q, k, v, *, chunk):
    """The reference's online-softmax causal attention
    (``repro/models/attention.py:_chunked_causal``), op for op in plain
    torch: q [B, S, KV, G, hd], k/v [B, T, KV, hd], key chunks of
    ``min(chunk, T)``, f32 scores and state, the output in q's dtype."""
    B, S, KV, G, hd = q.shape
    T = k.shape[1]
    chunk = min(chunk, T)
    assert T % chunk == 0, (T, chunk)
    f32 = torch.float32
    qf = q.to(f32) * (hd ** -0.5)
    m = torch.full((B, S, KV, G), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((B, S, KV, G), dtype=f32, device=q.device)
    acc = torch.zeros((B, S, KV, G, hd), dtype=f32, device=q.device)
    qpos = torch.arange(S, device=q.device)
    for ci in range(T // chunk):
        k_c = k[:, ci * chunk:(ci + 1) * chunk].to(f32)
        v_c = v[:, ci * chunk:(ci + 1) * chunk].to(f32)
        s = torch.einsum("bskgh,bckh->bskgc", qf, k_c)
        kpos = ci * chunk + torch.arange(chunk, device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bskgc,bckh->bskgh", p,
                                                   v_c)
        m = m_new
    return (acc / torch.clamp_min(l[..., None], 1e-30)).to(q.dtype)


class FlashCausal(torch.autograd.Function):
    """Causal GQA attention, q [B, S, H, hd], k/v [B, T, KV, hd] ->
    [B, S, H, hd]. Forward: ``ops.flash_attention_bshd`` (the kernel on
    the card, its plain version on the CPU). Backward: the gradient of
    :func:`chunked_causal` on the saved inputs, recomputed chunk by
    chunk."""

    @staticmethod
    def forward(ctx, q, k, v, chunk):
        ctx.save_for_backward(q, k, v)
        ctx.chunk = chunk
        return ops.flash_attention_bshd(q, k, v, causal=True, bq=q.shape[1],
                                        bk=min(chunk, k.shape[1]))

    @staticmethod
    def backward(ctx, dout):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        B, S, H, hd = q.shape
        KV = k.shape[2]
        with torch.enable_grad():
            out = chunked_causal(q.reshape(B, S, KV, H // KV, hd), k, v,
                                 chunk=ctx.chunk)
            dq, dk, dv = torch.autograd.grad(
                out, (q, k, v), dout.reshape(out.shape))
        return dq, dk, dv, None


def _decode_attn(q, k_cache, v_cache, *, pos):
    """q: [B, 1, KV, G, hd]; caches: [B, Smax, KV, hd]; attends to <= pos
    (every later position is masked with -1e30), in f32."""
    hd = q.shape[-1]
    Smax = k_cache.shape[1]
    s = torch.einsum("bqkgh,btkh->bkgqt", q.float() * (hd ** -0.5),
                     k_cache.float())
    valid = torch.arange(Smax, device=q.device) <= pos
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqt,btkh->bqkgh", p, v_cache.float())
    return out.to(q.dtype)


def attention(x, p, cfg: ModelConfig, *, pos=None, cache=None, chunk=1024):
    """Self-attention. Modes:
      train/prefill : pos=None — full causal over x; returns (out, kv)
      decode        : pos = int position; cache = {'k', 'v'} [B, Smax, KV,
                      hd]. The new key and value are written into the
                      cache IN PLACE at ``pos`` (the reference returns
                      updated copies), and the same tensors are returned.
    """
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    G = H // KV
    q = matmul(x, p["wq"]).reshape(B, S, H, hd)
    k = matmul(x, p["wk"]).reshape(B, S, KV, hd)
    v = matmul(x, p["wv"]).reshape(B, S, KV, hd)

    if pos is None:
        positions = torch.arange(S, device=x.device)
    else:
        positions = torch.full((S,), int(pos), device=x.device)
    cos, sin = rope_freqs(positions, hd, cfg.rope_theta)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if pos is None:
        T = k.shape[1]
        blk = min(chunk, T)
        if T % blk:
            raise ValueError(f"attention: sequence {T} is no multiple of "
                             f"the chunk {blk}")
        out = FlashCausal.apply(q, k, v, blk)
        kv = {"k": k, "v": v}
    else:
        k_cache, v_cache = cache["k"], cache["v"]
        k_cache[:, pos:pos + S] = k.to(k_cache.dtype)
        v_cache[:, pos:pos + S] = v.to(v_cache.dtype)
        out = _decode_attn(q.reshape(B, S, KV, G, hd), k_cache, v_cache,
                           pos=pos)
        kv = {"k": k_cache, "v": v_cache}
    out = out.reshape(B, S, H * hd)
    return matmul(out, p["wo"]), kv


def init_kv_cache(cfg: ModelConfig, batch: int, length: int, dtype=None,
                  *, device="cuda"):
    dtype = dtype or cfg.adt
    shape = (batch, length, cfg.n_kv, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
