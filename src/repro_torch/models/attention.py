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
repeated keys and values are never materialized on one device.

Under a mesh (a :class:`~repro_torch.models.common.Sharder`) the
projections are DTensor products and ``q`` goes through ``act_heads``;
RoPE, the kernel and the cache run on each rank's shard
(:func:`_attention_sharded`), which holds whole heads: the batch over the batch axes,
the query heads over ``model`` where they divide it, else replicated.
Keys and values shard their heads with the queries where the KV heads
divide ``model`` (each rank's query heads then read its own KV heads);
otherwise they are replicated over ``model`` (gemma-2b's one KV head,
whose ``wk``/``wv`` shard the head dim: the boundary gathers it) and a
rank whose query heads are a slice takes each one's KV head
(``h // G``), as multi-head attention. A decode writes the new key and
value into the rank's shard of the cache (placed by
``launch.sharding.cache_spec``: KV heads, else head dim, over ``model``)
and, where the cache does not shard whole heads, attends to the layer's
cache gathered over ``model``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import (NO_SHARD, ModelConfig, Sharder,
                                       _init, apply_rope, matmul,
                                       rope_freqs)

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


def rope_positions(S, pos, device):
    """The positions a call rotates: 0..S-1, or ``pos`` in decode."""
    if pos is None:
        return torch.arange(S, device=device)
    return torch.full((S,), int(pos), device=device)


def _rope_qk(q, k, cfg: ModelConfig, pos):
    """q [B, S, H, hd] and k [B, S, KV, hd] rotated at their positions."""
    cos, sin = rope_freqs(rope_positions(q.shape[1], pos, q.device),
                          q.shape[-1], cfg.rope_theta)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin)


def _prefill_core(q, k, v, *, chunk, kv_heads):
    """Causal attention of one device's q [B, S, Hq, hd] over k/v [B, T,
    KV', hd] (the kernel). ``kv_heads`` (a LongTensor of Hq entries, or
    None) picks each query head's KV head where q holds a slice of the
    heads and k/v all of them."""
    T = k.shape[1]
    blk = min(chunk, T)
    if T % blk:
        raise ValueError(f"attention: sequence {T} is no multiple of "
                         f"the chunk {blk}")
    if kv_heads is not None:
        k = k[:, :, kv_heads].contiguous()
        v = v[:, :, kv_heads].contiguous()
    return FlashCausal.apply(q, k, v, blk)


def _decode_core(q, k_cache, v_cache, *, pos, kv_heads):
    """:func:`_decode_attn` of q [B, S, Hq, hd] -> [B, S, Hq, hd];
    ``kv_heads`` as in :func:`_prefill_core`."""
    B, S, Hq, hd = q.shape
    if kv_heads is not None:
        k_cache, v_cache = k_cache[:, :, kv_heads], v_cache[:, :, kv_heads]
    KV = k_cache.shape[2]
    return _decode_attn(q.reshape(B, S, KV, Hq // KV, hd), k_cache,
                        v_cache, pos=pos).reshape(B, S, Hq, hd)


def attention(x, p, cfg: ModelConfig, sharder: Sharder = NO_SHARD, *,
              pos=None, cache=None, chunk=1024):
    """Self-attention. Modes:
      train/prefill : pos=None — full causal over x; returns (out, kv)
      decode        : pos = int position; cache = {'k', 'v'} [B, Smax, KV,
                      hd]. The new key and value are written into the
                      cache IN PLACE at ``pos`` (the reference returns
                      updated copies), and the same tensors are returned.
    """
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    q = sharder.act_heads(matmul(x, p["wq"]).reshape(B, S, H, hd))
    k = matmul(x, p["wk"]).reshape(B, S, KV, hd)
    v = matmul(x, p["wv"]).reshape(B, S, KV, hd)
    if sharder.enabled:
        out, kv = _attention_sharded(q, k, v, cfg, sharder, pos=pos,
                                     cache=cache, chunk=chunk)
    else:
        q, k = _rope_qk(q, k, cfg, pos)
        if pos is None:
            out = _prefill_core(q, k, v, chunk=chunk, kv_heads=None)
            kv = {"k": k, "v": v}
        else:
            kv = cache
            kv["k"][:, pos:pos + S] = k.to(kv["k"].dtype)
            kv["v"][:, pos:pos + S] = v.to(kv["v"].dtype)
            out = _decode_core(q, kv["k"], kv["v"], pos=pos, kv_heads=None)
    return matmul(out.reshape(B, S, H * hd), p["wo"]), kv


def _attention_sharded(q, k, v, cfg: ModelConfig, sharder: Sharder, *,
                       pos, cache, chunk):
    """RoPE and the attention on each rank's whole heads (module
    docstring); returns (out [B, S, H, hd], kv) as DTensors."""
    H, KV = cfg.n_heads, cfg.n_kv
    m, b = sharder.model_axis, sharder.b
    q_heads = sharder._fits(H)
    kv_shard = q_heads and sharder._fits(KV)
    q_spec = (b, None, m if q_heads else None, None)
    kv_spec = (b, None, m if kv_shard else None, None)
    ql = sharder.local(q, q_spec)
    kl, vl = sharder.local(k, kv_spec), sharder.local(v, kv_spec)
    kv_heads = None
    if q_heads and not kv_shard:
        h0 = sharder.rank(m) * ql.shape[2]
        kv_heads = torch.div(torch.arange(h0, h0 + ql.shape[2],
                                          device=ql.device), H // KV,
                             rounding_mode="floor")
    ql, kl = _rope_qk(ql, kl, cfg, pos)
    if pos is None:
        out = _prefill_core(ql, kl, vl, chunk=chunk, kv_heads=kv_heads)
        kv = {"k": sharder.wrap(kl, kv_spec), "v": sharder.wrap(vl, kv_spec)}
        return sharder.wrap(out, q_spec), kv
    # decode: the new key and value go into this rank's cache shard
    c_spec = cache_layer_spec("k", cache["k"], sharder)
    S = ql.shape[1]
    for name, new in (("k", kl), ("v", vl)):
        dst = cache[name].to_local()
        dst[:, pos:pos + S] = sharder.local(sharder.wrap(new, kv_spec),
                                            c_spec).to(dst.dtype)
    kc, vc = (cache[n].to_local() if c_spec == kv_spec
              else sharder.local(cache[n], kv_spec) for n in ("k", "v"))
    out = _decode_core(ql, kc, vc, pos=pos, kv_heads=kv_heads)
    return sharder.wrap(out, q_spec), cache


def cache_layer_spec(key: str, leaf, sharder: Sharder) -> tuple:
    """The spec of one layer's view of a cache leaf: ``cache_spec`` of
    the stacked leaf, without its layers entry (None without a mesh)."""
    if not sharder.enabled:
        return None
    from repro_torch.launch.sharding import cache_spec
    return cache_spec(key, (1,) + tuple(leaf.shape), None, sharder,
                      sharder.mesh)[1:]


def init_kv_cache(cfg: ModelConfig, batch: int, length: int, dtype=None,
                  *, device="cuda"):
    dtype = dtype or cfg.adt
    shape = (batch, length, cfg.n_kv, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
