"""Multi-head Latent Attention (DeepSeek V2/V3), in torch.

Counterpart of ``repro/models/mla.py``. Queries (optionally LoRA-
compressed), a shared compressed KV latent of width ``kv_lora`` and a
decoupled RoPE key of width ``rope_head_dim``. The serving cache holds
only the latent and the rope key, ``{"c": [B, S, kv_lora], "kr": [B, S,
rope_head_dim]}``.

Prefill (``pos is None``) decompresses per-head keys and values, appends
the broadcast rope key to each head's key, pads v to the key's head dim
``dn + dr`` and runs the flash-attention kernel (:class:`FlashCausal`,
the reference's ``_chunked_causal``) with ``H = KV``, then trims the
output to ``dv``. q, k and v are fresh contiguous tensors, as the
tensor-core kernel's TMA maps need. Decode is the absorbed form (q
through ``W_uk``, the output through ``W_uv``) in f32 plain torch, the
new latent and rope key written into the cache IN PLACE at ``pos``.

Under a mesh the projections are DTensor products, ``q_nope`` goes
through ``act_heads``, and RoPE, the kernel and the absorbed decode run
on each rank's shard: its batch, and its heads where ``n_heads`` divides
``model`` (replicated otherwise). The latent and the rope key are
replicated over ``model`` there; a decode writes them into the rank's
shard of the cache (``cache_spec``: the latent and rope dims over
``model``) and attends to the layer's cache gathered over ``model``.
``W_uk``/``W_uv`` come to the decode boundary as the rank's heads.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.attention import (NEG_INF, FlashCausal,
                                          cache_layer_spec, rope_positions)
from repro_torch.models.common import (NO_SHARD, ModelConfig, Sharder,
                                       _init, apply_rope, matmul, rms_norm,
                                       rope_freqs)


def mla_params(cfg: ModelConfig, *, generator, device):
    d, H = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    kw = dict(generator=generator, device=device)
    p = {"w_dkv": _init((d, cfg.kv_lora), cfg.pdt, **kw),
         "kv_norm": torch.zeros((cfg.kv_lora,), dtype=cfg.pdt,
                                device=device),
         "w_uk": _init((cfg.kv_lora, H * dn), cfg.pdt, **kw),
         "w_uv": _init((cfg.kv_lora, H * dv), cfg.pdt, **kw),
         "w_kr": _init((d, dr), cfg.pdt, **kw),
         "wo": _init((H * dv, d), cfg.pdt, **kw)}
    if cfg.q_lora:
        p["w_dq"] = _init((d, cfg.q_lora), cfg.pdt, **kw)
        p["q_norm"] = torch.zeros((cfg.q_lora,), dtype=cfg.pdt,
                                  device=device)
        p["w_uq"] = _init((cfg.q_lora, H * (dn + dr)), cfg.pdt, **kw)
    else:
        p["wq"] = _init((d, H * (dn + dr)), cfg.pdt, **kw)
    return p


def _queries(x, p, cfg: ModelConfig):
    """(q_nope [B, S, H, dn], q_rope [B, S, H, dr])."""
    B, S, _ = x.shape
    H, dn, dr = cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim
    if cfg.q_lora:
        cq = rms_norm(matmul(x, p["w_dq"]), p["q_norm"], cfg.norm_eps)
        q = matmul(cq, p["w_uq"])
    else:
        q = matmul(x, p["wq"])
    q = q.reshape(B, S, H, dn + dr)
    return q[..., :dn], q[..., dn:]


def mla_attention(x, p, cfg: ModelConfig, sharder: Sharder = NO_SHARD, *,
                  pos=None, cache=None, chunk=1024):
    """Modes as ``attention.attention``: prefill/train (``pos=None``)
    returns (out, {"c", "kr"} of length S); decode writes position ``pos``
    of ``cache`` in place and returns the same tensors."""
    B, S, _ = x.shape
    H = cfg.n_heads
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    q_nope, q_rope = _queries(x, p, cfg)
    q_nope = sharder.act_heads(q_nope)
    c_kv = rms_norm(matmul(x, p["w_dkv"]), p["kv_norm"], cfg.norm_eps)
    k_rope = matmul(x, p["w_kr"])                                # [B,S,dr]
    b, m = sharder.b, sharder.model_axis
    h_spec = (b, None, m if sharder._fits(H) else None, None)
    r_spec = (b, None, None)
    if pos is None:
        k_nope = matmul(c_kv, p["w_uk"]).reshape(B, S, H, dn)
        v = matmul(c_kv, p["w_uv"]).reshape(B, S, H, dv)
        out, kr = _prefill_local(
            *(sharder.local(t, h_spec) for t in (q_nope, q_rope, k_nope, v)),
            sharder.local(k_rope, r_spec), cfg, chunk=chunk)
        out = sharder.wrap(out, h_spec)
        new_cache = {"c": c_kv, "kr": sharder.wrap(kr, r_spec)}
    else:
        positions = rope_positions(S, pos, x.device)
        kr = _rope(sharder.local(k_rope, r_spec), positions, cfg, False)
        new = {"c": c_kv, "kr": sharder.wrap(kr, r_spec)}
        for name in ("c", "kr"):
            spec = cache_layer_spec(name, cache[name], sharder)
            dst = cache[name].to_local() if sharder.enabled else cache[name]
            dst[:, pos:pos + S] = sharder.local(new[name], spec).to(dst.dtype)
        w_spec = (None, m if sharder._fits(H) else None)
        out = sharder.wrap(_decode_local(
            sharder.local(q_nope, h_spec),
            _rope(sharder.local(q_rope, h_spec), positions, cfg, True),
            sharder.local(cache["c"], r_spec),
            sharder.local(cache["kr"], r_spec),
            sharder.local(p["w_uk"], w_spec),
            sharder.local(p["w_uv"], w_spec), cfg, pos=pos), h_spec)
        new_cache = cache
    out = out.reshape(B, S, H * dv)
    return matmul(out, p["wo"]), new_cache


def _rope(t, positions, cfg: ModelConfig, heads: bool):
    cos, sin = rope_freqs(positions, cfg.rope_head_dim, cfg.rope_theta)
    if heads:
        return apply_rope(t, cos[None, :, None, :], sin[None, :, None, :])
    return apply_rope(t, cos[None], sin[None])


def _prefill_local(q_nope, q_rope, k_nope, v, k_rope, cfg: ModelConfig, *,
                   chunk):
    """The prefill on one device's tensors: RoPE, the per-head keys and
    the padded values, the kernel. Returns (out [B, S, H', dv], the
    roped k_rope)."""
    B, S, Hl, dn = q_nope.shape
    dr, dv = cfg.rope_head_dim, cfg.v_head_dim
    positions = rope_positions(S, None, q_nope.device)
    q_rope = _rope(q_rope, positions, cfg, True)
    k_rope = _rope(k_rope, positions, cfg, False)
    blk = min(chunk, S)
    if S % blk:
        raise ValueError(f"mla_attention: sequence {S} is no multiple "
                         f"of the chunk {blk}")
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, Hl, dr)],
                  dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    vp = F.pad(v, (0, dn + dr - dv))
    return FlashCausal.apply(q, k, vp, blk)[..., :dv], k_rope


def _decode_local(q_nope, q_rope, c_cache, kr_cache, w_uk, w_uv,
                  cfg: ModelConfig, *, pos):
    """The absorbed decode on one device's tensors: q_nope and the roped
    q_rope [B, 1, H', .] against the whole latent and rope-key caches;
    ``w_uk``/``w_uv`` hold the device's heads."""
    B, S, Hl, dn = q_nope.shape
    dr, dv = cfg.rope_head_dim, cfg.v_head_dim
    R = w_uk.shape[0]
    f32 = torch.float32
    w_uk = w_uk.reshape(R, Hl, dn).to(f32)
    q_abs = torch.einsum("bshn,rhn->bshr", q_nope.to(f32), w_uk)
    c32 = c_cache.to(f32)
    s = (torch.einsum("bshr,btr->bhst", q_abs, c32)
         + torch.einsum("bshr,btr->bhst", q_rope.to(f32),
                        kr_cache.to(f32)))
    s = s * ((dn + dr) ** -0.5)
    valid = torch.arange(c_cache.shape[1], device=q_nope.device) <= pos
    s = torch.where(valid, s, NEG_INF)
    o_lat = torch.einsum("bhst,btr->bshr", torch.softmax(s, dim=-1),
                         c32)                                   # [B,1,H,R]
    w_uv = w_uv.reshape(R, Hl, dv).to(f32)
    return torch.einsum("bshr,rhv->bshv", o_lat, w_uv).to(q_nope.dtype)


def init_mla_cache(cfg: ModelConfig, batch: int, length: int, dtype=None,
                   *, device="cuda"):
    dtype = dtype or cfg.adt
    return {"c": torch.zeros((batch, length, cfg.kv_lora), dtype=dtype,
                             device=device),
            "kr": torch.zeros((batch, length, cfg.rope_head_dim),
                              dtype=dtype, device=device)}
