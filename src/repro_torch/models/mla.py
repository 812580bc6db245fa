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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.attention import NEG_INF, FlashCausal
from repro_torch.models.common import (ModelConfig, _init, apply_rope,
                                       matmul, rms_norm, rope_freqs)


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


def mla_attention(x, p, cfg: ModelConfig, *, pos=None, cache=None,
                  chunk=1024):
    """Modes as ``attention.attention``: prefill/train (``pos=None``)
    returns (out, {"c", "kr"} of length S); decode writes position ``pos``
    of ``cache`` in place and returns the same tensors."""
    B, S, _ = x.shape
    H = cfg.n_heads
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    q_nope, q_rope = _queries(x, p, cfg)
    c_kv = rms_norm(matmul(x, p["w_dkv"]), p["kv_norm"], cfg.norm_eps)
    k_rope = matmul(x, p["w_kr"])                                # [B,S,dr]

    if pos is None:
        positions = torch.arange(S, device=x.device)
    else:
        positions = torch.full((S,), int(pos), device=x.device)
    cos, sin = rope_freqs(positions, dr, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos[None, :, None, :], sin[None, :, None, :])
    k_rope = apply_rope(k_rope, cos[None], sin[None])

    if pos is None:
        blk = min(chunk, S)
        if S % blk:
            raise ValueError(f"mla_attention: sequence {S} is no multiple "
                             f"of the chunk {blk}")
        k_nope = matmul(c_kv, p["w_uk"]).reshape(B, S, H, dn)
        v = matmul(c_kv, p["w_uv"]).reshape(B, S, H, dv)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, dr)],
                      dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        vp = F.pad(v, (0, dn + dr - dv))
        out = FlashCausal.apply(q, k, vp, blk)[..., :dv]
        new_cache = {"c": c_kv, "kr": k_rope}
    else:
        c_cache, kr_cache = cache["c"], cache["kr"]
        c_cache[:, pos:pos + S] = c_kv.to(c_cache.dtype)
        kr_cache[:, pos:pos + S] = k_rope.to(kr_cache.dtype)
        f32 = torch.float32
        w_uk = p["w_uk"].reshape(cfg.kv_lora, H, dn).to(f32)
        q_abs = torch.einsum("bshn,rhn->bshr", q_nope.to(f32), w_uk)
        c32 = c_cache.to(f32)
        s = (torch.einsum("bshr,btr->bhst", q_abs, c32)
             + torch.einsum("bshr,btr->bhst", q_rope.to(f32),
                            kr_cache.to(f32)))
        s = s * ((dn + dr) ** -0.5)
        valid = torch.arange(c_cache.shape[1], device=x.device) <= pos
        s = torch.where(valid, s, NEG_INF)
        o_lat = torch.einsum("bhst,btr->bshr", torch.softmax(s, dim=-1),
                             c32)                               # [B,1,H,R]
        w_uv = p["w_uv"].reshape(cfg.kv_lora, H, dv).to(f32)
        out = torch.einsum("bshr,rhv->bshv", o_lat, w_uv).to(x.dtype)
        new_cache = {"c": c_cache, "kr": kr_cache}
    out = out.reshape(B, S, H * dv)
    return matmul(out, p["wo"]), new_cache


def init_mla_cache(cfg: ModelConfig, batch: int, length: int, dtype=None,
                   *, device="cuda"):
    dtype = dtype or cfg.adt
    return {"c": torch.zeros((batch, length, cfg.kv_lora), dtype=dtype,
                             device=device),
            "kr": torch.zeros((batch, length, cfg.rope_head_dim),
                              dtype=dtype, device=device)}
