"""Shared model machinery, in torch: config, norms, MLPs, RoPE, init.

Counterpart of ``repro/models/common.py``. The reference's ``Sharder`` /
``NO_SHARD`` (GSPMD sharding constraints under a mesh) are left out, and
so none of the functions here takes a ``sharder`` argument: their mesh
counterpart (model weights and activations as DTensors) is ROADMAP A12;
the distributed solver (A9, ``core/distributed.py``) shards no model.
``cross_entropy`` is the training loss (``transformer.loss_fn``).

Each function repeats the reference's casts in the reference's order:
``rms_norm`` takes its statistics in f32 and normalizes in ``x.dtype``,
``apply_rope`` rotates halves (not interleaved pairs) in f32, and the
gated MLPs cast the activation to the projection's dtype before the
product. ``jax.nn.gelu`` defaults to the tanh approximation, so every
GELU here is ``F.gelu(x, approximate="tanh")``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

DTYPES = {"f16": torch.float16, "bf16": torch.bfloat16,
          "f32": torch.float32}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One config covers every assigned architecture family."""
    name: str
    family: str                  # dense | moe | rwkv | hybrid | audio | vlm
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    n_heads: int = 0
    n_kv: int = 0
    head_dim: int = 0            # 0 -> d_model // n_heads
    mlp: str = "swiglu"          # swiglu | geglu | relu2 | gelu
    # --- MoE ---
    moe_experts: int = 0
    moe_topk: int = 0
    moe_shared: int = 0
    moe_dff: int = 0
    moe_capacity_factor: float = 1.25
    moe_first_dense: int = 0     # deepseek: first k layers stay dense
    # --- MLA (deepseek) ---
    mla: bool = False
    kv_lora: int = 0
    q_lora: int = 0
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128
    # --- SSM (rwkv6 / mamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    # --- hybrid (zamba2): one shared attention block every k ssm blocks ---
    attn_every: int = 0
    # --- modality stubs ---
    n_img_tokens: int = 0        # pixtral: positions fed by patch embeddings
    n_codebooks: int = 0         # musicgen: EnCodec streams
    # --- numerics / execution ---
    param_dtype: str = "f32"
    activ_dtype: str = "f32"
    remat: bool = True
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_seq: int = 8192          # KV-cache length for serving

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def adt(self) -> torch.dtype:
        return DTYPES[self.activ_dtype]

    @property
    def pdt(self) -> torch.dtype:
        return DTYPES[self.param_dtype]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------
def matmul(x, w):
    """``einsum("...d,df->...f", x, w)``: the operands promoted to one
    dtype as JAX promotes them (an f32 weight lifts a bf16 activation)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def rms_norm(x, gamma, eps):
    """RMSNorm with f32 statistics, normalized in ``x.dtype``:
    ``x * rsqrt(mean(x^2) + eps) * (1 + gamma)``."""
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * (1.0 + gamma.to(x.dtype))


def rope_freqs(positions, dim, theta):
    """positions: [...] int -> (cos, sin) of shape [..., dim // 2], f32."""
    ar = torch.arange(0, dim, 2, dtype=torch.float32,
                      device=positions.device)
    inv = 1.0 / (theta ** (ar / dim))
    ang = positions[..., None].to(torch.float32) * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: [..., dim]; cos/sin broadcastable to [..., dim // 2]. Rotates the
    two halves of the head dim (the reference's layout), in f32."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def mlp_apply(x, w_in, w_gate, w_out, kind: str):
    """Gated / plain MLP. w_gate is None for non-gated kinds."""
    h = matmul(x, w_in)
    if kind in ("swiglu", "geglu"):
        g = matmul(x, w_gate)
        act = F.silu(g) if kind == "swiglu" else _gelu(g)
        h = act.to(h.dtype) * h
    elif kind == "relu2":       # nemotron squared-ReLU
        h = torch.square(torch.relu(h))
    elif kind == "gelu":
        h = _gelu(h)
    else:
        raise ValueError(kind)
    return matmul(h, w_out)


def _init(shape, dtype, *, generator, device, scale=None):
    """``N(0, 1) * fan_in ** -0.5`` drawn in f32 from ``generator`` (on
    ``device``) and cast to ``dtype``."""
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


init_dense = _init


def cross_entropy(logits, labels, *, z_loss=1e-4):
    """Standard LM loss with z-regularization, in f32; labels -100 are
    masked: ``sum((lse - logit[label] + z_loss lse^2) mask) /
    max(sum(mask), 1)``."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    mask = labels >= 0
    safe = labels.clamp_min(0)
    ll = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (lse - ll) + z_loss * torch.square(lse)
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1)


def mlp_params(d, f, kind, dtype, *, generator, device):
    p = {"w_in": _init((d, f), dtype, generator=generator, device=device),
         "w_out": _init((f, d), dtype, generator=generator, device=device)}
    if kind in ("swiglu", "geglu"):
        p["w_gate"] = _init((d, f), dtype, generator=generator,
                            device=device)
    return p
