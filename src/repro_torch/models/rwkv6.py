"""RWKV-6 "Finch" block, in torch (attention-free, data-dependent decay).

Counterpart of ``repro/models/rwkv6.py``. Time mixing per head (head dim
N):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t          (state: N x N per head)
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
with w_t = exp(-exp(w0 + (x~_t A) B)) a data-dependent per-channel decay
computed in f32 and cast to the activation dtype, token-shift
interpolation on every projection input, and a gated output. Channel
mixing is RWKV's squared-ReLU FFN.

The recurrence is the reference's per-step scan, one step per position in
a Python loop, in the activation dtype: ``o = r S + (sum r u k) v``, then
``S = w S + k^T v``, so a bf16 state is rounded at every step as the
reference rounds it (a chunked "parallel" form would be another
function). As the reference's two-level scan does, the steps run in
chunks of ``TIME_CHUNK`` and, when a gradient is to be taken, each chunk
runs under ``torch.utils.checkpoint`` (non-reentrant): the backward pass
keeps S / TIME_CHUNK states instead of one [B, H, N, N] state a step and
recomputes a chunk's steps from its first state. That has no effect on
the values. No kernel of the repository runs here: the reference's scan
is ``lax.scan``, not Pallas.

Prefill carries the state across the prompt; decode is one step against
the caller's state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import ModelConfig, _init, matmul, rms_norm

LORA_R = 64
TIME_CHUNK = 128


def rwkv_params(cfg: ModelConfig, *, generator, device):
    """One block's parameters, the reference's names and shapes: ``mu``
    [5, d] (the token-shift mix of r, k, v, w, g), ``w0`` [d], ``u``
    [H, N], ``ln_x`` [d] and ``mu_c`` [2, d] start at zero, as there."""
    d = cfg.d_model
    N = cfg.ssm_head_dim
    H = d // N
    kw = dict(generator=generator, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=cfg.pdt, device=device)
    return {
        "mu": zeros(5, d),
        "wr": _init((d, d), cfg.pdt, **kw),
        "wk": _init((d, d), cfg.pdt, **kw),
        "wv": _init((d, d), cfg.pdt, **kw),
        "wg": _init((d, d), cfg.pdt, **kw),
        "wo": _init((d, d), cfg.pdt, **kw),
        "w0": zeros(d),
        "w_lora_a": _init((d, LORA_R), cfg.pdt, **kw),
        "w_lora_b": _init((LORA_R, d), cfg.pdt, scale=0.01, **kw),
        "u": zeros(H, N),
        "ln_x": zeros(d),
        "mu_c": zeros(2, d),
        "ck": _init((d, cfg.d_ff), cfg.pdt, **kw),
        "cv": _init((cfg.d_ff, d), cfg.pdt, **kw),
        "cr": _init((d, d), cfg.pdt, **kw),
        "ln1": zeros(d),
        "ln2": zeros(d),
    }


def init_rwkv_state(cfg: ModelConfig, batch: int, dtype=None, *,
                    device="cuda"):
    """``{"s": [B, H, N, N], "x_tm": [B, d], "x_cm": [B, d]}`` of zeros in
    ``dtype`` (the activation dtype by default)."""
    dtype = dtype or cfg.adt
    N = cfg.ssm_head_dim
    H = cfg.d_model // N
    kw = dict(dtype=dtype, device=device)
    return {"s": torch.zeros((batch, H, N, N), **kw),
            "x_tm": torch.zeros((batch, cfg.d_model), **kw),
            "x_cm": torch.zeros((batch, cfg.d_model), **kw)}


def _shift_mix(x, x_prev, mu):
    """Token shift: lerp(x_t, x_{t-1}, mu). x: [B, S, D]; x_prev: [B, D],
    the position before x's first."""
    shifted = torch.cat([x_prev[:, None, :].to(x.dtype), x[:, :-1, :]],
                        dim=1)
    return x + (shifted - x) * mu


def _scan_chunk(r, k, v, w, bonus, s):
    """Consecutive steps of the recurrence from state ``s``; the inputs
    time-major [ck, B, H, N]. Returns (out [ck, B, H, N], last state)."""
    outs = []
    for t in range(r.shape[0]):
        outs.append((r[t][..., None, :] @ s)[..., 0, :] + bonus[t])
        s = w[t][..., :, None] * s + k[t][..., :, None] * v[t][..., None, :]
    return torch.stack(outs), s


def _time_mix_scan(r, k, v, w, u, state0):
    """r/k/v: [B, S, H, N]; w: [B, S, H, N] decay in (0, 1); u: [H, N];
    state0: [B, H, N, N]. Returns (out [B, S, H, N], state_S).

    Step t: ``o_t = r_t S + (sum_n r_t u k_t) v_t`` and ``S = w_t S +
    k_t^T v_t``, each product and sum rounded to its operands' dtype as
    the reference's step rounds it. The bonus ``(sum r u k) v`` does not
    depend on S and is taken for every position at once. The steps run in
    chunks of ``TIME_CHUNK`` (of 1 where S is no multiple of
    ``min(TIME_CHUNK, S)``, as in the reference), each checkpointed when
    a gradient is to be taken."""
    bonus = torch.sum(r * u * k, dim=-1, keepdim=True) * v
    # time-major, so that each step's slices are contiguous
    r, k, v, w, bonus = (t.transpose(0, 1).contiguous()
                         for t in (r, k, v, w, bonus))
    S = r.shape[0]
    ck = min(TIME_CHUNK, S)
    if S % ck:
        ck = 1
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (r, k, v, w, bonus, state0))
    s = state0
    outs = []
    for c in range(0, S, ck):
        args = (r[c:c + ck], k[c:c + ck], v[c:c + ck], w[c:c + ck],
                bonus[c:c + ck], s)
        if remat:
            o, s = checkpoint(_scan_chunk, *args, use_reentrant=False)
        else:
            o, s = _scan_chunk(*args)
        outs.append(o)
    return torch.cat(outs).transpose(0, 1), s


def rwkv_block(x, p, cfg: ModelConfig, *, state=None):
    """One full RWKV block (time mix + channel mix).

    state: ``{"s", "x_tm", "x_cm"}`` or None (zeros). Returns (y,
    new_state); new_state's ``x_tm`` / ``x_cm`` are the last position's
    normalized inputs of the two mixes."""
    B, S, d = x.shape
    N = cfg.ssm_head_dim
    H = d // N
    if state is None:
        state = init_rwkv_state(cfg, B, dtype=x.dtype, device=x.device)

    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    mu = p["mu"].to(x.dtype)
    xr, xk, xv, xw, xg = (_shift_mix(xn, state["x_tm"], mu[i])
                          for i in range(5))
    r = matmul(xr, p["wr"]).reshape(B, S, H, N)
    k = matmul(xk, p["wk"]).reshape(B, S, H, N)
    v = matmul(xv, p["wv"]).reshape(B, S, H, N)
    g = F.silu(matmul(xg, p["wg"]))

    f32 = torch.float32
    dec = p["w0"].to(f32) + (xw.to(f32) @ p["w_lora_a"].to(f32)) \
        @ p["w_lora_b"].to(f32)
    w = torch.exp(-torch.exp(dec)).reshape(B, S, H, N).to(x.dtype)

    out, s_new = _time_mix_scan(r, k, v, w, p["u"].to(x.dtype), state["s"])
    out = rms_norm(out.reshape(B, S, d), p["ln_x"], cfg.norm_eps)
    out = matmul(out * g.to(out.dtype), p["wo"])
    y = x + out

    # channel mixing
    yn = rms_norm(y, p["ln2"], cfg.norm_eps)
    mu_c = p["mu_c"].to(x.dtype)
    xck = _shift_mix(yn, state["x_cm"], mu_c[0])
    xcr = _shift_mix(yn, state["x_cm"], mu_c[1])
    kk = torch.square(torch.relu(matmul(xck, p["ck"])))
    cm = torch.sigmoid(matmul(xcr, p["cr"])) * matmul(kk, p["cv"]).to(x.dtype)
    y = y + cm.to(y.dtype)

    new_state = {"s": s_new, "x_tm": xn[:, -1, :], "x_cm": yn[:, -1, :]}
    return y, new_state
