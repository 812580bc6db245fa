"""Mamba-2 (SSD) block for the Zamba-2 hybrid, in torch.

Counterpart of ``repro/models/mamba2.py``. State-space per head h with
head dim P and state dim N:
    S_t = a_t * S_{t-1} + dt_t * B_t x_t^T        (S: [N, P])
    y_t = C_t S_t + D x_t
with a_t = exp(-dt_t * exp(A_log_h)) a data-dependent scalar decay per
head. One in_proj gives (z, x, B, C, dt); x, B and C go through a
depthwise causal conv of width 4 and silu; a grouped RMSNorm over the
gated output comes before out_proj.

The recurrence is the reference's chunked scan, in f32 whatever the
inputs' dtype: within a chunk of Q = min(128, S) positions the quadratic
"attention form", across chunks the carried state, one chunk at a time
in a Python loop (the reference's ``lax.scan``; no kernel of the
repository runs here). A sequence longer than 128 must be a multiple of
128, as the reference asserts: no padding. Decode is the same scan at
S = 1.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, _init, matmul, rms_norm

EXPAND = 2
CHUNK = 128


def _dims(cfg: ModelConfig):
    """(d_inner, H, P, N)."""
    d_inner = EXPAND * cfg.d_model
    P = cfg.ssm_head_dim
    H = d_inner // P
    N = cfg.ssm_state
    return d_inner, H, P, N


def mamba_params(cfg: ModelConfig, *, generator, device):
    """One block's parameters, the reference's names and shapes:
    ``A_log`` and ``dt_bias`` [H] start at zero and ``D`` [H] at one, as
    there."""
    d = cfg.d_model
    d_inner, H, P, N = _dims(cfg)
    kw = dict(generator=generator, device=device)
    conv_dim = d_inner + 2 * N  # x, B, C go through the short conv

    def full(shape, value):
        return torch.full(shape, value, dtype=cfg.pdt, device=device)
    return {
        "ln": full((d,), 0.0),
        "w_in": _init((d, 2 * d_inner + 2 * N + H), cfg.pdt, **kw),
        "conv_w": _init((4, conv_dim), cfg.pdt, **kw),   # depthwise, k=4
        "A_log": full((H,), 0.0),
        "D": full((H,), 1.0),
        "dt_bias": full((H,), 0.0),
        "ssm_norm": full((d_inner,), 0.0),
        "w_out": _init((d_inner, d), cfg.pdt, **kw),
    }


def init_mamba_state(cfg: ModelConfig, batch: int, dtype=None, *,
                     device="cuda"):
    """``{"ssm": [B, H, N, P] f32, "conv": [B, 3, d_inner + 2 N]}`` of
    zeros, the conv carry in ``dtype`` (the activation dtype by
    default)."""
    dtype = dtype or cfg.adt
    d_inner, H, P, N = _dims(cfg)
    return {"ssm": torch.zeros((batch, H, N, P), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros((batch, 3, d_inner + 2 * N), dtype=dtype,
                                device=device)}


def _dw_conv(x, w, x_prev):
    """Depthwise causal conv, kernel 4. x: [B, S, C]; x_prev: [B, 3, C]
    carry. Returns (y, new carry): y_t = sum_i full[t + i] w[i] over
    full = [x_prev, x], the terms added in order of i."""
    full = torch.cat([x_prev.to(x.dtype), x], dim=1)     # [B, S+3, C]
    S = x.shape[1]
    y = full[:, 0:S, :] * w[0]
    for i in range(1, w.shape[0]):
        y = y + full[:, i:i + S, :] * w[i]
    return y, full[:, -3:, :]


def _ssd_chunk_scan(xh, bmat, cmat, dt, a, state0):
    """Chunked SSD recurrence, in f32.

    xh: [B, S, H, P] inputs; bmat/cmat: [B, S, N]; dt: [B, S, H] (> 0);
    a: [B, S, H] per-step decay in (0, 1]; state0: [B, H, N, P].
    Returns (y [B, S, H, P] in xh's dtype, state_S f32).

    Per chunk of Q positions (the reference's ``chunk``): log decays
    ``la = log(max(a, 1e-37))`` and their prefix sums ``cum``; the
    intra-chunk term ``y_t = sum_{u <= t} (C_t . B_u) exp(cum_t - cum_u)
    dt_u x_u`` (the upper triangle's exponents set to -inf, so exp gives
    its 0: the reference sets it to 0 after the exp, where
    ``cum_t - cum_u`` for u > t can overflow to inf, and its backward
    then takes 0 * inf = NaN; the values are the same); the carried
    state's ``C_t S exp(cum_t)``; the update ``S = exp(cum_Q) S +
    sum_u exp(cum_Q - cum_u) B_u^T dt_u x_u``. The [Q, Q] products run
    per (batch, head)."""
    B, S, H, P = xh.shape
    Q = min(CHUNK, S)
    if S % Q:
        raise ValueError(f"SSD: a sequence of {S} is longer than the chunk "
                         f"{CHUNK} and no multiple of it")
    f32 = torch.float32
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xh.device))
    state = state0.to(f32)
    ys = []
    for c0 in range(0, S, Q):
        sl = slice(c0, c0 + Q)
        b_c, c_c = bmat[:, sl].to(f32), cmat[:, sl].to(f32)    # [B, Q, N]
        dt_c, a_c = dt[:, sl], a[:, sl]                        # [B, Q, H]
        la = torch.log(torch.clamp_min(a_c, 1e-37))
        cum = torch.cumsum(la, dim=1).transpose(1, 2)          # [B, H, Q]
        seg = cum[:, :, :, None] - cum[:, :, None, :]          # [B, H, Q, Q]
        gamma = torch.exp(torch.where(tri, seg, -torch.inf))
        cb = c_c @ b_c.transpose(1, 2)                         # [B, Q, Q]
        mat = cb[:, None] * gamma
        xdt = (xh[:, sl].to(f32) * dt_c[..., None]).transpose(1, 2)
        y = mat @ xdt                                          # [B, H, Q, P]
        # the carried-in state's contribution
        decay_in = torch.exp(cum)
        y = y + (c_c[:, None] @ state) * decay_in[..., None]
        # the state update
        tot = cum[:, :, -1]                                    # [B, H]
        decay_out = torch.exp(tot[:, :, None] - cum)           # [B, H, Q]
        upd = b_c.transpose(1, 2)[:, None] @ (xdt * decay_out[..., None])
        state = torch.exp(tot)[:, :, None, None] * state + upd
        ys.append(y)
    y = torch.cat(ys, dim=2).transpose(1, 2)                   # [B, S, H, P]
    return y.to(xh.dtype), state


def mamba_block(x, p, cfg: ModelConfig, *, state=None):
    """Full Mamba-2 block with residual. state: ``{"ssm", "conv"}`` or
    None (zeros). Returns (y, new_state), the ssm state in the given
    state's dtype."""
    B, S, d = x.shape
    d_inner, H, P, N = _dims(cfg)
    if state is None:
        state = init_mamba_state(cfg, B, dtype=x.dtype, device=x.device)

    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    zxbcdt = matmul(xn, p["w_in"])
    z, xc, bmat, cmat, dt = torch.split(
        zxbcdt, [d_inner, d_inner, N, N, H], dim=-1)
    conv_in = torch.cat([xc, bmat, cmat], dim=-1)
    conv_out, conv_state = _dw_conv(conv_in, p["conv_w"].to(x.dtype),
                                    state["conv"])
    conv_out = F.silu(conv_out)
    xc, bmat, cmat = torch.split(conv_out, [d_inner, N, N], dim=-1)

    f32 = torch.float32
    dt = dt.to(f32) + p["dt_bias"].to(f32)
    dt = torch.logaddexp(dt, torch.zeros((), dtype=f32, device=x.device))
    a = torch.exp(-dt * torch.exp(p["A_log"].to(f32)))           # (0, 1]
    xh = xc.reshape(B, S, H, P)
    y, ssm_state = _ssd_chunk_scan(xh, bmat, cmat, dt, a, state["ssm"])
    y = y + p["D"].to(f32)[None, None, :, None] * xh.to(f32)
    y = y.to(x.dtype).reshape(B, S, d_inner)
    y = rms_norm(y * F.silu(z).to(y.dtype), p["ssm_norm"], cfg.norm_eps)
    out = matmul(y, p["w_out"])
    new_state = {"ssm": ssm_state.to(state["ssm"].dtype),
                 "conv": conv_state}
    return x + out, new_state
