"""Per-block quantization / dequantization (paper §III-D), in torch.

Counterpart of ``repro/core/quantize.py``, op for op, so that each result
is bitwise equal to the reference's: the same f32 absmax, the same IEEE
division by the scale, and ``torch.round``, which rounds half to even as
``jnp.round`` does. Before a low-precision GEMM the operand block is
rescaled by

    alpha = max(1, ||B||_inf / R_max)

so every value fits the narrow format's range (int8 always scales by
``absmax / 127``). For bf16/f32 levels the scale is 1.
"""
from __future__ import annotations

import torch

from repro_torch.core.precision import DTYPES, NARROW, RMAX


def _absmax_f32(x):
    return x.abs().max().to(torch.float32)


def quant_block(x, level_name: str, enable: bool = True):
    """Cast ``x`` to the level's dtype with range-safe scaling.

    Returns ``(x_q, alpha)`` with ``x ~= x_q.float() * alpha``; ``alpha``
    is an f32 0-d tensor on ``x``'s device (1.0 when no rescale applies).
    """
    dtype = DTYPES[level_name]
    one = torch.ones((), dtype=torch.float32, device=x.device)
    if level_name == "int8":
        alpha = torch.clamp_min(_absmax_f32(x), 1e-30) / 127.0
        q = torch.clamp(torch.round(x.to(torch.float32) / alpha), -127, 127)
        return q.to(dtype), alpha
    if not enable or level_name not in NARROW:
        return x.to(dtype), one
    alpha = torch.maximum(one, _absmax_f32(x) / RMAX[level_name])
    return (x / alpha.to(x.dtype)).to(dtype), alpha


def dequant(x, alpha):
    return x.to(torch.float32) * alpha


def storage_round(x, level_name: str, quantize: bool = True):
    """Round ``x``'s values to ``level_name``'s grid, keep its dtype.

    Narrow formats round scaled (``q * alpha``), so storage never
    overflows unless ``quantize`` is off (the paper's overflow ablation).
    """
    dt = DTYPES[level_name]
    if dt == x.dtype:
        return x
    if level_name == "int8" or (level_name in NARROW and quantize):
        xq, alpha = quant_block(x, level_name, True)
        return xq.to(x.dtype) * alpha.to(x.dtype)
    return x.to(dt).to(x.dtype)


def quant_int8(x):
    """Symmetric int8 quantization with a per-tensor scale.
    Returns ``(q, scale)`` with ``x ~= q * scale``."""
    scale = torch.clamp_min(_absmax_f32(x), 1e-30) / 127.0
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127)
    return q.to(torch.int8), scale


def dequant_int8(q, scale, dtype=torch.float32):
    return (q.to(torch.float32) * scale).to(dtype)
