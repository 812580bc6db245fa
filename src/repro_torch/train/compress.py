"""int8 error-feedback gradient all-reduce on ``torch.distributed``.

Counterpart of ``repro/train/compress.py``: the paper's per-tensor int8
quantizer (``core.quantize.quant_int8``) reused for data-parallel
training. Each rank adds its residual to its gradient, quantizes the sum
to int8 with one scale a leaf, keeps what int8 could not carry as its new
residual, and the dequantized values are averaged over the group
(``all_reduce`` of the sum, divided by the world size: the reference's
``lax.pmean`` inside ``shard_map``). Every rank calls it with its own
gradients and residuals, in the same order.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.quantize import dequant_int8, quant_int8
from repro_torch.optim.adamw import tree_map


def ef_allreduce_mean(grad, residual, group=None):
    """Compressed mean-all-reduce with error feedback. ``grad``,
    ``residual``: this rank's trees of f32 leaves (the same shapes).
    Returns ``(reduced_grad, new_residual)``."""
    world = dist.get_world_size(group)
    reduced, new_res = {}, {}

    def one(path, g, r):
        g32 = g.to(torch.float32) + r
        q, scale = quant_int8(g32)
        sent = dequant_int8(q, scale)
        new_res[path] = g32 - sent          # what int8 couldn't carry
        total = sent.clone()
        dist.all_reduce(total, group=group)
        reduced[path] = total / world
        return None

    tree_map(one, grad, residual)
    return (tree_map(lambda p, _: reduced[p], grad),
            tree_map(lambda p, _: new_res[p], grad))


def init_residual(params):
    return tree_map(lambda _, p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
