"""AdamW with a configurable state dtype, a cosine schedule and a global
gradient clip, in torch.

Counterpart of ``repro/optim/adamw.py``: the same config, schedule and
update, op for op in f32 (the moments stored in ``state_dtype``, f32 or
bf16; the parameters updated in their own dtype). Where the reference is
pure and returns new arrays, :func:`apply` writes the new parameters and
moments into the tensors it was given (and returns them): at gemma-2b's
width a second copy of the f32 moments would be 24 GB. The step count is a
host integer, so no step waits for the card.

Parameters, gradients and moments are nested dicts and lists of tensors
(the port's parameter layout); :func:`leaves` and :func:`tree_map` walk
them. The clip's scale is applied leaf by leaf inside the update, so that
no f32 copy of every gradient is held at once; the values are the
reference's.

Under a device mesh the parameters, gradients and moments are DTensors,
each gradient and moment placed as its parameter
(``train.make_train_step`` and :func:`init` see to it): the update runs
in place on each rank's local shards, and :func:`global_norm` is the
norm over the whole mesh (each rank's sums of squares, a shard counted
once, added by one all-reduce).
"""
from __future__ import annotations

import dataclasses
import math

import torch

_DT = {"f32": torch.float32, "bf16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    state_dtype: str = "f32"


# ---------------------------------------------------------------------------
# parameter trees (nested dicts and lists of tensors)
# ---------------------------------------------------------------------------
def leaves(tree, prefix: str = ""):
    """``[(path, tensor), ...]`` in a fixed order: dict keys as given, list
    items by index; a path joins the keys and indices with "/" (a layer's
    query projection is ``layers/<i>/attn/wq``). ``None`` leaves are
    skipped."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [] if tree is None else [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def tree_map(fn, tree, *rest, prefix: str = ""):
    """``tree`` with each leaf ``x`` (and the leaves ``r`` at the same
    place of ``rest``) replaced by ``fn(path, x, *r)``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest),
                            prefix=f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest),
                         prefix=f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return fn(prefix, tree, *rest)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------
def _f32(x, device):
    return torch.tensor(x, dtype=torch.float32, device=device)


def schedule(cfg: AdamWConfig, step, device="cpu"):
    """Learning rate at ``step`` (an int or an f32 tensor): linear warmup,
    then a cosine decay to ``min_lr_frac``; an f32 0-d tensor."""
    step = (step.to(torch.float32) if torch.is_tensor(step)
            else _f32(step, device))
    warm = torch.clamp_max(step / max(cfg.warmup, 1), 1.0)
    prog = torch.clamp((step - cfg.warmup)
                       / max(cfg.total_steps - cfg.warmup, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(_f32(math.pi, step.device) * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init(params, cfg: AdamWConfig):
    """Zero moments in ``state_dtype`` beside each parameter; count 0."""
    dt = _DT[cfg.state_dtype]

    def zeros(_, p):
        if _is_dtensor(p):
            return torch.zeros_like(p, dtype=dt)
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": 0}


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _local(x):
    """A DTensor's local shard (a tensor stays itself)."""
    return x.to_local() if _is_dtensor(x) else x


def global_norm(tree):
    """sqrt of the sum over leaves of their f32 squares (an f32 0-d
    tensor). With DTensor leaves: each rank adds the squares of its local
    shards, each placement's sum divided by its number of replicas (a
    power of two, so exactly), and one all-reduce over the mesh adds the
    ranks' sums; the result is a plain tensor, equal on every rank."""
    xs = [x for _, x in leaves(tree)]
    if not any(_is_dtensor(x) for x in xs):
        return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                              for x in xs))
    from torch.distributed.tensor import DTensor, Partial, Replicate
    groups: dict = {}
    mesh = None
    for x in xs:
        if not _is_dtensor(x):
            raise TypeError("global_norm: DTensor and plain leaves mixed")
        mesh = x.device_mesh
        groups.setdefault(tuple(x.placements), []).append(torch.sum(
            torch.square(x.to_local().to(torch.float32))))
    total = None
    for pl, sums in groups.items():
        reps = 1
        for i, q in enumerate(pl):
            if isinstance(q, Replicate):
                reps *= mesh.size(i)
        part = sum(sums) / reps
        total = part if total is None else total + part
    every = DTensor.from_local(total, mesh, [Partial()] * mesh.ndim,
                               run_check=False)
    return torch.sqrt(every.full_tensor())


def clip_by_global_norm(grads, max_norm):
    """``(grads scaled in f32 so their global norm is at most max_norm,
    the norm)``; :func:`apply` applies the same scale leaf by leaf."""
    scale, gnorm = _clip_scale(grads, max_norm)
    return tree_map(lambda _, g: g.to(torch.float32) * scale, grads), gnorm


def _clip_scale(grads, max_norm):
    gnorm = global_norm(grads)
    return torch.clamp_max(max_norm / torch.clamp_min(gnorm, 1e-12),
                           1.0), gnorm


@torch.no_grad()
def apply(grads, state, params, cfg: AdamWConfig):
    """Returns ``(params, state, metrics)`` with ``metrics = {"lr",
    "grad_norm"}``. Grads may be any float dtype; the math is f32; the
    parameters (in their own dtype) and the moments are updated IN PLACE
    and returned, the count advanced."""
    scale, gnorm = _clip_scale(grads, cfg.grad_clip)
    count = state["count"] + 1
    dev = gnorm.device
    lr = schedule(cfg, count, dev)
    c = _f32(count, dev)
    bc1 = 1 - torch.pow(_f32(cfg.b1, dev), c)
    bc2 = 1 - torch.pow(_f32(cfg.b2, dev), c)
    dt = _DT[cfg.state_dtype]

    def upd(_, p, g, m, v):
        if _is_dtensor(p):
            if not (tuple(g.placements) == tuple(m.placements)
                    == tuple(v.placements) == tuple(p.placements)):
                raise ValueError("adamw: a gradient or moment is placed "
                                 "unlike its parameter")
            p, g, m, v = (_local(t) for t in (p, g, m, v))
        g = g.to(torch.float32) * scale
        m32 = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * g * g
        step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        step = step + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * step).to(p.dtype))
        m.copy_(m32.to(dt))
        v.copy_(v32.to(dt))

    tree_map(upd, params, grads, state["m"], state["v"])
    state["count"] = count
    return params, state, {"lr": lr, "grad_norm": gnorm}
