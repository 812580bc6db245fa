"""Train step factory: microbatched gradient accumulation, AdamW or
TreeNewton (the paper's solver as an optimizer), metrics; in torch.

Counterpart of ``repro/train/step.py``. The step runs eagerly:

    state, metrics = step_fn(state, batch)

``batch`` holds ``tokens`` and ``labels`` [B, S], or [accum, B/accum, S]
when ``accum > 1`` (:func:`reshape_for_accum`). The gradients come from
``torch.autograd.grad`` of ``transformer.loss_fn``; with ``accum > 1``
the microbatches' gradients are summed in f32 in microbatch order, as the
reference's ``lax.scan`` sums them, then scaled by ``1 / accum``. The
optimizer updates the parameters and its state in place (``optim``), and
``state["step"]`` is a host integer.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig
from repro_torch.optim import adamw, kfac


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"             # adamw | tree_newton
    adam: adamw.AdamWConfig = dataclasses.field(
        default_factory=adamw.AdamWConfig)
    tree_newton: kfac.TreeNewtonConfig = dataclasses.field(
        default_factory=kfac.TreeNewtonConfig)
    accum: int = 1


def init_opt(params, tcfg: TrainConfig):
    """The optimizer state of ``tcfg.optimizer`` for ``params``."""
    if tcfg.optimizer == "tree_newton":
        return kfac.init(params, tcfg.tree_newton)
    if tcfg.optimizer != "adamw":
        raise ValueError(f"optimizer {tcfg.optimizer!r}")
    return adamw.init(params, tcfg.adam)


def init_state(cfg: ModelConfig, tcfg: TrainConfig, *, seed: int = 0,
               device="cuda") -> dict[str, Any]:
    """Random parameters from ``seed`` on ``device`` (the card unless the
    caller asks for the CPU), the optimizer's state, step 0."""
    params = T.init_params(cfg, seed=seed, device=device)
    return {"params": params, "opt": init_opt(params, tcfg), "step": 0}


def _value_and_grad(params, batch, cfg: ModelConfig):
    """``(loss, metrics, grads)`` of ``loss_fn`` at ``params``; the
    gradients in the parameters' dtypes, shaped as ``params``."""
    flat = [p for _, p in adamw.leaves(params)]
    for p in flat:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss, m = T.loss_fn(params, batch, cfg)
            gs = torch.autograd.grad(loss, flat)
    finally:
        for p in flat:
            p.requires_grad_(False)
    it = iter(gs)
    grads = adamw.tree_map(lambda _, p: next(it), params)
    return loss.detach(), {k: v.detach() for k, v in m.items()}, grads


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    def grads_of(params, batch):
        if tcfg.accum == 1:
            return _value_and_grad(params, batch, cfg)
        acc = adamw.tree_map(
            lambda _, p: torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device), params)
        loss_sum = None
        for i in range(tcfg.accum):
            mb = {k: v[i] for k, v in batch.items()}
            loss, m, g = _value_and_grad(params, mb, cfg)
            adamw.tree_map(lambda _, a, b: a.add_(b.to(torch.float32)),
                           acc, g)
            loss_sum = loss if loss_sum is None else loss_sum + loss
        inv = 1.0 / tcfg.accum
        grads = adamw.tree_map(lambda _, g: g * inv, acc)
        return loss_sum * inv, m, grads

    def step_fn(state, batch):
        loss, lm_metrics, grads = grads_of(state["params"], batch)
        if tcfg.optimizer == "tree_newton":
            params, opt, om = kfac.apply(grads, state["opt"],
                                         state["params"], tcfg.tree_newton)
        else:
            params, opt, om = adamw.apply(grads, state["opt"],
                                          state["params"], tcfg.adam)
        metrics = {"loss": loss, **lm_metrics, **om}
        return ({"params": params, "opt": opt, "step": state["step"] + 1},
                metrics)

    return step_fn


def reshape_for_accum(batch, accum: int):
    if accum == 1:
        return batch
    return {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
            for k, v in batch.items()}
