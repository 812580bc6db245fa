"""Mixture-of-Experts FFN (DeepSeek style: shared + routed, top-k), in
torch.

Counterpart of ``repro/models/moe.py``. Expert parallelism: under a mesh
the experts are sharded over the ``model`` axis (``ep`` shards of
``E / ep`` experts) and each (data, model) rank routes its LOCAL tokens
(:func:`moe_local` with ``ep`` and ``my``, the rank's index on ``model``,
between ``Sharder.local`` and ``Sharder.wrap``: the reference's
``shard_map``), keeps the assignments that hit its own experts, and the
partial outputs are summed over ``model`` in rank order (0, 1, ...,
``ep - 1``: gathered, then added one at a time); the aux is averaged over
every mesh axis. Without a mesh ``ep = 1``. The router
runs in f32: softmax, top-k, gates renormalised over the k. The T * K
assignments are sorted by local expert with a STABLE sort (as
``jnp.argsort``), the assignments of other ranks' experts last, the
first ``cap`` kept (``cap = int(ceil(T K / ep) * capacity_factor)``,
at most T K: at a factor >= 1 and ep = 1 nothing drops), and each
expert's contiguous rows
go through its SwiGLU FFN, the counterpart of ``jax.lax.ragged_dot``:
the counts come to the host once per layer, then one product per
non-empty expert and weight (the loop runs under the profiler range
``moe_expert_loop``). Rows past the kept ones stay exact zeros.

The combine adds each token's gate-weighted contributions one at a time
in ascending expert order, the order in which the reference's
``.at[].add`` meets them, so the result does not depend on atomics and
is the same bits from run to run. The load-balance aux is ``E * sum(
mean(probs) * assignments / (T K))`` in f32. The shared experts are a
dense SwiGLU on every token.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import (NO_SHARD, ModelConfig, Sharder,
                                       _init, matmul)


def moe_params(cfg: ModelConfig, *, generator, device):
    d, E, F_ = cfg.d_model, cfg.moe_experts, cfg.moe_dff or cfg.d_ff
    kw = dict(generator=generator, device=device)
    p = {"router": _init((d, E), torch.float32, **kw),     # router in f32
         "w_in": _init((E, d, F_), cfg.pdt, **kw),
         "w_gate": _init((E, d, F_), cfg.pdt, **kw),
         "w_out": _init((E, F_, d), cfg.pdt, **kw)}
    if cfg.moe_shared:
        Fs = F_ * cfg.moe_shared
        p["shared"] = {"w_in": _init((d, Fs), cfg.pdt, **kw),
                       "w_gate": _init((d, Fs), cfg.pdt, **kw),
                       "w_out": _init((Fs, d), cfg.pdt, **kw)}
    return p


def route(xf, router_w, k):
    """f32 router over rows xf [T, D]: (probs [T, E], gate [T, k], idx
    [T, k]), the gates renormalised over the k chosen experts."""
    logits = matmul(xf.to(torch.float32), router_w)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    return probs, gate, idx


def capacity(T: int, K: int, factor: float, ep: int = 1) -> int:
    """The reference's static capacity of one of ``ep`` expert shards."""
    return max(min(int(-(-T * K // ep) * factor), T * K), 1)


def _expert_ffn(rows, w_in, w_gate, w_out, counts):
    """Grouped SwiGLU over rows sorted by expert: expert e takes the next
    ``counts[e]`` rows. Products in the operands' dtype (bf16 in, bf16
    out, as ``ragged_dot``); rows past ``sum(counts)`` are zeros."""
    out = rows.new_zeros((rows.shape[0], w_out.shape[-1]))
    with torch.profiler.record_function("moe_expert_loop"):
        start = 0
        for e, n in enumerate(counts.tolist()):
            if n:
                r = rows[start:start + n]
                h = matmul(r, w_in[e])
                g = matmul(r, w_gate[e])
                h = F.silu(g) * h
                out[start:start + n] = matmul(h.to(rows.dtype), w_out[e])
            start += n
    return out


def moe_local(x, router_w, w_in, w_gate, w_out, *, cfg: ModelConfig,
              ep: int = 1, my: int = 0):
    """The routed experts on x [B, S, D] with the expert shard ``my`` of
    ``ep`` (``w_*`` its ``E / ep`` experts): (out [B, S, D] in x's dtype,
    the shard's PARTIAL output where ep > 1, aux f32 scalar, the routing
    ``{"idx": [T, K] experts, "kept": the flat indices t * K + k of the
    kept assignments, sorted by local expert, other shards' last}``).
    The reference's ``_moe_local``."""
    B, S, D = x.shape
    T, K, E = B * S, cfg.moe_topk, cfg.moe_experts
    e_loc = E // ep
    dev = x.device
    xf = x.reshape(T, D)
    probs, gate, idx = route(xf, router_w, K)

    flat_e = idx.reshape(T * K)
    local = torch.div(flat_e, e_loc, rounding_mode="floor") == my
    key = torch.where(local, flat_e % e_loc, e_loc)      # non-local last
    order = torch.argsort(key, stable=True)
    cap = capacity(T, K, cfg.moe_capacity_factor, ep)
    sel = order[:cap]
    sel_key = key[sel]                                   # ascending
    rows = xf[sel // K]                                  # [cap, D]
    counts = torch.bincount(sel_key, minlength=e_loc + 1)[:e_loc]
    out_rows = _expert_ffn(rows, w_in, w_gate, w_out, counts)
    weighted = out_rows * gate.reshape(T * K)[sel][:, None].to(
        out_rows.dtype)

    # combine: each token's kept rows, ascending expert, added one at a
    # time (a dropped assignment points at the zero row ``cap``)
    slot = torch.full((T * K,), cap, dtype=torch.long, device=dev)
    slot[sel] = torch.arange(cap, device=dev)
    weighted = torch.cat([weighted, weighted.new_zeros((1, D))])
    perm = torch.sort(idx, dim=-1).indices               # ascending expert
    take = slot[torch.arange(T, device=dev)[:, None] * K + perm]  # [T, K]
    out = torch.zeros((T, D), dtype=out_rows.dtype, device=dev)
    for j in range(K):
        out = out + weighted[take[:, j]]

    me = probs.mean(dim=0)                               # [E]
    ce = torch.bincount(flat_e, minlength=E).to(torch.float32) / (T * K)
    aux = E * torch.sum(me * ce)
    return out.reshape(B, S, D).to(x.dtype), aux, {"idx": idx,
                                                   "kept": sel}


def moe_ffn(x, p, cfg: ModelConfig, sharder: Sharder = NO_SHARD):
    """The MoE block: routed experts plus the shared experts' dense
    SwiGLU. Returns (out, aux)."""
    if sharder.enabled:
        routed, aux = _moe_sharded(x, p, cfg, sharder)
    else:
        routed, aux, _ = moe_local(x, p["router"], p["w_in"], p["w_gate"],
                                   p["w_out"], cfg=cfg)
    if cfg.moe_shared:
        sp = p["shared"]
        h = matmul(x, sp["w_in"])
        g = matmul(x, sp["w_gate"])
        h = sharder.act_ffn(F.silu(g).to(h.dtype) * h)
        routed = routed + matmul(h, sp["w_out"])
    return routed, aux


def _moe_sharded(x, p, cfg: ModelConfig, sharder: Sharder):
    """Expert parallelism over ``model`` (module docstring): x at
    (batch, None, None), the router replicated, the experts gathered to
    (model, None, None), as the reference's ``shard_map`` takes them."""
    from repro_torch.launch.sharding import axis_names
    m, b = sharder.model_axis, sharder.b
    if m is None:
        raise ValueError("the MoE's expert parallelism needs a model axis "
                         "(layout 'tp')")
    ep = sharder._msize()
    x_spec = (b, None, None)
    w = [sharder.local(p[n], (m, None, None))
         for n in ("w_in", "w_gate", "w_out")]
    out, aux, _ = moe_local(sharder.local(x, x_spec),
                            sharder.local(p["router"], (None, None)), *w,
                            cfg=cfg, ep=ep, my=sharder.rank(m))
    # the partial outputs, gathered over model and added in rank order
    parts = sharder.local(sharder.wrap(out[None], (m, b, None, None)),
                          (None, b, None, None))
    routed = parts[0]
    for i in range(1, ep):
        routed = routed + parts[i]
    every = sharder.local(sharder.wrap(aux.reshape(1),
                                       (axis_names(sharder.mesh),)), (None,))
    return sharder.wrap(routed, x_spec), every.mean()


def moe_ffn_dense_reference(x, p, cfg: ModelConfig):
    """O(E)-cost dropless oracle (tests and the card's check): every
    expert computes every token densely; outputs combined with the top-k
    gates. The reference's ``moe_ffn_dense_reference``."""
    B, S, D = x.shape
    T = B * S
    xf = x.reshape(T, D)
    _, gate, idx = route(xf, p["router"], cfg.moe_topk)
    h = torch.einsum("td,edf->tef", xf, p["w_in"])
    g = torch.einsum("td,edf->tef", xf, p["w_gate"])
    h = F.silu(g) * h
    y = torch.einsum("tef,efd->ted", h.to(xf.dtype), p["w_out"])
    mask = F.one_hot(idx, cfg.moe_experts).to(torch.float32)   # [T,K,E]
    w = torch.einsum("tk,tke->te", gate, mask)
    out = torch.einsum("te,ted->td", w.to(y.dtype), y)
    return out.reshape(B, S, D)
