"""The wire under DTensor on a gloo group: collectives staged through host
memory, counted by collective.

A ``DTensor`` redistributes through the functional collectives
(``torch.ops._c10d_functional.*`` and ``_dtensor.shard_dim_alltoall``).
NCCL refuses two ranks on one card, so the ranks that share a card talk
over gloo, and gloo's tensor-form collectives do not run on CUDA tensors
(``all_gather_into_tensor`` of a CUDA tensor crashed the ranks on the
H100 machine, torch 2.11). :func:`install` registers, for the CPU and
the CUDA dispatch keys, kernels of those ops that copy the operand to
host memory, run gloo's list-form collective there (``all_gather``,
``all_reduce``, ``broadcast``: the forms that take CUDA and CPU tensors
alike), and copy the result back to the operand's device. The compute
stays where it was; only the bytes on the wire pass through the host,
as gloo moves a CUDA tensor anyway. The CPU tests and the card run this
same code. Every op returns a finished tensor (the collectives are
synchronous), so ``wait_tensor`` has nothing to wait for.

``reduce_scatter_tensor`` is an ``all_reduce`` and a slice, and the
all-to-alls an ``all_gather`` and a slice: gloo has no reduce-scatter,
so the bytes counted are what moved. :data:`WIRE` counts each rank's
bytes by collective and dtype, as ``core.distributed.WIRE`` counts the
solver's.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

#: bytes each rank handed to each collective since :func:`reset_wire`,
#: by collective and dtype
WIRE: dict[str, dict[str, int]] = {}

_LIBS: list = []


def reset_wire() -> None:
    WIRE.clear()


def _count(op: str, t) -> None:
    name = str(t.dtype).replace("torch.", "")
    per = WIRE.setdefault(op, {})
    per[name] = per.get(name, 0) + t.numel() * t.element_size()


def _group(group_name):
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(group_name)


_REDUCE = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM,
           "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
           "product": dist.ReduceOp.PRODUCT}


def _gather(x, group) -> list:
    host = x.detach().to("cpu").contiguous()
    _count("all_gather", host)
    out = [torch.empty_like(host) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, host, group=group)
    return out


def _reduce(x, reduce_op: str, group):
    op = reduce_op.lower()
    if op not in _REDUCE:
        raise NotImplementedError(f"hostwire: reduce op {reduce_op!r}")
    host = x.detach().to("cpu", copy=True).contiguous()
    _count("all_reduce", host)
    dist.all_reduce(host, op=_REDUCE[op], group=group)
    if op == "avg":
        host = host / dist.get_world_size(group)
    return host


def all_gather_into_tensor(x, group_size, group_name):
    g = _group(group_name)
    return torch.cat(_gather(x, g)).to(x.device)


def all_reduce(x, reduce_op, group_name):
    return _reduce(x, reduce_op, _group(group_name)).to(x.device)


def reduce_scatter_tensor(x, reduce_op, group_size, group_name):
    g = _group(group_name)
    full = _reduce(x, reduce_op, g)
    return full.chunk(group_size)[dist.get_rank(g)].contiguous().to(x.device)


def all_to_all_single(x, output_split_sizes, input_split_sizes, group_name):
    g = _group(group_name)
    n, me = dist.get_world_size(g), dist.get_rank(g)
    if output_split_sizes or input_split_sizes:
        if len(set(output_split_sizes) | set(input_split_sizes)) > 1:
            raise NotImplementedError("hostwire: uneven all_to_all_single")
    parts = _gather(x, g)
    return torch.cat([p.chunk(n)[me] for p in parts]).to(x.device)


def shard_dim_alltoall(x, gather_dim, shard_dim, group_name):
    g = _group(group_name)
    n, me = dist.get_world_size(g), dist.get_rank(g)
    full = torch.cat(_gather(x, g), dim=gather_dim)
    return full.chunk(n, dim=shard_dim)[me].contiguous().to(x.device)


def broadcast(x, src, group_name):
    g = _group(group_name)
    host = x.detach().to("cpu", copy=True).contiguous()
    _count("broadcast", host)
    dist.broadcast(host, src=dist.get_global_rank(g, src), group=g)
    return host.to(x.device)


def _coalesced(fn):
    def run(xs, *args):
        return [fn(x, *args) for x in xs]
    return run


_KERNELS = {
    ("_c10d_functional", "all_gather_into_tensor"): all_gather_into_tensor,
    ("_c10d_functional", "all_reduce"): all_reduce,
    ("_c10d_functional", "reduce_scatter_tensor"): reduce_scatter_tensor,
    ("_c10d_functional", "all_to_all_single"): all_to_all_single,
    ("_c10d_functional", "broadcast"): broadcast,
    ("_c10d_functional", "all_gather_into_tensor_coalesced"):
        _coalesced(all_gather_into_tensor),
    ("_c10d_functional", "all_reduce_coalesced"): _coalesced(all_reduce),
    ("_c10d_functional", "reduce_scatter_tensor_coalesced"):
        _coalesced(reduce_scatter_tensor),
    ("_dtensor", "shard_dim_alltoall"): shard_dim_alltoall,
}


def install() -> None:
    """Register the host-staged kernels for the CPU and CUDA keys (once a
    process). Ops this torch does not define are skipped."""
    if _LIBS:
        return
    import torch.distributed.tensor  # noqa: F401  (defines _dtensor ops)
    libs = {}
    for (ns, name), fn in _KERNELS.items():
        if not hasattr(getattr(torch.ops, ns), name):
            continue
        if ns not in libs:
            libs[ns] = torch.library.Library(ns, "IMPL")
        for key in ("CPU", "CUDA"):
            libs[ns].impl(name, fn, key)
    _LIBS.extend(libs.values())
