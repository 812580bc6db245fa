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
all-to-alls an ``all_gather`` and a slice: the bytes counted are what
moved (a reduce-scatter's, under ``reduce_scatter``, its whole operand:
twice a ring's; gloo's own list-form reduce-scatter was no faster on the
H100 machine's host). :data:`WIRE` counts each rank's bytes by collective
and dtype, as ``core.distributed.WIRE`` counts the solver's.

Training reaches the same ops: the backward of a gather over ``data``
(ZeRO-3's parameters) is a reduce-scatter, the backward of an
all-to-all an all-to-all, and a Partial gradient's reduction an
all-reduce, all staged here.

:func:`gather_to` brings a placed tensor whole to the ranks that need it
(TreeNewton's owners of a layer, rank 0 for a check or a summary) and to
no other: point to point through host memory, counted under ``gather``.
"""
from __future__ import annotations

import itertools

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


def _reduce(x, reduce_op: str, group, label: str = "all_reduce"):
    op = reduce_op.lower()
    if op not in _REDUCE:
        raise NotImplementedError(f"hostwire: reduce op {reduce_op!r}")
    host = x.detach().to("cpu", copy=True).contiguous()
    _count(label, host)
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
    full = _reduce(x, reduce_op, g, "reduce_scatter")
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


def _boxes(t) -> dict:
    """``{global rank: box}`` of a Shard/Replicate DTensor over its mesh:
    each rank's slices of the global tensor, ``((lo, hi), ...)``, split as
    DTensor splits (``torch.chunk`` sizes, mesh dimensions left to
    right)."""
    from torch.distributed.tensor import Replicate, Shard
    ranks = t.device_mesh.mesh
    out = {}
    for coord in _coords(ranks.shape):
        box = [[0, n] for n in t.shape]
        for i, q in enumerate(t.placements):
            if isinstance(q, Shard):
                lo, hi = box[q.dim]
                c = -(-(hi - lo) // ranks.shape[i])
                j = coord[i]
                box[q.dim] = [min(lo + j * c, hi), min(lo + (j + 1) * c, hi)]
            elif not isinstance(q, Replicate):
                raise ValueError(f"hostwire.gather_to: placed {t.placements}")
        out[int(ranks[coord])] = tuple(map(tuple, box))
    return out


def gather_to(t, dsts):
    """A DTensor's whole tensor in host memory on each global rank of
    ``dsts``, None on the other ranks (every rank of the mesh calls it).
    Each distinct shard goes once to each destination that lacks it, from
    the holder that shares the most mesh coordinates with the destination
    (point to point, through host memory); each rank's sent bytes are
    counted under ``gather``."""
    me = dist.get_rank()
    boxes = _boxes(t)
    ranks = t.device_mesh.mesh
    coords = {int(ranks[c]): c for c in _coords(ranks.shape)}
    local = t.to_local()
    if tuple(local.shape) != tuple(hi - lo for lo, hi in boxes[me]):
        raise AssertionError(f"hostwire.gather_to: local shard "
                             f"{tuple(local.shape)}, box {boxes[me]}")
    distinct = sorted(set(boxes.values()))
    host, recvs, works = None, [], []
    for dst in sorted(set(dsts)):
        for box in distinct:
            if box == boxes[dst]:
                continue
            src = max((r for r, b in boxes.items() if b == box),
                      key=lambda r: (sum(a == b for a, b in
                                         zip(coords[r], coords[dst])), -r))
            if me == src:
                if host is None:
                    host = local.detach().to("cpu").contiguous()
                _count("gather", host)
                works.append(dist.isend(host, dst))
            elif me == dst:
                buf = torch.empty(tuple(hi - lo for lo, hi in box),
                                  dtype=local.dtype)
                works.append(dist.irecv(buf, src))
                recvs.append((box, buf))
    for w in works:
        w.wait()
    if me not in dsts:
        return None
    out = torch.empty(tuple(t.shape), dtype=local.dtype)
    out[tuple(slice(lo, hi) for lo, hi in boxes[me])] = local.detach().cpu()
    for box, buf in recvs:
        out[tuple(slice(lo, hi) for lo, hi in box)] = buf
    return out


def _coords(shape):
    return itertools.product(*(range(n) for n in shape))


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
