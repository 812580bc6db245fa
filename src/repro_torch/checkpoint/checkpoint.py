"""Atomic, asynchronous checkpoints of the port's trees.

Counterpart of ``repro/checkpoint/checkpoint.py``, in the same format: one
directory per step (``step_00000042/``) holding

  manifest.json   — ``{"step", "leaves": [{"name", "shape", "dtype"}],
                    "shard_index": 0, "shard_count": 1, "extra"}``
  <leaf name>.npy — one array per leaf, the whole (global) array

A tree is nested dicts and lists whose leaves are tensors (any device),
numpy arrays, :class:`Stacked` leaves or host integers; ``None`` leaves
are skipped. A leaf's name joins its path's keys and list indices with
``__`` (``params__layers__0__attn__wq``), as the reference joins its
pytree paths. A host integer (a step, an optimizer's count) is stored as
a 0-d int32 array, as the reference stores its int32 scalars.

  * atomic  — written to ``.tmp-step_X`` and then ``os.rename``'d, so a
              crash during a save never leaves a broken latest step;
  * async   — :func:`save` copies every leaf to the host, then returns a
              handle while a thread writes the files; ``wait()`` joins it
              (and raises what the writer raised). The optimizers update
              their tensors in place, so the copy is what makes a later
              step unable to change what is written;
  * bounded — ``keep_last`` removes the older steps after a rename.

From a device mesh (a tree whose tensors are DTensors, or ``meta``
tensors where a rank does not hold a leaf, as
``convert.place_train_state`` makes them; every rank calls :func:`save`
with its own tree) the files are the same, byte for byte, and nothing of
the state crosses the wire: rank 0 writes each ``.npy`` header and the
manifest and sizes each file, then each rank writes the slices it holds
into the global arrays (a shard replicated over some axes by the rank at
coordinate 0 there; a whole tensor that several ranks hold by the lowest
of them), with barriers between. Such a save is blocking.
:func:`restore` with ``shardings`` (``launch.sharding.NamedSharding``
leaves, ``convert.train_state_shardings``) reads only each rank's slice
of each global array onto whatever mesh it names, and
:func:`restore_into` does the same into a placed tree in place: resume
is mesh-elastic.

bfloat16 has no numpy type here: its file holds the raw 16-bit patterns
under the header the reference's ``np.save`` of an ``ml_dtypes`` array
writes (``'<V2'``), so the files are the reference's byte for byte, and
the manifest names the dtype ``"bfloat16"``. :func:`restore` rebuilds
bf16 from the manifest, never from the file's header, so it reads the
reference's bf16 files as well as its own.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

_MANIFEST = "manifest.json"
_BF16 = "bfloat16"


class Stacked:
    """One leaf whose value is ``parts`` (tensors of one shape and dtype)
    stacked on a new first axis, as the reference stacks its layers
    ``[L, ...]``. :func:`save` builds the stack on the host layer by layer
    in one array; :func:`restore_into` copies a stored stack back into the
    parts. Neither stacks anything on the device."""

    def __init__(self, parts):
        self.parts = list(parts)
        if not self.parts:
            raise ValueError("Stacked needs at least one part")

    @property
    def shape(self):
        return (len(self.parts), *self.parts[0].shape)

    @property
    def dtype(self):
        return self.parts[0].dtype


def leaves(tree, prefix: str = ""):
    """``[(name, leaf), ...]``: dict keys in their order, list items by
    index, the path joined with ``__``; ``None`` leaves skipped."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [] if tree is None else [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(leaves(v, f"{prefix}__{k}" if prefix else str(k)))
    return out


def _rebuild(tree, fn, prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(name, leaf)``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, f"{prefix}__{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, fn, f"{prefix}__{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return None if tree is None else fn(prefix, tree)


def _is_int(x) -> bool:
    return isinstance(x, (int, np.integer)) and not isinstance(x, bool)


def _host_buffer(shape, dtype):
    """An empty numpy array for ``dtype`` (torch), and a tensor view of it
    to copy into; bf16 lives in an int16 array."""
    if dtype == torch.bfloat16:
        buf = np.empty(shape, np.int16)
        return buf, torch.from_numpy(buf).view(torch.bfloat16), _BF16
    view = torch.empty((), dtype=dtype)
    buf = np.empty(shape, view.numpy().dtype)
    return buf, torch.from_numpy(buf), str(buf.dtype)


def _host(leaf):
    """``(array, dtype name)``: a host copy of ``leaf`` that nothing else
    holds."""
    if isinstance(leaf, Stacked):
        buf, view, name = _host_buffer(leaf.shape, leaf.dtype)
        for i, part in enumerate(leaf.parts):
            view[i].copy_(part.detach())
        return buf, name
    if torch.is_tensor(leaf):
        buf, view, name = _host_buffer(tuple(leaf.shape), leaf.dtype)
        view.copy_(leaf.detach())
        return buf, name
    if _is_int(leaf):
        return np.asarray(leaf, np.int32), "int32"
    arr = np.array(leaf, copy=True)
    if arr.dtype.name == _BF16:                 # an ml_dtypes array
        return arr.view(np.int16), _BF16
    return arr, str(arr.dtype)


def _write(fname, arr, dtype):
    if dtype != _BF16:
        np.save(fname, arr)
        return
    with open(fname, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": tuple(arr.shape)})
        np.ascontiguousarray(arr).tofile(f)


class Handle:
    """The pending write of ``step``: :meth:`wait` joins the writer and
    returns the step's directory."""

    def __init__(self, final, step, thread=None):
        self.final = final
        self.step = step
        self._thread = thread
        self.error = None
        self.seconds = None         # the writer's time, once it is done

    def wait(self):
        if self._thread is not None:
            self._thread.join()
        if self.error is not None:
            raise self.error
        return self.final


def _is_dtensor(x) -> bool:
    if not torch.is_tensor(x):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _placed(leaf) -> bool:
    """Whether ``leaf`` belongs to a mesh's tree: a DTensor, a ``meta``
    tensor, or a :class:`Stacked` of them."""
    if isinstance(leaf, Stacked):
        return any(_placed(p) for p in leaf.parts)
    return torch.is_tensor(leaf) and (_is_dtensor(leaf)
                                      or leaf.device.type == "meta")


def _np_dtype(dtype):
    """``(numpy dtype of the file's elements, manifest name)`` of a torch
    dtype (bf16: int16 elements, "bfloat16")."""
    if dtype == torch.bfloat16:
        return np.dtype(np.int16), _BF16
    d = torch.empty((), dtype=dtype).numpy().dtype
    return d, str(d)


def _host_np(t):
    """A (local) tensor as a numpy array of its file elements."""
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _box(t):
    """The slices of a DTensor's global array that this rank's shard
    covers, and whether this rank writes them (the replica at coordinate 0
    of every axis that replicates it)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = t.device_mesh
    for q in t.placements:
        if not isinstance(q, (Replicate, Shard)):
            raise ValueError(f"checkpoint: a leaf placed {t.placements}")
    shape, off = compute_local_shape_and_global_offset(
        tuple(t.shape), mesh, t.placements)
    writes = all(mesh.get_local_rank(i) == 0
                 for i, q in enumerate(t.placements)
                 if isinstance(q, Replicate))
    return tuple(slice(o, o + n) for o, n in zip(off, shape)), writes


def _create(fname, shape, dtype):
    """The file of a global array, its header written and its size set
    (the header np.save writes; bf16's as :func:`_write`)."""
    npd, name = _np_dtype(dtype)
    if name != _BF16:
        np.lib.format.open_memmap(fname, mode="w+", dtype=npd,
                                  shape=tuple(shape)).flush()
        return
    with open(fname, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": tuple(shape)})
        f.truncate(f.tell() + int(np.prod(shape, dtype=np.int64)) * 2)


def _save_mesh(path, step, tree, keep_last, extra) -> Handle:
    """:func:`save` from a mesh (module docstring); every rank calls it."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    rank = dist.get_rank()
    final = os.path.join(path, f"step_{step:08d}")
    tmp = os.path.join(path, f".tmp-step_{step:08d}")
    items = leaves(tree)
    whole = []                  # plain tensors: (name, part or None)
    for name, leaf in items:
        if isinstance(leaf, Stacked):
            whole += [(name, i) for i, p in enumerate(leaf.parts)
                      if not _is_dtensor(p)]
        elif torch.is_tensor(leaf) and not _is_dtensor(leaf):
            whole.append((name, None))

    def part(name, i):
        leaf = dict(items)[name]
        return leaf if i is None else leaf.parts[i]
    mine = [part(n, i).device.type != "meta" for n, i in whole]
    held = [None] * dist.get_world_size()
    dist.all_gather_object(held, mine)
    writer = {}
    for k, key in enumerate(whole):
        ranks = [r for r, h in enumerate(held) if h[k]]
        if not ranks:
            raise ValueError(f"checkpoint: no rank holds {key}")
        writer[key] = ranks[0]
    if rank == 0:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": [], "shard_index": 0,
                    "shard_count": 1, "extra": extra or {}}
        for name, leaf in items:
            fname = os.path.join(tmp, name + ".npy")
            if _is_int(leaf):
                np.save(fname, np.asarray(leaf, np.int32))
                shape, dname = (), "int32"
            else:
                shape = tuple(leaf.shape)
                _create(fname, shape, leaf.dtype)
                dname = _np_dtype(leaf.dtype)[1]
            manifest["leaves"].append({"name": name, "shape": list(shape),
                                       "dtype": dname})
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
    dist.barrier()
    for name, leaf in items:
        if _is_int(leaf):
            continue
        parts = (list(enumerate(leaf.parts)) if isinstance(leaf, Stacked)
                 else [(None, leaf)])
        mm = None
        for i, t in parts:
            lead = () if i is None else (i,)
            if _is_dtensor(t):
                box, writes = _box(t)
                src = t.to_local()
            else:
                box, writes = (), writer.get((name, i)) == rank
                src = t
            if not writes:
                continue
            if mm is None:
                mm = np.load(os.path.join(tmp, name + ".npy"),
                             mmap_mode="r+")
                if mm.dtype.kind == "V":
                    mm = mm.view(np.int16)
            mm[lead + box] = _host_np(src)
        if mm is not None:
            mm.flush()
            del mm
    dist.barrier()
    if rank == 0:
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _cleanup(path, keep_last)
    dist.barrier()
    handle = Handle(final, step)
    handle.seconds = time.perf_counter() - t0
    return handle


def save(path: str, step: int, tree, *, keep_last: int = 3,
         blocking: bool = False, extra: dict | None = None) -> Handle:
    """Write ``tree`` as the checkpoint of ``step`` under ``path``; every
    leaf is copied to the host before this returns. Returns a
    :class:`Handle` (its ``wait()`` has nothing to wait for when
    ``blocking``). A mesh's tree (module docstring) is saved by every
    rank together, blocking."""
    os.makedirs(path, exist_ok=True)
    if any(_placed(leaf) for _, leaf in leaves(tree)):
        return _save_mesh(path, step, tree, keep_last, extra)
    final = os.path.join(path, f"step_{step:08d}")
    tmp = os.path.join(path, f".tmp-step_{step:08d}")
    host = [(name, *_host(leaf)) for name, leaf in leaves(tree)]
    handle = Handle(final, step)

    def write():
        t0 = time.perf_counter()
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": [], "shard_index": 0,
                    "shard_count": 1, "extra": extra or {}}
        for name, arr, dtype in host:
            _write(os.path.join(tmp, name + ".npy"), arr, dtype)
            manifest["leaves"].append({"name": name,
                                       "shape": list(arr.shape),
                                       "dtype": dtype})
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _cleanup(path, keep_last)
        handle.seconds = time.perf_counter() - t0

    def guarded():
        try:
            write()
        except Exception as e:          # raised again by wait()
            handle.error = e

    if blocking:
        write()
    else:
        handle._thread = threading.Thread(target=guarded, daemon=True)
        handle._thread.start()
    return handle


def _cleanup(path: str, keep_last: int):
    steps = sorted(d for d in os.listdir(path) if d.startswith("step_"))
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(path, d), ignore_errors=True)


def latest_step(path: str) -> int | None:
    """The largest step under ``path`` whose manifest is written, or
    None."""
    if not os.path.isdir(path):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(path)
             if d.startswith("step_")
             and os.path.exists(os.path.join(path, d, _MANIFEST))]
    return max(steps) if steps else None


def _open(path: str, step: int | None):
    step = step if step is not None else latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)
    return d, {e["name"]: e for e in manifest["leaves"]}, step


def _shape(leaf):
    return () if _is_int(leaf) else tuple(leaf.shape)


def _load(d, entries, name, leaf):
    """The stored array of ``name`` as a CPU tensor of the manifest's
    dtype (bf16 from its bit patterns), its shape checked against the
    template's ``leaf``."""
    if name not in entries:
        raise KeyError(f"{name}: not in the checkpoint {d}")
    arr = np.load(os.path.join(d, name + ".npy"))
    if tuple(arr.shape) != _shape(leaf):
        raise ValueError(f"{name}: checkpoint {tuple(arr.shape)} vs "
                         f"template {_shape(leaf)}")
    if entries[name]["dtype"] == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _mapped(d, entries, name, leaf):
    """The stored array of ``name`` memory-mapped (bf16 as int16), its
    shape checked against ``leaf``'s."""
    if name not in entries:
        raise KeyError(f"{name}: not in the checkpoint {d}")
    mm = np.load(os.path.join(d, name + ".npy"), mmap_mode="r")
    if tuple(mm.shape) != _shape(leaf):
        raise ValueError(f"{name}: checkpoint {tuple(mm.shape)} vs "
                         f"template {_shape(leaf)}")
    return mm.view(np.int16) if entries[name]["dtype"] == _BF16 else mm


def _tensor(arr, entry, device):
    """A copy of (a slice of) a mapped array as a tensor on ``device``:
    nothing may keep pointing into the map."""
    t = torch.from_numpy(np.array(arr, copy=True, order="C"))
    if entry["dtype"] == _BF16:
        t = t.view(torch.bfloat16)
    return t.to(device)


def _mesh_device(mesh):
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _read_placed(d, entries, name, leaf, sharding):
    """Each rank's slice of the stored array of ``name``, placed by
    ``sharding`` (a ``NamedSharding``): a DTensor, a :class:`Stacked` of
    them, or, for a stack split over an axis with whole parts (TreeNewton's
    statistics), the parts this rank holds and ``meta`` tensors
    elsewhere."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.sharding import local_box, placements
    mesh, spec = sharding.mesh, tuple(sharding.spec)
    if _is_int(leaf):
        return int(_load(d, entries, name, leaf))
    mm = _mapped(d, entries, name, leaf)
    entry, dev = entries[name], _mesh_device(mesh)

    def placed(arr, sp):
        box = local_box(arr.shape, sp, mesh)
        return DTensor.from_local(_tensor(arr[box], entry, dev), mesh,
                                  placements(sp, mesh), run_check=False)
    if not isinstance(leaf, Stacked):
        return placed(mm, spec)
    if spec[0] is None:
        return Stacked([placed(mm[i], spec[1:]) for i in range(len(mm))])
    if any(e is not None for e in spec[1:]):
        raise ValueError(f"{name}: a stack split over {spec[0]} and its "
                         "parts sharded")
    box = local_box(mm.shape, spec[:1], mesh)[0]
    return Stacked([_tensor(mm[i], entry, dev)
                    if box.start <= i < box.stop else
                    torch.empty(mm.shape[1:], dtype=leaf.dtype,
                                device="meta") for i in range(len(mm))])


def restore(path: str, template, *, step: int | None = None,
            shardings=None):
    """``(tree, step)``: the checkpoint of ``step`` (the latest by
    default) in the structure of ``template``. A tensor leaf comes back as
    a new tensor of the stored dtype on the template leaf's device, a
    host integer as an int; every shape must equal the template's.

    ``shardings``, a tree of ``template``'s structure whose leaves are
    ``launch.sharding.NamedSharding`` (or None), places each leaf on its
    mesh instead, each rank reading only its slice of the global array
    (:func:`_read_placed`): the reference's mesh-elastic restore. The
    template's tensors then give shapes only (``meta`` will do)."""
    d, entries, step = _open(path, step)
    placed = {} if shardings is None else dict(leaves(shardings))

    def one(name, leaf):
        if placed.get(name) is not None:
            return _read_placed(d, entries, name, leaf, placed[name])
        t = _load(d, entries, name, leaf)
        if _is_int(leaf):
            return int(t)
        if isinstance(leaf, Stacked):
            dev = leaf.parts[0].device
            return Stacked([p.to(dev) for p in t.unbind(0)])
        return t.to(leaf.device)
    return _rebuild(template, one), step


def restore_into(path: str, tree, *, step: int | None = None):
    """``(tree, step)``: the checkpoint copied into the tensors of
    ``tree`` in place (a :class:`Stacked` leaf layer by layer into its
    parts), one stored array on the host at a time; the host integers,
    which cannot change in place, come back in the returned tree. Each
    leaf's shape and dtype must equal the stored one."""
    d, entries, step = _open(path, step)

    def one(name, leaf):
        if _placed(leaf):
            return _read_into(d, entries, name, leaf)
        t = _load(d, entries, name, leaf)
        if _is_int(leaf):
            return int(t)
        if t.dtype != leaf.dtype:
            raise ValueError(f"{name}: checkpoint {t.dtype} vs template "
                             f"{leaf.dtype}")
        if isinstance(leaf, Stacked):
            for part, src in zip(leaf.parts, t.unbind(0)):
                part.copy_(src)
        else:
            leaf.copy_(t)
        return leaf
    return _rebuild(tree, one), step


def _read_into(d, entries, name, leaf):
    """:func:`restore_into` of a mesh's leaf: each DTensor's local shard
    read from its slice of the global array; a ``meta`` part skipped; a
    whole tensor read whole."""
    mm = _mapped(d, entries, name, leaf)
    if entries[name]["dtype"] != _np_dtype(leaf.dtype)[1]:
        raise ValueError(f"{name}: checkpoint {entries[name]['dtype']} vs "
                         f"template {leaf.dtype}")
    parts = (list(enumerate(leaf.parts)) if isinstance(leaf, Stacked)
             else [(None, leaf)])
    for i, t in parts:
        arr = mm if i is None else mm[i]
        if _is_dtensor(t):
            dst = t.to_local()
            src = arr[_box(t)[0]]
        elif t.device.type == "meta":
            continue
        else:
            dst, src = t, arr
        dst.copy_(_tensor(src, entries[name], "cpu"))
    return leaf
