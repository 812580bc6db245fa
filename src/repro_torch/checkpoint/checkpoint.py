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


def save(path: str, step: int, tree, *, keep_last: int = 3,
         blocking: bool = False, extra: dict | None = None) -> Handle:
    """Write ``tree`` as the checkpoint of ``step`` under ``path``; every
    leaf is copied to the host before this returns. Returns a
    :class:`Handle` (its ``wait()`` has nothing to wait for when
    ``blocking``)."""
    os.makedirs(path, exist_ok=True)
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


def restore(path: str, template, *, step: int | None = None):
    """``(tree, step)``: the checkpoint of ``step`` (the latest by
    default) in the structure of ``template``. A tensor leaf comes back as
    a new tensor of the stored dtype on the template leaf's device, a
    host integer as an int; every shape must equal the template's."""
    d, entries, step = _open(path, step)

    def one(name, leaf):
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
