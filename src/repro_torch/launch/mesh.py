"""Device meshes and a local launcher for ``torch.distributed``.

Counterpart of ``repro/launch/mesh.py``. :func:`make_mesh` is the
counterpart of ``jax.make_mesh``: a ``DeviceMesh`` over the process group
the caller already joined. JAX has one controller that sees every device;
torch has one process per rank, so the counterpart of ``make_host_mesh``
and the forced host devices is :func:`launch`: it runs one function on
every rank of a fresh group of spawned processes on this machine (gloo,
rendezvous on 127.0.0.1), and gives back what each rank returned. The CPU
tests and ``chip_smoke.py`` both use it; on a machine with fewer cards
than ranks, several ranks share a card.

:func:`make_host_mesh` and :func:`make_production_mesh` are the
reference's model meshes over the ranks of the group; both route the
DTensor collectives through :mod:`repro_torch.launch.hostwire` (gloo).
:class:`AbstractMesh` carries a mesh's axis names and sizes without any
rank, for the sharding rules (``jax.sharding.AbstractMesh``).

Nothing here touches a process group or a device when it is imported.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist


def make_mesh(shape, axes, device_type: str = "cuda"):
    """``DeviceMesh`` of ``shape`` with axis names ``axes`` over the
    default process group. Every rank calls it (SPMD); each rank keeps the
    current device it set (``launch`` sets it)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized torch.distributed "
                           "group: run the ranks with launch(), or call "
                           "init_process_group first")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


class AbstractMesh:
    """A mesh's ``shape`` (axis name -> size) and ``axis_names``, without
    devices: the sharding rules' input where no group of that size runs."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(self.axis_names, shape))

    def __repr__(self):
        return f"AbstractMesh({self.shape})"


def _model_mesh(shape, axes, device_type):
    need = 1
    for s in shape:
        need *= s
    have = dist.get_world_size() if dist.is_initialized() else None
    if have != need:
        raise RuntimeError(f"a {'x'.join(map(str, shape))} mesh "
                           f"{tuple(axes)} needs a group of {need} ranks, "
                           f"this one has {have}")
    from repro_torch.launch import hostwire
    hostwire.install()
    return make_mesh(shape, axes, device_type)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(16, 16) data x model, or (2, 16, 16) pod x data x model with
    ``multi_pod``: 256 / 512 ranks. Raises, naming the size it needs, in
    a group of any other size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _model_mesh(shape, axes, device_type)


def make_host_mesh(data: int = 4, model: int = 2, *,
                   device_type: str = "cuda"):
    """A ``data x model`` mesh over the ranks that :func:`launch` started
    (the CPU tests' 4 ranks, or ranks sharing one card)."""
    return _model_mesh((data, model), ("data", "model"), device_type)


def axis_size(mesh, axis: str) -> int:
    """Number of ranks along the mesh axis named ``axis``."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, nprocs, addr, device, timeout, jobs, results):
    """Body of one spawned rank: take the job, join the group, run it,
    report."""
    try:
        fn, args, kwargs = jobs.get(timeout=timeout)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
            torch.empty(0, device="cuda")      # the context, before the mesh
        else:
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // nprocs))
        dist.init_process_group(
            "gloo", init_method=addr, rank=rank, world_size=nprocs,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            value = fn(*args, **kwargs)
        finally:
            dist.destroy_process_group()
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    results.put((rank, True, value))


def launch(fn, nprocs: int, args=(), kwargs=None, *, device="cuda",
           timeout: float = 600.0) -> list:
    """Run ``fn(*args, **kwargs)`` on every rank of a fresh group of
    ``nprocs`` spawned processes; return the ranks' results in rank order.

    ``fn`` is pickled by reference, so it must be a module-level function
    of an importable module (a spawned child imports that module, and
    nothing of the caller's other modules); its arguments and its result
    are pickled. Each rank joins a gloo group at 127.0.0.1 whose
    collectives time out after ``timeout`` seconds and, for
    ``device="cuda"``, makes card ``rank % device_count`` its current
    device. The group is destroyed when ``fn`` returns.

    Raises ``RuntimeError`` with the rank's traceback when a rank raises
    or dies, and ``TimeoutError`` when the ranks have not all returned
    after ``timeout`` seconds; every rank still running is then
    terminated. Every process started here has ended when this returns.
    """
    ctx = multiprocessing.get_context("spawn")
    results, jobs = ctx.Queue(), ctx.Queue()
    addr = f"tcp://127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, nprocs, addr, str(device), timeout, jobs,
                               results))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    # the job goes through a queue, not the process arguments: a child
    # reads those only after its imports, and the parent would wait on
    # each child in turn to hand over a large argument
    for _ in procs:
        jobs.put((fn, tuple(args), dict(kwargs or {})))
    out: dict[int, object] = {}
    ok = False
    deadline = time.monotonic() + timeout
    try:
        while len(out) < nprocs:
            try:
                rank, good, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = {r: p.exitcode for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)}
                if dead:
                    # a traceback may still be in flight behind the exit
                    try:
                        rank, good, value = results.get(timeout=5.0)
                    except queue.Empty:
                        raise RuntimeError(f"ranks exited without a result "
                                           f"(exit codes {dead})") from None
                elif time.monotonic() > deadline:
                    raise TimeoutError(f"{len(out)} of {nprocs} ranks "
                                       f"returned within {timeout} s")
                else:
                    continue
            if not good:
                raise RuntimeError(f"rank {rank} of {nprocs} failed:\n"
                                   f"{value}")
            out[rank] = value
        ok = True
    finally:
        for p in procs:
            if ok:
                p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        results.close()
        jobs.close()
    return [out[r] for r in range(nprocs)]
