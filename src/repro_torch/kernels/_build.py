"""Build the CUDA kernels at first use and load them with ctypes.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, into a shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o lib<name>.so csrc/<name>.cu

No PyTorch header is included, so a build takes seconds, not minutes.
``--use_fast_math`` is deliberately absent: approximate division and
square root would move ``x / alpha`` and every pivot, and with them every
per-tile rounding the plan prescribes.

The libraries go to ``build/repro_torch/<hash>/`` at the root of the
checkout, keyed by a hash of the sources and the flags, so an edited
source is rebuilt and an unchanged one is reused. Nothing here runs when
the package is imported.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}
#: wall seconds the last build took (0.0 when the libraries were reused)
BUILD_SECONDS = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine that holds the card")


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile every missing library in parallel and load them all."""
    global BUILD_SECONDS
    if _LIBS:
        return _LIBS
    out = BUILD_ROOT / _digest()
    out.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    procs = []
    for src in sources:
        lib = out / f"lib{src.stem}.so"
        if lib.exists():
            continue
        tmp = out / f".lib{src.stem}.{os.getpid()}.so"
        cmd = [_nvcc(), *FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs.append((src, tmp, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for src, tmp, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{src.name}:\n{log.decode(errors='replace')}")
        else:
            os.replace(tmp, lib)
    if errors:
        raise RuntimeError("nvcc failed\n" + "\n".join(errors))
    BUILD_SECONDS = time.perf_counter() - t0 if procs else 0.0
    for src in sources:
        _LIBS[src.stem] = ctypes.CDLL(str(out / f"lib{src.stem}.so"))
    return _LIBS


def function(lib: str, name: str, argtypes):
    """A C entry point with its argument types set (``c_void_p`` for
    pointers and the stream, so no pointer is cut to 32 bits). Every
    entry point returns its launch's ``cudaError_t``."""
    fn = getattr(build_all()[lib], name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise if a launch was refused (bad configuration, no device...)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def on_device(device):
    """A context that makes ``device`` the current one for a launch (a
    no-op, and no cost, when it already is)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def raw_stream(device) -> int:
    """The address of ``device``'s current stream, through torch's direct
    accessor where it has one (no Stream object is built)."""
    get = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if get is not None:
        return get(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def scalar_arg(x, device, what):
    """``(device pointer or None, host value)`` of a scale or beta: a
    Python number goes by value, a one-element f32 tensor on ``device``
    by its address, for the kernel to read on the card (no host sync)."""
    if not torch.is_tensor(x):
        return None, float(x)
    if x.numel() != 1 or x.dtype != torch.float32 or x.device != device:
        raise TypeError(f"{what}: a tensor scalar must be one f32 on "
                        f"{device}, got {tuple(x.shape)} {x.dtype} on "
                        f"{x.device}")
    return x.data_ptr(), 0.0
