"""Architecture registry: --arch <id> resolves here (the port's own copy
of ``repro/configs``, pure data importing the port's ``ModelConfig``;
the port runs every family of them).

Each module defines full() (the exact published config) and smoke()
(a reduced same-family config for CPU tests). SHAPES lists the assigned
input-shape cells; SKIP_CELLS marks (arch, shape) pairs excluded per the
assignment (long_500k needs sub-quadratic attention — only the SSM /
hybrid archs run it; see docs/ARCHITECTURE.md, "Model and training integrations").
"""
from __future__ import annotations

import dataclasses
import importlib

_MODULES = {
    "pixtral-12b": "pixtral_12b",
    "nemotron-4-15b": "nemotron_15b",
    "gemma-2b": "gemma_2b",
    "nemotron-4-340b": "nemotron_340b",
    "granite-34b": "granite_34b",
    "rwkv6-3b": "rwkv6_3b",
    "musicgen-large": "musicgen_large",
    "zamba2-2.7b": "zamba2_2p7b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite",
    "deepseek-v3-671b": "deepseek_v3_671b",
}

ARCHS = tuple(_MODULES)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str           # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# long_500k runs only for O(1)-state decoders (assignment rule).
LONG_OK = frozenset({"rwkv6-3b", "zamba2-2.7b"})


def cells():
    """All 40 (arch, shape) cells with a runnable flag."""
    out = []
    for a in ARCHS:
        for s in SHAPES:
            runnable = s != "long_500k" or a in LONG_OK
            out.append((a, s, runnable))
    return out


def get_config(arch: str, *, smoke: bool = False):
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.smoke() if smoke else mod.full()
