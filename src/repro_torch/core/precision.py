"""Layered precision configuration (the paper's Fig. 2 ladder), in torch.

Counterpart of ``repro/core/precision.py``. A :class:`PrecisionConfig`
carries the per-recursion-level precision list: ``levels=("f16", "f16",
"f32")`` means recursion levels 0 and 1 compute their GEMMs in fp16 and
every deeper level (and all diagonal leaves) runs at f32. The last entry is
the highest precision.

The ``leaf % 128`` rule is kept although no GPU kernel needs it: it keeps
every plan identical to the reference's, tile for tile. The reference's
TPU peak-rate table has no counterpart here.
"""
from __future__ import annotations

import dataclasses

import torch

DTYPES = {
    "int8": torch.int8,
    "f16": torch.float16,
    "bf16": torch.bfloat16,
    "f32": torch.float32,
    "f64": torch.float64,
}

# Largest finite value of each format (quantization clamps into +-R_max).
RMAX = {
    "int8": 127.0,
    "f16": 65504.0,
    "bf16": 3.3895314e38,
    "f32": 3.4028235e38,
    "f64": 1.7976931e308,
}

# Formats whose dynamic range is narrow enough that the paper's per-block
# quantization is load-bearing; int8 is always scaled.
NARROW = frozenset({"f16", "int8"})


@dataclasses.dataclass(frozen=True)
class PrecisionConfig:
    """Precision ladder + tile geometry for the blocked solver."""

    levels: tuple[str, ...] = ("f32",)
    leaf: int = 256              # leaf tile size b (multiple of 128)
    quantize: bool = True        # per-block quant for NARROW dtypes
    storage_rounding: bool = True  # round updated blocks to their level dtype
    #: kept for field parity with the reference; the port dispatches on
    #: the tensor's device alone, so only None and "auto" are accepted
    kernel_impl: str | None = None
    #: "blocked" (default) or "tree"; "auto" raises at factor time
    engine: str = "blocked"

    def __post_init__(self):
        assert self.levels, "need at least one precision level"
        for lv in self.levels:
            assert lv in DTYPES, lv
        assert self.leaf % 128 == 0 and self.leaf > 0, self.leaf
        assert self.engine in ("tree", "blocked", "auto"), self.engine
        if self.kernel_impl not in (None, "auto"):
            raise ValueError(
                f"kernel_impl={self.kernel_impl!r}: the port picks the "
                "kernel by the tensor's device; only None or 'auto'")

    # -- ladder ------------------------------------------------------------
    def name_at(self, level: int) -> str:
        return self.levels[min(level, len(self.levels) - 1)]

    def dtype_at(self, level: int):
        return DTYPES[self.name_at(level)]

    @property
    def high_name(self) -> str:
        return self.levels[-1]

    @property
    def high_dtype(self):
        return DTYPES[self.high_name]

    def needs_quant(self, level: int) -> bool:
        name = self.name_at(level)
        if name == "int8":      # int8 is meaningless without its scale
            return True
        return self.quantize and name in NARROW

    # -- geometry ----------------------------------------------------------
    def split(self, n: int) -> int:
        """Leaf-aligned bisection point n1."""
        assert n > self.leaf
        return self.leaf * max(1, (n // self.leaf) // 2)

    def depth(self, n: int) -> int:
        """Recursion depth the POTRF tree reaches for size n."""
        d = 0
        while n > self.leaf:
            n -= self.split(n)
            d += 1
        return d

    def describe(self) -> str:
        return "[" + ", ".join(s.upper() for s in self.levels) + "]"


# Named configurations matching the paper's figures (same keys as the
# reference, so a ladder name means the same plan in both packages).
PAPER_CONFIGS = {
    "pure_f64": PrecisionConfig(levels=("f64",)),
    "pure_f32": PrecisionConfig(levels=("f32",)),
    "pure_f16": PrecisionConfig(levels=("f16",)),
    "f16_f32": PrecisionConfig(levels=("f16", "f32")),
    "f16x3_f32": PrecisionConfig(levels=("f16",) * 3 + ("f32",)),
    "f16x5_f32": PrecisionConfig(levels=("f16",) * 5 + ("f32",)),
    "f32x3_f64": PrecisionConfig(levels=("f32",) * 3 + ("f64",)),
    "bf16_f32": PrecisionConfig(levels=("bf16", "f32")),
    "bf16x3_f32": PrecisionConfig(levels=("bf16",) * 3 + ("f32",)),
    "int8_f32": PrecisionConfig(levels=("int8", "f32")),
    "int8x3_f32": PrecisionConfig(levels=("int8",) * 3 + ("f32",)),
}
