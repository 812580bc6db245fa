"""Structural census of the recursion tree (no tensors, shapes only).

Counterpart of ``repro/core/census.py``. It walks the tree engine's
recursion over ``cfg.split`` and counts, per precision level:
  * GEMM FLOPs (the tensor-core-eligible work the recursion exposes),
  * leaf FLOPs (POTRF / TRSM / SYRK leaves),
  * bytes touched per GEMM operand at its storage dtype.

:meth:`Census.model_time_s` turns the counts into a least time on the
card's peak rates (:data:`~repro_torch.core.precision.PEAK_FLOPS`, the
H100's): the sum over levels of FLOPs over that level's peak.
"""
from __future__ import annotations

import collections
import dataclasses

from repro_torch.core.dtypes import BYTES as _BYTES
from repro_torch.core.precision import PEAK_FLOPS, PrecisionConfig


@dataclasses.dataclass
class Census:
    gemm_flops: dict         # level name -> flops
    leaf_flops: dict         # level name -> flops
    gemm_bytes: dict         # level name -> bytes moved (operands + out)
    leaf_count: int = 0
    gemm_count: int = 0

    @property
    def total_flops(self):
        return sum(self.gemm_flops.values()) + sum(self.leaf_flops.values())

    @property
    def gemm_fraction(self):
        t = self.total_flops
        return sum(self.gemm_flops.values()) / t if t else 0.0

    def lowp_fraction(self, names=("f16", "bf16")):
        t = self.total_flops
        f = sum(v for k, v in self.gemm_flops.items() if k in names)
        return f / t if t else 0.0

    def model_time_s(self, peak=PEAK_FLOPS):
        """Throughput model: sum over levels of flops/peak(level)."""
        t = 0.0
        for k, v in self.gemm_flops.items():
            t += v / peak[k]
        for k, v in self.leaf_flops.items():
            t += v / peak[k]
        return t


def _new():
    return Census(gemm_flops=collections.defaultdict(float),
                  leaf_flops=collections.defaultdict(float),
                  gemm_bytes=collections.defaultdict(float))


def _gemm(c: Census, name: str, m, n, k):
    c.gemm_flops[name] += 2.0 * m * n * k
    c.gemm_bytes[name] += _BYTES[name] * (m * k + k * n) + 4 * m * n
    c.gemm_count += 1


def census_potrf(n: int, cfg: PrecisionConfig, c: Census | None = None,
                 level: int = 0) -> Census:
    c = c if c is not None else _new()
    if n <= cfg.leaf:
        c.leaf_flops[cfg.name_at(level)] += n ** 3 / 3.0
        c.leaf_count += 1
        return c
    n1 = cfg.split(n)
    n2 = n - n1
    census_potrf(n1, cfg, c, level + 1)
    census_trsm(n2, n1, cfg, c, level)
    census_syrk(n2, n1, cfg, c, level)
    census_potrf(n2, cfg, c, level + 1)
    return c


def census_trsm(m: int, n: int, cfg: PrecisionConfig,
                c: Census | None = None, level: int = 0) -> Census:
    c = c if c is not None else _new()
    if n <= cfg.leaf:
        c.leaf_flops[cfg.name_at(level)] += float(m) * n * n
        c.leaf_count += 1
        return c
    n1 = cfg.split(n)
    n2 = n - n1
    census_trsm(m, n1, cfg, c, level + 1)
    _gemm(c, cfg.name_at(level), m, n2, n1)
    census_trsm(m, n2, cfg, c, level + 1)
    return c


def census_syrk(n: int, k: int, cfg: PrecisionConfig,
                c: Census | None = None, level: int = 0) -> Census:
    c = c if c is not None else _new()
    if n <= cfg.leaf:
        c.leaf_flops[cfg.name_at(level)] += float(n) * n * k
        c.leaf_count += 1
        return c
    n1 = cfg.split(n)
    n2 = n - n1
    census_syrk(n1, k, cfg, c, level + 1)
    _gemm(c, cfg.name_at(level), n2, n1, k)
    census_syrk(n2, k, cfg, c, level + 1)
    return c
