"""The paper's recursive data structure (§III-B), as a plain torch class.

Counterpart of ``repro/core/treematrix.py``. ``TreeSPD`` stores a
symmetric matrix the way the paper's solver does: the diagonal recursion
ends in high-precision leaf tiles, and every off-diagonal panel is stored
*in its level's dtype* together with its per-block quantization scale (an
f32 0-d tensor), int8 included. This is the storage half of the paper's
claim: the dense-array API in ``core/solve.py`` reproduces the numerics
of low-precision storage through ``storage_rounding``, while this class
holds the actual bytes::

    [F16,F16,F32] at n=65536, leaf 256  =>  0.31x the bytes of dense f32
    [INT8,INT8,F32]                     =>  0.22x

The reference registers the class as a JAX pytree so that it can be
carried through ``jit``; PyTorch runs eagerly and needs no registration.
:func:`tree_potrf_packed` factorizes the packed form directly,
dequantizing a panel only inside its own TRSM/SYRK call.
"""
from __future__ import annotations

import torch

from repro_torch.core.precision import DTYPES, PrecisionConfig
from repro_torch.core.quantize import quant_block
from repro_torch.core.tree import tree_potrf, tree_syrk, tree_trsm


class TreeSPD:
    """``diag1``/``diag2``: a TreeSPD or a leaf tensor (high precision);
    ``off``: the (n - n1, n1) panel in its level's dtype; ``off_scale``:
    its f32 scale."""

    def __init__(self, diag1, off, off_scale, diag2, *, level, n1, n):
        self.diag1 = diag1
        self.off = off
        self.off_scale = off_scale
        self.diag2 = diag2
        self.level = level
        self.n1 = n1
        self.n = n

    # -- construction -------------------------------------------------------
    @classmethod
    def from_dense(cls, a, cfg: PrecisionConfig, *, level: int = 0):
        n = a.shape[-1]
        assert a.shape == (n, n) and n % cfg.leaf == 0, a.shape
        if n <= cfg.leaf:
            return a.to(cfg.high_dtype)         # leaf tile, high precision
        n1 = cfg.split(n)
        name = cfg.name_at(level)
        off_q, scale = quant_block(a[n1:, :n1].to(torch.float32), name,
                                   cfg.needs_quant(level) or name == "int8")
        return cls(
            cls.from_dense(a[:n1, :n1], cfg, level=level + 1),
            off_q, scale,
            cls.from_dense(a[n1:, n1:], cfg, level=level + 1),
            level=level, n1=n1, n=n)

    # -- back to dense ------------------------------------------------------
    def to_dense(self, dtype=torch.float32):
        out = torch.zeros((self.n, self.n), dtype=dtype,
                          device=self.off.device)
        self._fill(out)
        return out

    def _fill(self, out) -> None:
        n1 = self.n1
        for d, view in ((self.diag1, out[:n1, :n1]),
                        (self.diag2, out[n1:, n1:])):
            if isinstance(d, TreeSPD):
                d._fill(view)
            else:
                view.copy_(d)
        dt = out.dtype
        out[n1:, :n1] = self.off.to(dt) * self.off_scale.to(dt)

    # -- storage accounting (the paper's Fig. 2 memory story) ---------------
    def nbytes(self) -> int:
        b = self.off.element_size() * self.off.numel() + 4
        for d in (self.diag1, self.diag2):
            if isinstance(d, TreeSPD):
                b += d.nbytes()
            else:
                b += d.element_size() * d.numel()
        return b


def _dense(t):
    return t.to_dense() if isinstance(t, TreeSPD) else t.to(torch.float32)


def tree_potrf_packed(t, cfg: PrecisionConfig):
    """Factorize a packed TreeSPD; returns a packed lower factor.

    The recursion of Alg. 1, with each off-diagonal panel read from (and
    written back to) its low-precision storage: panels are dense only
    inside their own TRSM/SYRK calls.
    """
    if not isinstance(t, TreeSPD):
        return tree_potrf(t, cfg, level=0)      # leaf tile
    level = t.level
    name = cfg.name_at(level)
    l11 = tree_potrf_packed(t.diag1, cfg)
    a21 = t.off.to(torch.float32) * t.off_scale.to(torch.float32)
    l21 = tree_trsm(a21, _dense(l11), cfg, level=level)
    a22 = tree_syrk(_dense(t.diag2), l21, alpha=-1.0, beta=1.0, cfg=cfg,
                    level=level)
    l22 = tree_potrf_packed(TreeSPD.from_dense(a22, cfg, level=level + 1)
                            if a22.shape[-1] > cfg.leaf else a22, cfg)
    l21_q, s = quant_block(l21, name,
                           cfg.needs_quant(level) or name == "int8")
    return TreeSPD(l11, l21_q, s, l22, level=level, n1=t.n1, n=t.n)


def storage_ratio(n: int, cfg: PrecisionConfig) -> float:
    """bytes(TreeSPD under cfg) / bytes(dense f32 n x n), from the shape
    alone."""
    def rec(n, level):
        if n <= cfg.leaf:
            return n * n * cfg.high_dtype.itemsize
        n1 = cfg.split(n)
        off = (n - n1) * n1 * DTYPES[cfg.name_at(level)].itemsize
        return off + rec(n1, level + 1) + rec(n - n1, level + 1)

    return rec(n, 0) / (n * n * 4)
