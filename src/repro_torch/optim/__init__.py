"""Optimizers, in torch: AdamW and TreeNewton (K-FAC-style whitening whose
SPD solves run the paper's solver on batched kernels).

Counterpart of ``repro/optim``.
"""
from repro_torch.optim import adamw, kfac  # noqa: F401
from repro_torch.optim.adamw import AdamWConfig  # noqa: F401
from repro_torch.optim.kfac import TreeNewtonConfig  # noqa: F401
