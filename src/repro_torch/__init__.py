"""repro_torch — the PyTorch / CUDA port of the mixed-precision SPD solver.

A second package beside the JAX reference ``repro``, module for module
(``repro_torch/core/plan.py`` <-> ``repro/core/plan.py``, ...). It imports
torch, numpy and the standard library, never jax and never ``repro``.
This slice ports the factorization and the solve of the default blocked
engine with its four kernels; refinement, serving and the rest follow
(ROADMAP.md, queue A).
"""
from repro_torch.core import (PAPER_CONFIGS, PrecisionConfig, build_plan,
                              cholesky, cholesky_padded, cholesky_solve,
                              diag_tri_inv, logdet, pad_factor, pad_spd,
                              solve_factored)

__all__ = ["PAPER_CONFIGS", "PrecisionConfig", "build_plan", "cholesky",
           "cholesky_padded", "cholesky_solve", "diag_tri_inv", "logdet",
           "pad_factor", "pad_spd", "solve_factored"]
