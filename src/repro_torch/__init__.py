"""repro_torch — the PyTorch / CUDA port of the mixed-precision SPD solver.

A second package beside the JAX reference ``repro``, module for module
(``repro_torch/core/plan.py`` <-> ``repro/core/plan.py``, ...). It imports
torch, numpy and the standard library, never jax and never ``repro``.
Ported so far: the factorization and the solve of the default blocked
engine, iterative refinement (``refine_solve``) and solve serving
(``repro_torch.serve``), with five kernels; the tree engine and the rest
follow (ROADMAP.md, queue A).
"""
from repro_torch.core import (PAPER_CONFIGS, PrecisionConfig, RefineConfig,
                              RefineResult, build_plan, cholesky,
                              cholesky_padded, cholesky_solve, diag_tri_inv,
                              gmres_refine, iterative_refine, logdet,
                              pad_factor, pad_spd, refine_solve,
                              solve_factored)

__all__ = ["PAPER_CONFIGS", "PrecisionConfig", "RefineConfig",
           "RefineResult", "build_plan", "cholesky", "cholesky_padded",
           "cholesky_solve", "diag_tri_inv", "gmres_refine",
           "iterative_refine", "logdet", "pad_factor", "pad_spd",
           "refine_solve", "solve_factored"]
