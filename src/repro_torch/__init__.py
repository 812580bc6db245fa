"""repro_torch — the PyTorch / CUDA port of the mixed-precision SPD solver.

A second package beside the JAX reference ``repro``, module for module
(``repro_torch/core/plan.py`` <-> ``repro/core/plan.py``, ...). It imports
torch, numpy and the standard library, never jax and never ``repro``.
Ported so far: the factorization and the solve of both engines, the
default blocked one and the paper's nested recursion (``engine="tree"``,
with the packed tree storage ``TreeSPD``), the census of the recursion
(``repro_torch.core.census``), the measured-search tuner and its
database (``repro_torch.tune``, ``engine="auto"``), iterative refinement
(``refine_solve``) and solve serving (``repro_torch.serve``, with its
mesh mode), the distributed factor and solve on ``torch.distributed``
(``repro_torch.core.distributed``, ranks started by
``repro_torch.launch``), the model zoo's dense, vlm, audio and moe
families (``repro_torch.configs``, ``repro_torch.models``) served by
``prefill_step``, ``serve_step`` and ``generate``, the dense one also
trained (``repro_torch.train``, with AdamW and TreeNewton from
``repro_torch.optim``), with nine kernels and batched entries of four of
them; the rest follows (ROADMAP.md, queue A).
"""
from repro_torch.core import (PAPER_CONFIGS, PrecisionConfig, RefineConfig,
                              RefineResult, TreeSPD, build_plan, cholesky,
                              cholesky_padded, cholesky_solve, diag_tri_inv,
                              distributed,
                              gmres_refine, iterative_refine, logdet,
                              pad_factor, pad_spd, refine_solve,
                              solve_factored, storage_ratio, tree_potrf,
                              tree_potrf_packed, tree_syrk, tree_trsm,
                              tree_trsm_left)
from repro_torch.serve import generate, prefill_step, serve_step

__all__ = ["PAPER_CONFIGS", "PrecisionConfig", "RefineConfig",
           "RefineResult", "TreeSPD", "build_plan", "cholesky",
           "cholesky_padded", "cholesky_solve", "diag_tri_inv",
           "distributed", "generate",
           "gmres_refine", "iterative_refine", "logdet", "pad_factor",
           "pad_spd", "prefill_step", "refine_solve", "serve_step",
           "solve_factored", "storage_ratio",
           "tree_potrf", "tree_potrf_packed", "tree_syrk", "tree_trsm",
           "tree_trsm_left"]
