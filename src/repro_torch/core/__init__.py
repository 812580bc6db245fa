"""repro_torch.core — the mixed-precision factor and solve, in torch.

Public API of this slice of the port (counterparts in ``repro.core``):
  PrecisionConfig, PAPER_CONFIGS, DTYPES, NARROW, RMAX — precision ladders
  PrecisionPlan, ShardedPlan, TileInfo, build_plan, shard — static plan
  quant_block, dequant, storage_round, quant_int8, dequant_int8
  blocked_potrf, diag_tri_inv, blocked_trsm_left      — blocked engine
  cholesky, cholesky_padded, cholesky_solve, solve_factored, logdet
  refine_solve, RefineConfig, RefineResult, ...      — iterative refinement
  pad_spd, pad_factor
"""
from repro_torch.core.blocked import (blocked_potrf, blocked_trsm_left,
                                      diag_tri_inv)
from repro_torch.core.plan import (PrecisionPlan, ShardedPlan, TileInfo,
                                   build_plan, shard)
from repro_torch.core.precision import (DTYPES, NARROW, PAPER_CONFIGS, RMAX,
                                        PrecisionConfig)
from repro_torch.core.quantize import (dequant, dequant_int8, quant_block,
                                       quant_int8, storage_round)
from repro_torch.core.refine import (RefineConfig, RefineResult,
                                     gmres_refine, iterative_refine,
                                     refine_operator, refine_steps,
                                     scaled_solve)
from repro_torch.core.solve import (cholesky, cholesky_padded,
                                    cholesky_solve, logdet, refine_solve,
                                    solve_factored)
from repro_torch.core.tree import pad_factor, pad_spd

__all__ = [
    "DTYPES", "NARROW", "PAPER_CONFIGS", "RMAX", "PrecisionConfig",
    "PrecisionPlan", "ShardedPlan", "TileInfo", "build_plan", "shard",
    "blocked_potrf", "blocked_trsm_left", "diag_tri_inv",
    "dequant", "dequant_int8", "quant_block", "quant_int8", "storage_round",
    "RefineConfig", "RefineResult", "gmres_refine", "iterative_refine",
    "refine_operator", "refine_steps", "scaled_solve",
    "cholesky", "cholesky_padded", "cholesky_solve", "logdet",
    "refine_solve", "solve_factored", "pad_factor", "pad_spd",
]
