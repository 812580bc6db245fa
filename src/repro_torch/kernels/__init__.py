"""Hand-written CUDA kernels for Hopper (sm_90a) + their plain versions.

Modules:
  ops.py    — dispatch by device (plain version on the CPU, kernel on
              CUDA) and the per-kernel launch counters
  ref.py    — plain PyTorch versions, the ground truth on both devices
  potrf.py  — potrf_leaf, tri_inv_leaf (csrc/potrf.cu, csrc/tri_inv.cu)
  qgemm.py  — mixed-precision GEMM (csrc/qgemm.cu)
  panel.py  — fused panel update of the blocked engine (csrc/panel.cu)
  residual.py — fused refinement residual b - A x (csrc/residual.cu)
  trsm.py   — the tree engine's leaf solve B L^-T via L^-1 (csrc/trsm.cu)
  syrk.py   — syrk_leaf, syrk_packed: lower-triangle C + A A^T
              (csrc/syrk.cu)
  flash.py  — flash_attention_bshd: causal GQA attention of the model
              zoo's prefill; bf16/f16 on the tensor cores
              (csrc/flash_tc.cuh, flash_tc_bf16.cu, flash_tc_f16.cu), f32
              on the CUDA cores (csrc/flash.cu)
  _build.py — nvcc build at first use, ctypes loading

Importing this package builds nothing: the kernels are compiled at their
first launch, on the machine that has the card.
"""
from repro_torch.kernels import ops, ref  # noqa: F401
