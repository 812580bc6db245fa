#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check every kernel.

    python3 chip_smoke.py            # one card; no arguments

Run from the root of a checkout. The kernels are built from
``src/repro_torch/kernels/csrc`` at first use. Every phase prints one JSON
line; a failing check raises, and the script exits non-zero with no
result line. Phases:

1. ``env``: the card (``nvidia-smi``), torch and CUDA versions, build time.
2. ``kernel``: each of the nine kernels against its plain PyTorch version
   (``flash_attention`` on both of its routes: the tensor-core kernel for
   bf16 and f16, the SIMT one for f32) on the card, for every operand type
   and rounding variant, at the
   shapes of tests/test_kernels.py and at the main paths' shapes (leaf
   b = 256, the first diagonal tile of the n = 16384 matrix, panel
   heights m = 256 .. n - 256 (``panel_update`` also at leaf 384, where
   every pair takes the CUDA cores, and timed at panels 0, 31 and 61 of
   the f16x3_f32 factor with its pairs by route, ``ops.PANEL_ROUTES``,
   beside the bound of each pair's products at its name's rate), the
   residual at n = 16384 with 16 columns and with one;
   the tree engine's leaves: ``trsm_leaf`` (B's rows on the 16-byte grid
   and off it, f32 and f64) at every M the tree factor gives it (256 ..
   8192 at leaf 256), each timed with its plan (``ops.TRSM_ROUTES``) beside
   the launch's floor, and 32 times their sum set beside the tree factor's
   profiled ``trsm_leaf`` time in the ``breakdown`` line;
   ``syrk_leaf`` with k = 256 and 8192 in every level type,
   ``syrk_packed`` in every type pair (f32, bf16, f16, int8, f32 with an
   f64 C, f64) at n = k = 8192 and at ragged shapes, each on the route its
   plan gives (``ops.SYRK_PACKED_ROUTES``: the tensor cores for bf16, f16
   and int8, staged where A's rows are off the 16-byte grid; the CUDA cores
   for the rest), int8 bitwise against its exact sums' epilogue and the f32
   sums bitwise ``qgemm``'s;
   ``flash_attention`` at tests/test_flash.py's shapes in f32, bf16 and
   f16, every head dim 16 .. 256 (80 included), S != T and a full call,
   a strided 16-bit view and two refused ones, and at every
   prefill shape of phase 8: gemma-2b's 4 x 2048, 1 x 8192 and 4 x 1023
   (H = 8, KV = 1, hd = 256, bf16) and 2 x 256 .. 263 (f32),
   nemotron-4-15b's 1 x 4096 and 1 x 1023 (H = 48, KV = 8, hd = 128),
   and hd = 192; the vlm, audio and moe phases' (MLA's H = KV = 16 and
   128 at hd 192, pixtral's H 32, KV 8, hd 128, musicgen's H = KV = 32,
   hd 64; their contracts' length 1023, the f32 runs' 2 x 256 .. 263,
   the smoke configs' 2 x 48), the four timed beside SDPA, and zamba2's
   hd 80 (H = KV = 32) at 4 x 2048 in bf16, f16 and f32, timed, and at
   its contract's and f32 runs' lengths; each case
   against the derived worst-case atol and a
   data-scaled one, 256 u max|v|, and each 16-bit case to a share of
   rounded outputs that differ from the plain version's, which a one-pass
   p (tests/test_torch_flash.py's emulation, run here) exceeds); times
   of the kernel, the plain version and the one PyTorch call computing the
   same function (where there is one), beside the card's least time for that
   work. ``residual_fused`` is also checked for column independence,
   bitwise, and the triangular decode the kernels run against integer
   arithmetic. ``qgemm`` on each of its routes (``ops.QGEMM_ROUTES``: the
   tensor cores for f16, bf16 and int8, direct or after staging an
   operand K-major; the CUDA cores' k-split, tile and narrow routes for
   f32 and f64) at the tree factor's top shapes, with MN-major operands,
   N = 1 and 7 and ragged shapes: int8 bitwise, the rest at the
   data-scaled gamma tolerance; a repeat, and each column against the
   full product for N in {1, 7, 16, 48} at shuffled positions, bitwise;
   the scale read from the card and out = c. Every kernel's ``ms`` and
   ``library_ms`` are CUDA events around calls from Python; ``qgemm`` and
   ``syrk_leaf`` also give ``graph_ms`` and ``library_graph_ms``, the same
   launches back to back in one CUDA graph, since their wrappers' host
   time between calls is as long as a sweep-sized kernel. ``potrf_leaf``
   and ``tri_inv_leaf`` run at b = 128, 256,
   384 and 512 in f32 and 256 in f64 (both of their routes: the triangle
   in shared memory, the tile starting in global memory), a repeated
   call must give the same bits, and they are timed in f32 and f64
   beside one SM's share of the card's rate; ``potrf_leaf`` also on a
   strided view and in place, against ``cholesky_ex`` (no host sync) and
   ``cholesky``;
   ``tri_inv_leaf``'s batched entry on the 64 diagonal tiles of an
   n = 16384 factor, read in place: each tile bitwise equal to a single
   launch, a NaN tile leaving its neighbours' bits alone, timed against 64
   single launches and one batched ``solve_triangular``.
   ``kfac_batched``: the batched entries K-FAC runs (the Pallas kernels
   under jax.vmap) at gemma-2b's K-FAC shapes (1008 blocks of 512 at leaf
   128, bf16_f32, at scales 1e-3 .. 1e3 a block): ``potrf_leaf`` and
   ``tri_inv_leaf`` on the 1008 first diagonal tiles, ``panel_update`` at
   the refactor's panels 0, 1 and 2, ``qgemm`` at the whitening's three
   calls (level 0 bf16, level 1 f32, a leaf) for dout 256, 2048 and
   16384; every element of every batched call bitwise the one-matrix
   launch on it, the batch within tolerance of the batched plain version,
   timed beside one launch's time N times and a library call on the batch
   (``cholesky_ex``, ``solve_triangular``, ``baddbmm``). Then TreeNewton's
   own solves on statistics far from diagonal (G G^T / 2n, condition ~35):
   ``kfac._refactor`` of all 1008 blocks and ``kfac._whiten_group`` of
   each dout group (both sweeps, the graft) on the card against the CPU's
   plain path on sampled matrices, bf16_f32 and int8_f32, within
   ``KFAC_SOLVE_TOL``, which a transposed inverse or an MN-major operand
   read K-major exceeds.
3. ``path``: the blocked engine's main path, ``cholesky_solve`` with 16
   right-hand sides and with one vector, at n = 16384 on the paper's
   §IV-A matrix, for the ladders pure_f32, bf16_f32, f16x3_f32 and
   int8_f32; factor and solve times, peak memory, the residual
   ||b - A x|| / ||b|| in f64 and each kernel's launch count, which must
   match the schedule, and ``panel_update``'s pairs by route, which must
   match the plan's names (every f16, bf16 and int8 pair of an f32
   container on the tensor cores, every other pair on the CUDA cores) (``diag_tri_inv`` is one ``tri_inv_leaf`` launch for
   its 64 tiles; ``ops.TILES`` must count them). Then bf16_f32 at
   n = 32768 and f32x3_f64 at n = 4096.
4. ``tree_path``: the same for ``engine="tree"`` (the paper's nested
   recursion), whose launches must match the schedule counted from the
   recursion and ``cfg.split``; each ladder's tree factor must lie within
   ``TOL[levels[0]]`` of the blocked factor of the same matrix; f32x3_f64
   at n = 4096; the packed storage (``TreeSPD``, ``tree_potrf_packed``)
   at n = 16384 for f16x3_f32 and int8_f32: its bytes against
   ``storage_ratio`` and its factor against the dense tree factor.
   ``tree_stacks``: ``tree_potrf`` of a stack of 64 SPD blocks of 512 at
   leaf 128 (TreeNewton's refactor with ``engine="tree"``), pure_f32 and
   bf16_f32: its launches against ``tree_stack_schedule`` (a batched
   launch a potrf leaf and a node GEMM, ``trsm_leaf``/``syrk_leaf`` once
   a matrix), every block against its 2-D factor (within ``TOL``; how
   many bitwise) and two blocks against the plain version; its time and
   the 64 2-D factors'. Then ``syrk_race``: the paper's Fig. 4 race at the factor's top-level
   trailing update (8192 x 8192, k = 8192), tree-SYRK against the flat
   ``syrk_packed`` called through ``ops.syrk(packed=True)``.
5. ``refine``: ``refine_solve`` with 16 right-hand sides at n = 16384,
   at most 10 sweeps: classic IR with f64 residuals to 1e-10 for the four
   ladders and for bf16_f32 on the tree engine (every column must
   converge, >= 10 digits in f64), GMRES-IR once and IR with the default
   f32 residual once (bf16_f32; never worse than the unrefined solve);
   sweeps, digits before and after, wall and sweep ms, and launch counts
   checked against the sweep schedule.
6. ``serve``: ``SolverEngine("bf16_f32", residual_dtype="f64")`` at
   n = 16384 answers 48 single-column requests (targets 6, 8, 10, 12
   digits) through a continuous ``BatchScheduler`` (16 slots) and through
   a windowed drain; requests/s of each with the factor excluded, sweeps,
   convergence, cache hits, the card's busy share, and the two modes
   compared request for request.
   ``tune``: the committed tuning database of the card
   (``src/repro_torch/tune/data/cuda.json``), loaded with warnings as
   errors, must be valid, consulted as it says and the one
   ``engine="auto"`` reads; each ladder's engine crossover is printed. A
   smoke search (``autotune(smoke=True)``, bf16_f32, the real timer) must
   give a valid payload. ``cholesky_solve`` with ``engine="auto"`` for
   bf16_f32 and f16x3_f32 at n = 1024 and 16384 must run the engine the
   database names (read from the launches) and give its explicit run's x
   bitwise, at 16384 with that engine's digits floor. ``SolverEngine``
   with an ``engine="auto"`` bf16_f32 ladder and the database refines 16
   columns at n = 16384 to 1e-10 (f64 residuals), and ``BatchScheduler``
   takes the database's ``max_batch``. bf16_f32's engine race is run again
   at the two grid sizes around its committed crossover and printed beside
   the committed pick (no gate). ``dist``: the distributed path on 4 ranks
   (``repro_torch.launch.launch``: 4 processes sharing the card, their
   collectives through gloo and host memory; not a 4-GPU node, and NCCL
   is not used), driven by ``repro_torch.launch.drive``: first the check
   that gloo moves CUDA tensors of every dtype through ``all_gather``,
   ``broadcast`` and ``scatter`` (values and device), with the host
   seconds of a 64 MiB f32 all-gather; ``dist_cholesky``
   at n = 16384 (leaf 256, 16 tile rows a rank) for bf16_f32, f16x3_f32,
   int8_f32 and pure_f32, the tree local engine for f16x3_f32 at 8192, the
   four ``broadcast_diag_only`` x ``compress_comm`` schedules for f16_f32
   at leaf 128, n = 4096, each on the paper's matrix with sqrt(n) on the
   diagonal (so that the trailing updates move the factor's entries below
   the diagonal by a sizable share); each factor finite, within ``TOL``
   of the single-device factor of its engine relative to max|L|, and its
   entries below the diagonal within ``DIST_LOWER_TOL`` relative to their
   own max (set from the card's readings; a copy that leaves out the
   trailing updates gave 0.55 to 0.61 there on the CPU at n = 2048), its
   upper triangle zero, each rank's
   bytes by collective and dtype as ``ShardedPlan.comm_name`` /
   ``comm_quant`` prescribe (``repro_torch.audit.conformance
   .wire_expectation``), each blocked rank's launches as the schedule
   and its 16-bit and int8 trailing updates on the ``tc`` route;
   ``dist_cholesky_solve`` with 16 right-hand sides for bf16_f32,
   f16x3_f32 and int8_f32, its digits within 0.3 of the single-device
   solve's; mesh-mode ``SolverEngine("bf16_f32",
   residual_dtype="f64")`` with rank 0 leading a ``BatchScheduler``: 8
   requests at n = 16384 (targets 6 .. 12 digits; the later wave on the
   cached sharded factor), one at 1024 below the threshold (local), each
   on target within 10 sweeps and x bitwise ``engine.solve``'s; then a
   request that rank 1 fails, which must come back as ``MeshCallError``
   naming rank 1, and after it one on a matrix that differs from the
   cached one off the fingerprint's samples, which must reuse the factor
   and reach its target against its own matrix; a matrix of the wrong
   shape refused on rank 0; every follower through the same calls; a smoke
   run of the tuner's distributed grid, printed only. ``generate_mesh``
   (after ``dist``): model serving under a (2, 2) ``data x model`` mesh of
   4 ranks sharing the card, layout ``tp`` (``drive.run_mesh_cases``;
   DTensor's collectives staged through host memory by
   ``launch/hostwire.py``): gemma-2b and deepseek-v2-lite at f32 and 2
   layers, 4 x 256 + 4 (the MoE dropless at EP = 2), whose prefill and
   first decode logits must lie within ``MESH_LOGIT_RTOL`` of the
   single-card port's on each rank and whose greedy tokens (serve steps
   and ``generate``) must equal its, teacher-forced; the expert-parallel
   MoE of deepseek-v2-lite's full width on 512 f32 tokens against
   ``moe_ffn_dense_reference`` within ``_moe_tol``, finite at capacity
   1.0; gemma-2b full (bf16, 4 x 1024 + 8) and deepseek-v2-lite cut to 4
   of 27 layers (4 x 1024 + 4), each rank's prefill ms, decode ms a step,
   peak GiB, bytes by collective, and flash launches a prefill equal to
   the attention layers; every parameter and cache shard the shape its
   rule gives. ``census``: the tree
   census of each ladder at n = 16384 (GEMM and leaf FLOPs by type, the low-precision
   share, its model time on ``PEAK_FLOPS``) and the blocked plan's dot
   FLOPs, beside the ``path`` and ``tree_path`` lines' ``factor_ms``;
   ``PEAK_FLOPS`` must equal the card's rates on an SXM card.
   ``audit``: the precision-conformance audit (``repro_torch.audit``) of
   the card's launches: one blocked factor at n = 16384 for pure_f32,
   bf16_f32, f16x3_f32 and int8_f32, whose products' FLOPs by name, from
   the names each ``panel_update`` launch was given, must equal the plan's
   exactly, every 16-bit and int8 pair of the f32 container on the tensor
   cores and every other pair on the CUDA cores, panel by panel, and the
   leaves in f32; bf16_f32's two solve sweeps (every ``qgemm`` in f32 on a
   ``simt_*`` route) and two refinement sweeps (every ``residual_fused``
   in f64). All of it under torch.profiler with one small call of each
   other kernel, for the resource table: one row a compiled kernel
   (``cuobjdump --dump-resource-usage``: static shared memory,
   registers, local memory; the library's own list, ``smem_table``: the
   dynamic shared memory its launcher passes; CUPTI: the launches' shared
   memory, which must be the table's), every compiled kernel within
   232,448 B and 255 registers, launched or not. Then the sources' static
   checks (accumulator types, the launch plans' index bounds) and the two
   card-route mutants, which must be caught through the route counts:
   one 16-bit pair sent to the f32 name (named by its tile), and one
   16-bit pair's work dispatched to the CUDA cores under its pristine
   name (named by its panel, the name checks silent); the phase's wall
   seconds and the seconds of each of its parts.
7. ``breakdown``: device time by kernel inside one factor and one
   16-column solve of f16x3_f32 at n = 16384, blocked and tree
   (torch.profiler), and the card's busy share of the wall time; every
   profiled window must book a device event for each port launch that
   ``ops.LAUNCHES`` counted in it; beside them the vendor's f32 and
   f64 Cholesky, ``torch.linalg.cholesky_ex``, of the same matrix (the
   paper's baseline; a yardstick, not a gate). ``tree_qgemm_shapes``
   (f16x3_f32 and int8_f32): the tree factor's ``qgemm`` calls by shape,
   operand types and route, ranked by device time, every 16-bit and int8
   call required on the tensor cores, the top two timed against
   ``torch.addmm`` unless the ``qgemm`` kernel line's ``tree_shapes``
   times them already. ``factor_probe``: the
   blocked f16x3_f32 factor at n = 16384 timed three times before the
   kernel phases and again after them (the kernel phases capture CUDA
   graphs), with the card's clock and power read beside it.
8. ``generate``: gemma-2b at full width and depth (18 layers, bf16,
   random weights drawn on the card from a seed) serves 4 prompts of 2048
   tokens with 32 new tokens each, greedy, and 1 prompt of 8192 tokens
   (its max_seq) with 8; per request batch prefill ms, decode ms per step
   (median), tokens/s, peak GiB and the flash launches, which must equal
   n_layers per prefill, all on the route of the model's dtype (flash_tc
   for bf16, the SIMT kernel for f32); then the reference's
   decode-vs-prefill contract
   (tests/test_archs.py:55-77) at 4 x 1024 within a stated bf16
   tolerance. ``generate_gqa``: nemotron-4-15b at full width with 2 of its
   32 layers (the GQA path, KV = 8, G = 6, hd = 128, and the relu2 MLP),
   1 prompt of 4096 tokens with 8 new ones, and its contract at 1 x 1024.
   After the bf16_f32 path at n = 32768 (phase 7), the vlm, audio and
   moe families at full width, bf16, random weights: ``generate_moe``,
   deepseek-v2-lite-16b uncut (27 layers: 1 dense + 26 MoE with MLA),
   4 x 2048 with 32 new tokens (profiled: device ms by kernel, the
   expert loop's products apart as the ``moe_expert_loop`` range), its
   contract at 4 x 1024 (the prefix's prefill and the decode step
   replay the full prefill's experts; the flips their own routers would
   have made are counted by MoE layer), and ``moe_oracle``: layer 0's
   routed experts against the dense per-expert oracle, f32 and bf16 on
   512 rows and bf16 on decode's 4, within a derived bound, routing
   equal, two runs bitwise, bf16 under the served cuBLAS setting and
   bitwise equal to f32 sums; ``generate_moe_v3``: deepseek-v3-671b at full width cut to
   4 of 61 layers (its 3 dense + 1 MoE), 1 x 4096 with 8, and its
   contract at 1 x 1024; ``generate_vlm``: pixtral-12b uncut (40
   layers), 2 x 4096 whose first 256 positions are random patch
   embeddings, 16 new tokens, contract at 2 x 1024; ``generate_audio``:
   musicgen-large uncut (48 layers), 4 x 2048 frames of 4 codebooks, 32
   new frames, contract at 4 x 1024. Each prefill launches flash n_layers
   times on flash_tc. Then the recurrent families, uncut, bf16, their
   zero-initialised leaves drawn nonzero: ``generate_rwkv``: rwkv6-3b
   (32 layers), 4 x 1024 with 32 new tokens, no flash launch (no kernel
   of the repository is on its path), contract at 4 x 1024;
   ``generate_hybrid``: zamba2-2.7b (54 Mamba-2 blocks and the shared
   attention block 6 times, hd 80), 4 x 2048 with 32, flash 6 times a
   prefill on flash_tc, and its contract as 128 teacher-forced steps
   after a prefix of 896 (the SSD's and attention's length rules refuse
   1023), every step against the prefill of 1024. ``token_exact_f32``:
   gemma-2b, pixtral-12b, musicgen-large, deepseek-v2-lite-16b, rwkv6-3b
   and zamba2-2.7b at full width with 2 layers in f32 (2 x 256; pixtral
   2 x 512, text after its 256 patch positions; zamba2 2 x 120 and its
   contract 128 + 128): generate equals teacher-forced greedy over 8
   tokens (tests/test_serve.py:14-41), and the contract at 5e-4.
   ``model_cpu_agreement``: prefill logits of the smoke configs of
   gemma-2b, granite-34b, nemotron-4-15b, pixtral-12b, musicgen-large,
   deepseek-v2-lite-16b, deepseek-v3-671b (the two at nope_head_dim 48:
   the flash kernels have no head dim 48), rwkv6-3b and zamba2-2.7b on
   the card against the port on the CPU.
9. ``cpu_agreement``: each ladder's factor on the card against the same
   port run on the CPU at n = 2048, both engines.
10. ``train``: gemma-2b full (18 layers, d 2048, d_ff 16384, vocab 256000,
   bf16, remat, random weights) on one batch of 2 x 2048 tokens: 4 AdamW
   steps, then 4 TreeNewton steps from the same weights (block 512, leaf
   128, bf16_f32, a refactor every second step); every loss finite and the
   last below the first for each optimizer, flash launches 2 n_layers a
   step (the forward and remat's recompute), each TreeNewton step's
   solver launches equal to the grouped schedule (``kfac_schedule``), the
   last factors within 4e-2 of their damped statistics (each block's
   largest entry); step ms, tokens/s, peak GiB, one profiled step of each
   optimizer, the refactor and each whitening group timed alone.
   ``train_depth``: a 2-layer copy's solver launches per step equal the
   18-layer run's. ``train_cpu_agreement``: one step of each optimizer on
   the card against the CPU (a 2-layer, d 256, f32 config), and one AdamW
   step of each other family's smoke config at 2 layers. ``train_dp``:
   the reference's mini data-parallel trainer with the int8 error-feedback
   all-reduce as 4 ranks sharing the card over gloo, to its bound.
11. ``train_driver``: ``repro_torch.launch.train.main`` on gemma-2b full,
   AdamW, 2 x 2048, 5 steps: a run that saves at step 3 (under the
   git-ignored ``build/``; one save, as the card's machine takes 45 GiB
   of disk writes a call), an uninterrupted run, and a resume of the
   step-3 checkpoint to step 5; the checkpoint restores bitwise the
   state it saved (checked before the next step), and the resumed run's
   parameters are no further from the uninterrupted run's than two
   uninterrupted runs are from each other; the driver's step ms, each
   save's blocking seconds, the writer's seconds, the checkpoint's GiB
   and the restore's seconds. ``train_families``: 3 AdamW steps of
   rwkv6-3b (2 x 512), zamba2-2.7b and musicgen-large at full size, and
   of deepseek-v2-lite-16b and pixtral-12b cut in depth (``FAMILY_RUNS``,
   2 x 1024), then 3 TreeNewton steps of the cut deepseek-v2-lite: losses
   finite and falling, flash launches per step, the TreeNewton launches
   against the schedule, no MoE expert stack whitened; step ms and peak
   GiB of each.

Then the ``{"kernels": [...]}`` line, the card's name and power limit as
nvidia-smi prints them, and last ``{"ok": true, "device": {...}}``. A
``*_batched`` entry's launches are its kernel's launches over a stack
(``ops.BATCHED``); the kernel's own entry counts the launches that took
one matrix, so the entries add up to the launches.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib.util
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: the CUDA sources and the Pallas kernels they replace
KERNELS = {
    "potrf_leaf": ("src/repro_torch/kernels/csrc/potrf.cu",
                   "src/repro/kernels/potrf.py:96"),
    "tri_inv_leaf": ("src/repro_torch/kernels/csrc/tri_inv.cu",
                     "src/repro/kernels/potrf.py:137"),
    "qgemm": ("src/repro_torch/kernels/csrc/qgemm.cu",
              "src/repro/kernels/qgemm.py:83"),
    "panel_update": ("src/repro_torch/kernels/csrc/panel.cu",
                     "src/repro/kernels/panel.py:129"),
    "residual_fused": ("src/repro_torch/kernels/csrc/residual.cu",
                       "src/repro/kernels/residual.py:58"),
    "trsm_leaf": ("src/repro_torch/kernels/csrc/trsm.cu",
                  "src/repro/kernels/trsm.py:33"),
    "syrk_leaf": ("src/repro_torch/kernels/csrc/syrk.cu",
                  "src/repro/kernels/syrk.py:68"),
    "syrk_packed": ("src/repro_torch/kernels/csrc/syrk.cu",
                    "src/repro/kernels/syrk.py:137"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_tc.cuh",
                        "src/repro/kernels/flash.py:75"),
    "flash_attention_f32": ("src/repro_torch/kernels/csrc/flash.cu",
                            "src/repro/kernels/flash.py:75"),
    # the batched entries K-FAC runs (the Pallas kernels under jax.vmap):
    # the same kernels, one launch over the batch
    "potrf_leaf_batched": ("src/repro_torch/kernels/csrc/potrf.cu",
                           "src/repro/kernels/potrf.py:96"),
    "tri_inv_leaf_batched": ("src/repro_torch/kernels/csrc/tri_inv.cu",
                             "src/repro/kernels/potrf.py:137"),
    "panel_update_batched": ("src/repro_torch/kernels/csrc/panel.cu",
                             "src/repro/kernels/panel.py:129"),
    "qgemm_batched": ("src/repro_torch/kernels/csrc/qgemm.cu",
                      "src/repro/kernels/qgemm.py:83"),
}
#: the launches of each entry of KERNELS: ops.LAUNCHES by name, except the
#: two routes of flash_attention (one kernel there), which ops.FLASH_ROUTES
#: splits by flash.route of a dtype each takes: "flash_attention" here is
#: the bf16/f16 route
FLASH_DTYPE = {"flash_attention": torch.bfloat16,
               "flash_attention_f32": torch.float32}


def flash_launches(dtype) -> int:
    """flash_attention launches so far on the route of dtype."""
    from repro_torch.kernels import flash, ops
    return ops.FLASH_ROUTES[flash.route(dtype)]


def route_counts() -> dict:
    """The launches of each routed kernel by route since the last
    ``ops.reset_launches()``."""
    from repro_torch.kernels import ops
    return {"qgemm": dict(ops.QGEMM_ROUTES), "panel": dict(ops.PANEL_ROUTES),
            "syrk_packed": dict(ops.SYRK_PACKED_ROUTES),
            "trsm_leaf": dict(ops.TRSM_ROUTES),
            "flash_attention": dict(ops.FLASH_ROUTES)}


def launch_counts() -> dict:
    """The launch counts of every entry of KERNELS since the last
    ``ops.reset_launches()`` (:func:`split_launches`)."""
    from repro_torch.kernels import ops
    return split_launches(ops.LAUNCHES, ops.BATCHED, ops.FLASH_ROUTES)


def split_launches(launches, batched, flash_routes=None) -> dict:
    """Launch counts by entry of KERNELS from ops' counters: a batched
    entry has its kernel's ops.BATCHED count, and the kernel's own entry
    the launches that took one matrix (ops.LAUNCHES less ops.BATCHED), so
    that the entries add up to the launches; flash_attention's two routes
    as FLASH_DTYPE says (none without ``flash_routes``)."""
    from repro_torch.kernels import flash

    def count(name):
        if name in FLASH_DTYPE:
            return (flash_routes[flash.route(FLASH_DTYPE[name])]
                    if flash_routes else 0)
        if name in BATCHED_OF:
            return batched[BATCHED_OF[name]]
        return launches[name] - batched.get(name, 0)
    return {name: count(name) for name in KERNELS}


#: the kernels each driven path must launch
PATH_KERNELS = ("potrf_leaf", "tri_inv_leaf", "qgemm", "panel_update")
TREE_KERNELS = ("potrf_leaf", "tri_inv_leaf", "qgemm", "trsm_leaf",
                "syrk_leaf")
REFINE_KERNELS = PATH_KERNELS + ("residual_fused", "trsm_leaf", "syrk_leaf")
SERVE_KERNELS = PATH_KERNELS + ("residual_fused",)
#: factor-agreement tolerance by the ladder's coarsest level
#: (tests/test_blocked.py:_TOL)
TOL = {"f16": 5e-3, "bf16": 4e-2, "int8": 4e-2, "f32": 5e-6, "f64": 1e-12}
#: digits floor of ||b - Ax|| / ||b|| per ladder without refinement: the
#: digits this script measured on an H100 SXM (identical in every run:
#: pure_f32 6.01, bf16_f32 5.31 at n = 16384 and 5.41 at 32768, f16x3_f32
#: 5.57, int8_f32 4.85, f32x3_f64 9.50 at n = 4096) less 0.3 digits
DIGITS_FLOOR = {"pure_f32": 5.7, "bf16_f32": 5.0, "f16x3_f32": 5.3,
                "int8_f32": 4.5, "f32x3_f64": 9.2}
#: the same for engine="tree", whose solve sweeps run their top-level
#: GEMMs in the ladder's narrow type (the reference's Alg. 2 left form),
#: so they keep fewer digits than the blocked engine's high-precision
#: ones: measured on an H100 SXM (pure_f32 6.50, bf16_f32 2.78, f16x3_f32
#: 3.44, int8_f32 1.98 at n = 16384, f32x3_f64 7.36 at n = 4096) less 0.3
TREE_DIGITS_FLOOR = {"pure_f32": 6.2, "bf16_f32": 2.4, "f16x3_f32": 3.1,
                     "int8_f32": 1.6, "f32x3_f64": 7.0}
#: main-path size: the order of A and the n of the main-path kernel shapes
N_MAIN = 16384
#: one unit of a level's grid, relative to the tile's scale
GRID = {"int8": 1 / 127, "f16": 2.0 ** -10, "bf16": 2.0 ** -7, "f32": 1e-5,
        "f64": 1e-12}


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line on stdout; on stderr, the seconds since the script
    started and the line's phase (where the time of a run went)."""
    print(json.dumps(obj), flush=True)
    print(f"[{time.perf_counter() - _T0:8.1f} s] {obj.get('phase', '')} "
          f"{obj.get('name', obj.get('arch', ''))}", file=sys.stderr,
          flush=True)


def card_rates(name: str) -> dict:
    """Data-sheet peaks of the card (dense; CUDA cores for f32, the tensor
    cores for f64 (DMMA, twice the CUDA cores' f64 rate), bf16 (and f16)
    and int8)."""
    if "PCIe" in name:
        return {"f32": 51e12, "f64": 51e12, "bf16": 756e12, "int8": 1513e12,
                "bytes": 2.0e12}
    return {"f32": 67e12, "f64": 67e12, "bf16": 989e12, "int8": 1979e12,
            "bytes": 3.35e12}


def bound_ms(flops: float, nbytes: float, kind: str, rates: dict):
    """Least time for the work: the larger of bytes over the memory rate
    and operations over the peak rate of their type."""
    t_ops = flops / rates[kind] * 1e3
    t_bytes = nbytes / rates["bytes"] * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def cuda_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Mean device time of fn() over reps launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn() over reps launches captured in one CUDA
    graph and replayed: the time of the kernels back to back, without the
    host's time between calls (a port wrapper spends tens of microseconds
    of Python per call, as long as a sweep-sized kernel takes)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / reps
    del graph
    return ms


def check_close(what, got, want, rtol, atol):
    """max |got - want| and a raise if any element is outside
    atol + rtol * |want|; NaN must match NaN."""
    got, want = got.double(), want.double()
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    if not torch.equal(nan_g, nan_w):
        raise AssertionError(f"{what}: NaN pattern differs")
    diff = (got - want).abs().nan_to_num(0.0)
    err = float(diff.max()) if diff.numel() else 0.0
    lim = atol + rtol * want.abs().nan_to_num(0.0)
    if bool((diff > lim).any()):
        raise AssertionError(f"{what}: max abs err {err:g} over tolerance "
                             f"(rtol {rtol:g}, atol {atol:g})")
    return err


def spd_tile(n, gen, dtype=torch.float32):
    m = torch.randn((n, n), generator=gen, device="cuda", dtype=dtype)
    return m @ m.T + n * torch.eye(n, device="cuda", dtype=dtype)


def paper_matrix(n, seed, dtype=torch.float32):
    """Paper §IV-A (benchmarks/util.py:spd_matrix): symmetric uniform(-1, 1)
    entries, +n on the diagonal; built on the card (the dist phase's ranks
    build theirs with the same generator)."""
    from repro_torch.launch.drive import spd_matrix
    return spd_matrix(n, seed, dtype, "cuda")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def check_scaled(what, got, want, rtol, scale):
    """check_close with atol = scale * max|want|: the tolerance follows the
    size of the result, so that an entry far below the largest one (the
    off-diagonal of a strongly diagonal factor) is still checked."""
    atol = scale * float(want.double().abs().nan_to_num(0.0).max())
    return check_close(what, got, want, rtol, atol), atol


def main_tile(b, n, seed):
    """The first diagonal tile of paper_matrix(n): what the main path's
    first potrf_leaf call is fed (diagonal about n)."""
    tile = paper_matrix(b, seed)
    tile.diagonal().add_(n - b)
    return tile


def leaf_bytes(b, esz):
    """Bytes a leaf kernel must move: the input's lower triangle read once,
    the full (b, b) output written once."""
    return esz * (b * (b + 1) // 2 + b * b)


def one_sm_ms(flops, kind, rates):
    """flops at one SM's share of the card's rate (132 SMs): the yardstick
    of a kernel that runs in one CTA."""
    return flops / (rates[kind] / 132) * 1e3


def _bitwise(what, got, want):
    """Raise unless got and want hold the same bits (NaN included)."""
    as_int = {4: torch.int32, 8: torch.int64}[got.element_size()]
    if (got.shape != want.shape or got.dtype != want.dtype
            or not torch.equal(got.contiguous().view(as_int),
                               want.contiguous().view(as_int))):
        raise AssertionError(f"{what}: not bitwise equal")


def kernel_potrf(rates, gen):
    """potrf_leaf at every leaf size in f32 (128 .. 512: b <= 320 keeps the
    triangle in shared memory, larger tiles start in global memory) and
    at b = 256 in f64 (starts in global memory), a strided view, in place,
    a repeated call bitwise, a tile that is not SPD; timed at the main
    path's b = 256 in f32 and f64 beside cholesky_ex (no host sync) and
    cholesky (which syncs)."""
    from repro_torch.kernels import potrf, ref
    checks = []
    for n in (128, 256, 384, 512):
        a = spd_tile(n, gen)
        want = ref.potrf_ref(a)
        got = potrf.potrf_leaf(a)
        err, atol = check_scaled(f"potrf n={n}", got, want, 3e-4, 1e-6)
        _bitwise(f"potrf n={n} repeated", potrf.potrf_leaf(a), got)
        checks.append({"n": n, "dtype": "f32", "max_abs_err": err,
                       "tol": f"rtol 3e-4 atol 1e-6 max|L| = {atol:g}",
                       "repeat_bitwise": True})
    a64 = spd_tile(256, gen, torch.float64)
    got64 = potrf.potrf_leaf(a64)
    err64, atol = check_scaled("potrf f64", got64, ref.potrf_ref(a64), 1e-10,
                               1e-12)
    _bitwise("potrf f64 repeated", potrf.potrf_leaf(a64), got64)
    checks.append({"n": 256, "dtype": "f64", "max_abs_err": err64,
                   "tol": f"rtol 1e-10 atol 1e-12 max|L| = {atol:g}",
                   "repeat_bitwise": True})
    # a (256, 256) view of a wider matrix (lda = 300), and in place
    big = spd_tile(300, gen)
    view = big[7:263, 7:263]
    want = ref.potrf_ref(view)
    err, _ = check_scaled("potrf strided", potrf.potrf_leaf(view), want,
                          3e-4, 1e-6)
    fresh = potrf.potrf_leaf(view.clone())
    _bitwise("potrf in place", potrf.potrf_leaf(view, out=view), fresh)
    checks.append({"n": 256, "case": "lda 300 view; out = a bitwise",
                   "max_abs_err": err})
    bad = -spd_tile(128, gen)
    check_close("potrf not SPD", potrf.potrf_leaf(bad), ref.potrf_ref(bad),
                0, 0)
    checks.append({"n": 128, "case": "not SPD -> NaN lower", "ok": True})
    # main path: the first diagonal tile of the n = 16384 matrix, b = 256;
    # L's diagonal is about 128 and its off-diagonal about 0.004, which
    # the atol of 1e-6 max|L| (about 1.3e-4) still resolves
    b = 256
    tile = main_tile(b, N_MAIN, 1)
    err, atol = check_scaled("potrf main", potrf.potrf_leaf(tile),
                             ref.potrf_ref(tile), 3e-4, 1e-6)
    bound, by = bound_ms(b ** 3 / 3, leaf_bytes(b, 4), "f32", rates)
    t64 = main_tile(b, N_MAIN, 1).double()
    f64 = {"ms": cuda_ms(lambda: potrf.potrf_leaf(t64)),
           "library_ms": cuda_ms(lambda: torch.linalg.cholesky_ex(t64)),
           "library_cholesky_ms": cuda_ms(lambda: torch.linalg.cholesky(t64)),
           "bound_ms": bound_ms(b ** 3 / 3, leaf_bytes(b, 8), "f64",
                                rates)[0],
           "one_sm_ms": one_sm_ms(b ** 3 / 3, "f64", rates),
           "max_abs_err": err64}
    return checks, {
        "max_abs_err": err, "tol": f"rtol 3e-4 atol 1e-6 max|L| = {atol:g}",
        "ms": cuda_ms(lambda: potrf.potrf_leaf(tile)),
        "plain_ms": cuda_ms(lambda: ref.potrf_ref(tile)),
        "library_ms": cuda_ms(lambda: torch.linalg.cholesky_ex(tile)),
        "library": "torch.linalg.cholesky_ex",
        "library_cholesky_ms": cuda_ms(lambda: torch.linalg.cholesky(tile)),
        "bound_ms": bound, "bound_by": by,
        "one_sm_ms": one_sm_ms(b ** 3 / 3, "f32", rates), "shape": [b, b],
        "f64": f64}


def kernel_tri_inv(rates, gen):
    """tri_inv_leaf at every leaf size in f32 (b <= 256 in shared memory)
    and at b = 256 in f64, a repeated call bitwise; the batched entry on
    the 64 diagonal tiles of the n = 16384 blocked factor, read in place:
    each tile bitwise equal to a single launch, a NaN tile leaving its
    neighbours' bits alone; timed against 64 single launches and one
    batched solve_triangular."""
    import repro_torch as rt
    from repro_torch.kernels import potrf, ref
    checks = []
    for n in (128, 256, 384, 512):
        r = torch.randn((n, n), generator=gen, device="cuda")
        l = r.tril() + math.sqrt(n) * 4 * torch.eye(n, device="cuda")
        got = potrf.tri_inv_leaf(l)
        err, atol = check_scaled(f"tri_inv n={n}", got, ref.tri_inv_ref(l),
                                 1e-4, 1e-6)
        _bitwise(f"tri_inv n={n} repeated", potrf.tri_inv_leaf(l), got)
        checks.append({"n": n, "dtype": "f32", "max_abs_err": err,
                       "tol": f"rtol 1e-4 atol 1e-6 max|X| = {atol:g}",
                       "repeat_bitwise": True})
    l64 = potrf.potrf_leaf(spd_tile(256, gen, torch.float64))
    got64 = potrf.tri_inv_leaf(l64)
    err64, atol = check_scaled("tri_inv f64", got64, ref.tri_inv_ref(l64),
                               1e-10, 1e-12)
    _bitwise("tri_inv f64 repeated", potrf.tri_inv_leaf(l64), got64)
    checks.append({"n": 256, "dtype": "f64", "max_abs_err": err64,
                   "tol": f"rtol 1e-10 atol 1e-12 max|X| = {atol:g}",
                   "repeat_bitwise": True})
    # main path: the inverse of the first diagonal tile's factor; its
    # diagonal is about 1/128 and its off-diagonal about 5e-7
    b = 256
    l = potrf.potrf_leaf(main_tile(b, N_MAIN, 2))
    err, atol = check_scaled("tri_inv main", potrf.tri_inv_leaf(l),
                             ref.tri_inv_ref(l), 1e-4, 1e-6)
    eye = torch.eye(b, device="cuda")
    bound, by = bound_ms(b ** 3 / 3, leaf_bytes(b, 4), "f32", rates)
    lf = l.double()
    eye64 = eye.double()
    f64 = {"ms": cuda_ms(lambda: potrf.tri_inv_leaf(lf)),
           "library_ms": cuda_ms(lambda: torch.linalg.solve_triangular(
               lf, eye64, upper=False)),
           "bound_ms": bound_ms(b ** 3 / 3, leaf_bytes(b, 8), "f64",
                                rates)[0],
           "one_sm_ms": one_sm_ms(b ** 3 / 3, "f64", rates),
           "max_abs_err": err64}
    # the batched entry: the 64 diagonal tiles of the main path's factor
    lp = rt.cholesky_padded(paper_matrix(N_MAIN, 3),
                            rt.PAPER_CONFIGS["pure_f32"])
    tiles = potrf.diag_tiles(lp, b)
    T = tiles.shape[0]
    got = potrf.tri_inv_leaf_batched(tiles)
    singles = torch.empty_like(got)

    def single_launches():
        for t in range(T):
            potrf.tri_inv_leaf(tiles[t], out=singles[t])

    single_launches()
    _bitwise("tri_inv batched == single", got, singles)
    _bitwise("tri_inv batched repeated", potrf.tri_inv_leaf_batched(tiles),
             got)
    err_b, _ = check_scaled("tri_inv batched", got,
                            torch.stack([ref.tri_inv_ref(tiles[t])
                                         for t in range(T)]), 1e-4, 1e-6)
    spoilt = lp.clone()
    spoilt[b:2 * b, b:2 * b] = float("nan")
    got_nan = potrf.tri_inv_leaf_batched(potrf.diag_tiles(spoilt, b))
    keep = [t for t in range(T) if t != 1]
    _bitwise("tri_inv batched NaN neighbours", got_nan[keep], got[keep])
    if not bool(torch.isnan(got_nan[1].diagonal()).all()):
        raise AssertionError("tri_inv batched: the NaN tile is not NaN")
    checks.append({"case": f"batched, {T} diagonal tiles of the n = {N_MAIN}"
                   " pure_f32 factor in place", "max_abs_err": err_b,
                   "tol": "rtol 1e-4 atol 1e-6 max|X|",
                   "batched_eq_single_bitwise": True,
                   "repeat_bitwise": True,
                   "nan_tile_neighbours_bitwise": True})
    stack = tiles.contiguous()
    eyes = eye.expand(T, b, b)
    batched = {"tiles": T, "ms": cuda_ms(lambda: potrf.tri_inv_leaf_batched(
                   tiles)),
               "single_launches_ms": cuda_ms(single_launches, reps=5,
                                             warmup=1),
               "library_ms": cuda_ms(lambda: torch.linalg.solve_triangular(
                   stack, eyes, upper=False)),
               "library": "torch.linalg.solve_triangular((T, b, b), I)",
               "bound_ms": bound_ms(T * b ** 3 / 3, T * leaf_bytes(b, 4),
                                    "f32", rates)[0]}
    del lp, spoilt
    torch.cuda.empty_cache()
    return checks, {
        "max_abs_err": err, "tol": f"rtol 1e-4 atol 1e-6 max|X| = {atol:g}",
        "ms": cuda_ms(lambda: potrf.tri_inv_leaf(l)),
        "plain_ms": cuda_ms(lambda: ref.tri_inv_ref(l)),
        "library_ms": cuda_ms(
            lambda: torch.linalg.solve_triangular(l, eye, upper=False)),
        "library": "torch.linalg.solve_triangular(l, I)",
        "bound_ms": bound, "bound_by": by,
        "one_sm_ms": one_sm_ms(b ** 3 / 3, "f32", rates), "shape": [b, b],
        "f64": f64, "batched": batched}


def kernel_qgemm(rates, gen, n):
    from repro_torch.kernels import qgemm, ref
    checks = []
    f32 = torch.float32
    types = {"f32": f32, "bf16": torch.bfloat16, "f16": torch.float16}
    for (m, k, nn) in [(128, 128, 128), (256, 512, 128), (300, 200, 180),
                       (64, 1000, 72)]:
        for tn, dt in types.items():
            a = torch.randn((m, k), generator=gen, device="cuda").to(dt)
            b = torch.randn((k, nn), generator=gen, device="cuda").to(dt)
            err = check_close(f"qgemm {tn} {m}x{k}x{nn}",
                              qgemm.qgemm(a, b, 1.7),
                              ref.qgemm_ref(a, b, scale=1.7), 2e-4, 1e-4)
            checks.append({"shape": [m, k, nn], "dtype": tn,
                           "max_abs_err": err, "tol": "rtol 2e-4 atol 1e-4"})
    for trans_b in (False, True):
        for beta in (0.0, 1.0, -0.5):
            bf = torch.bfloat16
            a = torch.randn((192, 160), generator=gen, device="cuda").to(bf)
            b = torch.randn((96, 160) if trans_b else (160, 96),
                            generator=gen, device="cuda").to(bf)
            c = torch.randn((192, 96), generator=gen, device="cuda")
            err = check_close(
                f"qgemm epilogue {trans_b} {beta}",
                qgemm.qgemm(a, b, 0.3, c=c, beta=beta, trans_b=trans_b),
                ref.qgemm_ref(a, b, trans_b=trans_b, scale=0.3, c=c,
                              beta=beta), 1e-5, 1e-5)
            checks.append({"case": f"epilogue trans_b={trans_b} "
                           f"beta={beta}", "dtype": "bf16",
                           "max_abs_err": err, "tol": "rtol 1e-5 atol 1e-5"})
    a8 = torch.randint(-127, 128, (200, 700), generator=gen, device="cuda",
                       dtype=torch.int8)
    b8 = torch.randint(-127, 128, (700, 90), generator=gen, device="cuda",
                       dtype=torch.int8)
    err = check_close("qgemm int8", qgemm.qgemm(a8, b8, 0.25),
                      ref.qgemm_ref(a8, b8, scale=0.25), 0, 0)
    checks.append({"shape": [200, 700, 90], "dtype": "int8",
                   "max_abs_err": err, "tol": "exact (s32 accumulation)"})
    a64 = torch.randn((300, 200), generator=gen, device="cuda",
                      dtype=torch.float64)
    b64 = torch.randn((180, 200), generator=gen, device="cuda",
                      dtype=torch.float64)
    c64 = torch.randn((300, 180), generator=gen, device="cuda",
                      dtype=torch.float64)
    err = check_close("qgemm f64",
                      qgemm.qgemm(a64, b64, -1.0, c=c64, beta=1.0,
                                  trans_b=True, out_dtype=torch.float64),
                      ref.qgemm_ref(a64, b64, trans_b=True, scale=-1.0,
                                    c=c64, beta=1.0,
                                    out_dtype=torch.float64), 1e-12, 1e-12)
    checks.append({"shape": [300, 200, 180], "dtype": "f64",
                   "max_abs_err": err, "tol": "rtol 1e-12 atol 1e-12"})
    # main path: the forward sweep's update (m x b) @ (b x k) into c, and
    # the back sweep's transposed view of the same block
    b, k, m = 256, 16, n - 256
    lblk = torch.randn((m, b), generator=gen, device="cuda") / 16
    xp = torch.randn((b, k), generator=gen, device="cuda")
    c = torch.randn((m, k), generator=gen, device="cuda")
    err = check_close("qgemm main",
                      qgemm.qgemm(lblk, xp, -1.0, c=c, beta=1.0),
                      ref.qgemm_ref(lblk, xp, scale=-1.0, c=c, beta=1.0),
                      2e-4, 1e-4)
    lt = torch.randn((b, m), generator=gen, device="cuda") / 16
    xq = torch.randn((b, k), generator=gen, device="cuda")
    cq = torch.randn((m, k), generator=gen, device="cuda")
    err_t = check_close("qgemm main transposed",
                        qgemm.qgemm(lt.T, xq, -1.0, c=cq, beta=1.0),
                        ref.qgemm_ref(lt.T, xq, scale=-1.0, c=cq, beta=1.0),
                        2e-4, 1e-4)
    checks.append({"shape": [m, b, k], "case": "main path, A and A^T view",
                   "dtype": "f32", "max_abs_err": max(err, err_t),
                   "tol": "rtol 2e-4 atol 1e-4"})
    checks += _qgemm_routes(gen)
    out = torch.empty_like(c)
    bound, by = bound_ms(2.0 * m * b * k, 4 * (m * b + b * k + 2 * m * k),
                         "f32", rates)
    timed = {
        "max_abs_err": err, "tol": "rtol 2e-4 atol 1e-4",
        "ms": cuda_ms(lambda: qgemm.qgemm(lblk, xp, -1.0, c=c, beta=1.0,
                                          out=out)),
        "graph_ms": graph_ms(lambda: qgemm.qgemm(lblk, xp, -1.0, c=c,
                                                 beta=1.0, out=out)),
        "ms_back_sweep_view": cuda_ms(lambda: qgemm.qgemm(
            lt.T, xq, -1.0, c=cq, beta=1.0, out=cq)),
        "plain_ms": cuda_ms(lambda: ref.qgemm_ref(lblk, xp, scale=-1.0, c=c,
                                                  beta=1.0)),
        "library_ms": cuda_ms(lambda: torch.addmm(c, lblk, xp, beta=1.0,
                                                  alpha=-1.0, out=out)),
        "library_graph_ms": graph_ms(lambda: torch.addmm(
            c, lblk, xp, beta=1.0, alpha=-1.0, out=out)),
        "timing": _TIMING,
        "route": qgemm.launch(lblk, xp, -1.0, c=c, beta=1.0, out=out)[1].route,
        "bound_ms": bound, "bound_by": by, "shape": [m, b, k]}
    timed["tree_shapes"] = _qgemm_tree_shapes(gen, rates)
    return checks, timed


#: how the small kernels' lines are timed
_TIMING = ("ms, library_ms: CUDA events around 20 calls from Python (as "
           "every kernel); graph_ms, library_graph_ms: the same launches in "
           "one CUDA graph, without the host's time between calls")


def _qgemm_gamma(a, bn, scale, c, beta, k, u=2.0 ** -24):
    """_gamma_atol with the bound |scale| max(|A| |B|^T) + |beta| max|C|,
    the data's own scale (|A| |B|^T in f32: every term is positive)."""
    prod = float((a.float().abs() @ bn.float().abs().T).max())
    return _gamma_atol(k, u, abs(scale) * prod
                       + (abs(beta) * float(c.abs().max())
                          if c is not None else 0.0))


def _qgemm_operand(gen, rows, k, dt, major):
    """A (rows, k) operand of type dt stored K-major or MN-major (its
    transpose contiguous), values of a level's grid: int8 codes, or N(0, 1)
    rounded to the 16-bit type."""
    shape = (rows, k) if major == "k" else (k, rows)
    if dt == torch.int8:
        t = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                          dtype=torch.int8)
    else:
        t = torch.randn(shape, generator=gen, device="cuda").to(dt)
    return t if major == "k" else t.T


#: (M, N, K, operand type, A major, B major, route) of the route cases:
#: the tree factor's top shapes on each route, MN-major 16-bit operands (the
#: left sweeps' l21^T), an MN-major int8 operand (staged: s8 wgmma reads
#: K-major only), N = 1 and 7, ragged M, N and K (a K-major row of 333
#: 16-bit values is off TMA's 16-byte grid: staged), a k-split whose
#: scratch cap takes its 2300 columns in two blocks
_QGEMM_ROUTE_CASES = [
    (4096, 4096, 8192, "f16", "k", "k", "tc"),
    (4096, 4096, 8192, "bf16", "k", "k", "tc"),
    (4096, 4096, 8192, "int8", "k", "k", "tc"),
    (256, 256, 8192, "f32", "k", "k", "simt_ksplit"),
    (1024, 1024, 8192, "f32", "k", "k", "simt_ksplit"),
    (8192, 256, 256, "f32", "k", "k", "simt_tile"),
    (2048, 512, 2048, "f16", "mn", "mn", "tc"),
    (2048, 512, 2048, "bf16", "mn", "k", "tc"),
    (2048, 16, 2048, "f16", "mn", "mn", "tc"),
    (2048, 512, 2048, "int8", "mn", "k", "tc_staged"),
    (1000, 7, 333, "f16", "mn", "mn", "tc_staged"),
    (1000, 1, 320, "bf16", "k", "mn", "tc"),
    (1000, 1, 333, "bf16", "k", "mn", "tc_staged"),
    (257, 129, 304, "int8", "k", "k", "tc"),
    (301, 181, 203, "f32", "k", "k", "simt_tile"),
    (4096, 16, 8192, "f32", "mn", "mn", "simt_narrow"),
    (256, 2300, 8192, "f32", "k", "k", "simt_ksplit"),
    (16128, 7, 256, "f32", "k", "mn", "simt_narrow"),
    (300, 180, 200, "f64", "k", "k", "simt_tile"),
    (300, 16, 200, "f64", "mn", "mn", "simt_narrow"),
]
_QGEMM_TYPES = {"f16": torch.float16, "bf16": torch.bfloat16,
                "int8": torch.int8, "f32": torch.float32,
                "f64": torch.float64}
_QGEMM_TOL = ("atol 2(k+2) u (|scale| max(|A||B|^T) + |beta| max|C|), "
              "u = 2^-24 (2^-53 f64): two sums of k products in other "
              "orders (a wgmma's f32 accumulation need not round to "
              "nearest)")


def _qgemm_routes(gen):
    """qgemm on each route (ops.qgemm, counted by ops.QGEMM_ROUTES) against
    qgemm_ref; a repeat bitwise; columns of qgemm(a, b[:, cols]) bitwise
    equal to the full product's for N in {1, 7, 16, 48} at shuffled
    positions; the scale read from the card; out = c."""
    from repro_torch.kernels import ops, qgemm, ref
    checks = []
    for (M, N, K, tn, am, bm, route) in _QGEMM_ROUTE_CASES:
        dt = _QGEMM_TYPES[tn]
        a = _qgemm_operand(gen, M, K, dt, am)
        bn = _qgemm_operand(gen, N, K, dt, bm)      # B as its (N, K) view
        od = qgemm.acc_dtype(dt)
        c = torch.randn((M, N), generator=gen, device="cuda", dtype=od)
        what = f"qgemm {tn} {M}x{N}x{K} A {am} B {bm}"
        ops.reset_launches()
        got = ops.qgemm(a, bn.T, 0.75, c=c, beta=-0.5, out_dtype=od)
        took = [r for r, v in ops.QGEMM_ROUTES.items() if v]
        if took != [route]:
            raise AssertionError(f"{what}: took {took}, not {route}")
        want = ref.qgemm_ref(a, bn.T, scale=0.75, c=c, beta=-0.5,
                             out_dtype=od)
        if dt == torch.int8:
            _bitwise(what, got, want)
            err, tol = 0.0, "bitwise (exact s32 accumulation)"
        else:
            atol = _qgemm_gamma(a, bn, 0.75, c, -0.5, K,
                                _unit(dt, od))
            err = check_close(what, got, want, 0, atol)
            tol = f"{_QGEMM_TOL}: {atol:g}"
        _bitwise(f"{what} repeat", ops.qgemm(a, bn.T, 0.75, c=c, beta=-0.5,
                                             out_dtype=od), got)
        perm = torch.randperm(N, generator=gen, device="cuda")
        for n in (1, 7, 16, 48):
            cols = perm[:min(n, N)]
            sub = ops.qgemm(a, bn.T[:, cols].contiguous(), 0.75,
                            c=c[:, cols].contiguous(), beta=-0.5,
                            out_dtype=od)
            _bitwise(f"{what} columns N={n}", sub, got[:, cols])
        checks.append({"shape": [M, N, K], "dtype": tn, "a": am, "b": bm,
                       "route": route, "max_abs_err": err, "tol": tol,
                       "repeat_bitwise": True,
                       "columns_bitwise_at_n": [1, 7, 16, 48]})
    # the scale from device memory and out = c, on every operand type
    for tn in ("f16", "bf16", "int8", "f32", "f64"):
        dt = _QGEMM_TYPES[tn]
        a = _qgemm_operand(gen, 256, 512, dt, "k")
        bn = _qgemm_operand(gen, 192, 512, dt, "k")
        od = qgemm.acc_dtype(dt)
        c = torch.randn((256, 192), generator=gen, device="cuda", dtype=od)
        s = torch.tensor(-0.3, device="cuda")     # an f32, read on the card
        want = qgemm.qgemm(a, bn, float(s), c=c, beta=1.0, trans_b=True,
                           out_dtype=od)
        inplace = c.clone()
        qgemm.qgemm(a, bn, s, c=inplace, beta=1.0, trans_b=True,
                    out_dtype=od, out=inplace)
        _bitwise(f"qgemm {tn} device scale, out = c", inplace, want)
    checks.append({"case": "scale read from the card, out = c",
                   "dtypes": ["f16", "bf16", "int8", "f32", "f64"],
                   "bitwise_vs_host_scale": True})
    return checks


def _qgemm_library(x, y, c, tn):
    """``library_ms`` (CUDA events), ``library_graph_ms`` and ``library``
    of one PyTorch call computing the same function on the same operands
    where there is one, else a labelled stand-in."""
    def timed(fn, label):
        return {"library_ms": cuda_ms(fn, reps=10),
                "library_graph_ms": graph_ms(fn, 10), "library": label}
    if tn == "int8":
        try:
            return timed(lambda: torch._int_mm(x, y.T),
                         "torch._int_mm(a, b^T): s32 product without the "
                         "epilogue")
        except RuntimeError as exc:
            return {"library_ms": None,
                    "library": f"torch._int_mm refused: {exc}"[:200]}
    if tn == "f32":
        return timed(lambda: torch.addmm(c, x, y.T, alpha=-1.0),
                     "torch.addmm(c, a, b^T, alpha=-1)")
    try:
        return timed(lambda: torch.addmm(c, x, y.T, alpha=-1.0,
                                         out_dtype=torch.float32),
                     "torch.addmm(c, a, b^T, alpha=-1, out_dtype=f32)")
    except (TypeError, RuntimeError):
        c16 = c.to(x.dtype)
        return timed(lambda: torch.addmm(c16, x, y.T, alpha=-1.0),
                     f"torch.addmm in {tn}: output in {tn}, speed only")


#: (M, N, K, operand type) of the tree factor's top qgemm shapes at
#: n = 16384, A B^T with both K-major, timed in the qgemm kernel line
_TREE_TIMED = ((256, 256, 8192, "f32"), (4096, 4096, 8192, "f16"),
               (4096, 4096, 8192, "bf16"), (4096, 4096, 8192, "int8"))


def _qgemm_tree_shapes(gen, rates):
    """The tree factor's top shapes on each route (the top two of
    tree_qgemm_shapes' f16x3_f32 and int8_f32 tables), timed (CUDA events,
    and graph_ms) beside their bound, the plain version, one library call
    of the same function and addmm on the operands widened to f32."""
    from repro_torch.kernels import qgemm, ref
    rows = []
    for (M, N, K, tn) in _TREE_TIMED:
        dt = _QGEMM_TYPES[tn]
        x = _qgemm_operand(gen, M, K, dt, "k")
        y = _qgemm_operand(gen, N, K, dt, "k")
        c = torch.randn((M, N), generator=gen, device="cuda")
        out = torch.empty_like(c)
        kind = {"f32": "f32", "int8": "int8"}.get(tn, "bf16")
        bound, by = bound_ms(2.0 * M * N * K,
                             x.element_size() * (M + N) * K + 8 * M * N,
                             kind, rates)
        xw, yw = x.float(), y.float()

        def run():
            return qgemm.qgemm(x, y, -1.0, c=c, beta=1.0, trans_b=True,
                               out=out)
        rows.append({
            "shape": [M, N, K], "dtype": tn, "trans_b": True,
            "route": qgemm.launch(x, y, -1.0, c=c, beta=1.0, trans_b=True,
                                  out=out)[1].route,
            "ms": cuda_ms(run, reps=10), "graph_ms": graph_ms(run, 10),
            "bound_ms": bound, "bound_by": by,
            "rate": f"{rates[kind] / 1e12:g} TFLOP/s ({kind})",
            "plain_ms": cuda_ms(lambda: ref.qgemm_ref(
                x, y, trans_b=True, scale=-1.0, c=c, beta=1.0), reps=2,
                warmup=1),
            **_qgemm_library(x, y, c, tn),
            "addmm_f32_operands_ms": cuda_ms(lambda: torch.addmm(
                c, xw, yw.T, alpha=-1.0), reps=10),
            "timing": _TIMING})
        del x, y, xw, yw, c, out
    torch.cuda.empty_cache()
    return rows


def _panel_inputs(gen, m, b, dtype=torch.float32, damp=1.0):
    """Operands of tests/test_kernels.py:_panel_operands; ``damp`` < 1
    shrinks L^-1 so that repeated in-place calls (timing) stay finite."""
    r = torch.randn((b, b), generator=gen, device="cuda", dtype=dtype)
    linv = r.tril() * damp
    linv.diagonal().add_(3.0 * damp)
    a21 = torch.randn((m, b), generator=gen, device="cuda", dtype=dtype)
    c = torch.randn((m, m), generator=gen, device="cuda", dtype=dtype)
    return linv, a21, c


def _panel_check(what, cfg, m, gen, rounding=True, dtype=torch.float32):
    """One panel_update call against panel_update_ref on the same inputs,
    held to one unit of the coarsest level's grid (the kernel's and
    torch's f32 GEMMs may differ in the last bit, which can flip a
    rounding)."""
    from repro_torch.core.plan import build_plan
    from repro_torch.kernels import panel, ref
    b = cfg.leaf
    meta = build_plan(m + b, cfg).panel_meta(0)
    kw = dict(store_names=meta.store_names, store_quants=meta.store_quants,
              pair_names=meta.pair_names, pair_quants=meta.pair_quants,
              rounding=rounding)
    linv, a21, c = _panel_inputs(gen, m, b, dtype)
    l21r, cr = ref.panel_update_ref(linv, a21, c, **kw)
    a_k, c_k = a21.clone(), c.clone()
    panel.panel_update(linv, a_k, c_k, **kw)
    unit = GRID[cfg.levels[0]]
    e1 = check_close(f"{what} l21", a_k, l21r, 0,
                     unit * float(l21r.abs().max()))
    e2 = check_close(f"{what} c", c_k, cr, 0, unit * float(cr.abs().max()))
    iu = torch.triu(torch.ones(m // b, m // b, dtype=torch.bool,
                               device="cuda"), 1)
    upper = iu.repeat_interleave(b, 0).repeat_interleave(b, 1)
    if not torch.equal(c_k[upper], c[upper]):
        raise AssertionError(f"{what}: upper tiles of c changed")
    return {"case": what, "m": m, "b": b, "max_abs_err": max(e1, e2),
            "tol": f"{unit:g} x max|ref|"}


#: the rate of each pair name's products: the tensor cores' for f16, bf16
#: and int8 (products exact on the grid values), the CUDA cores' for f32
#: and f64 (card_rates keys)
_PANEL_RATE = {"f16": "bf16", "bf16": "bf16", "int8": "int8", "f32": "f32",
               "f64": "f64"}


def _panel_bound(meta, m, b, esz, rates):
    """The least time of one panel: the L21 solve (2 m b^2, f32 or f64)
    and each lower pair's 2 b^3 products at its name's rate, against the
    bytes of one read and one write of the lower trailing tiles, of A21 /
    L21 and of L11^-1. Beside it the bound with every product at the
    CUDA cores' f32 rate (the kernel's before it took the tensor cores)."""
    nt = m // b
    flops = {"f32": 2.0 * m * b * b}
    for i in range(nt):
        for j in range(i + 1):
            kind = _PANEL_RATE[meta.pair_names[i][j]]
            flops[kind] = flops.get(kind, 0.0) + 2.0 * b ** 3
    ntri = nt * (nt + 1) // 2
    nbytes = esz * (b * b + 2 * m * b + 2 * ntri * b * b)
    t_ops = sum(f / rates[k] for k, f in flops.items()) * 1e3
    t_bytes = nbytes / rates["bytes"] * 1e3
    f32_ms, _ = bound_ms(sum(flops.values()), nbytes, "f32", rates)
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops_ms": t_ops, "bytes_ms": t_bytes,
            "gflop_by_rate": {k: f / 1e9 for k, f in flops.items()},
            "bound_ms_all_f32_rate": f32_ms}


def kernel_panel(rates, gen, n):
    from repro_torch.core.plan import build_plan
    from repro_torch.core.precision import PAPER_CONFIGS, PrecisionConfig
    from repro_torch.kernels import ops, panel, ref
    checks = []
    for levels, nt in [(("f32",), 2), (("f16", "f32"), 3),
                       (("f16", "f16", "f32"), 4), (("bf16", "f32"), 2),
                       (("int8", "f32"), 3)]:
        cfg = PrecisionConfig(levels=levels, leaf=128)
        for rounding in (True, False):
            checks.append(_panel_check(
                f"test {'/'.join(levels)} rounding={rounding}", cfg,
                nt * 128, gen, rounding))
    variants = {
        "f32": (PAPER_CONFIGS["pure_f32"], True),
        "bf16": (PAPER_CONFIGS["bf16_f32"], True),
        "f16": (dataclasses.replace(PAPER_CONFIGS["f16x3_f32"],
                                    quantize=False), True),
        "f16-quant": (PAPER_CONFIGS["f16x3_f32"], True),
        "int8": (PAPER_CONFIGS["int8_f32"], True),
        "rounding=False": (PAPER_CONFIGS["f16x3_f32"], False),
    }
    heights = (256, 4096, n - 256)
    for vname, (cfg, rounding) in variants.items():
        for m in heights:
            checks.append(_panel_check(f"main {vname}", cfg, m, gen,
                                       rounding))
    checks.append(_panel_check("main f64 container (f32x3_f64)",
                               PAPER_CONFIGS["f32x3_f64"], 1024, gen, True,
                               torch.float64))
    # a leaf the tensor cores do not take: every pair on the CUDA cores,
    # the int8 tiles as whole-tile items (absmax, then the rounding)
    checks.append(_panel_check("leaf 384 int8_f32 (CUDA cores only)",
                               PrecisionConfig(levels=("int8", "f32"),
                                               leaf=384), 384 * 4, gen))
    # time the paper's ladder at panels 0, 31 and 61 of the main path
    cfg = PAPER_CONFIGS["f16x3_f32"]
    b = cfg.leaf
    plan = build_plan(n, cfg)
    err = max(ch["max_abs_err"] for ch in checks
              if ch["case"] == "main f16-quant" and ch["m"] == heights[-1])
    panels = []
    for p in (0, 31, 61):
        m = n - (p + 1) * b
        meta = plan.panel_meta(p)
        kw = dict(store_names=meta.store_names,
                  store_quants=meta.store_quants,
                  pair_names=meta.pair_names, pair_quants=meta.pair_quants)
        linv, a21, c = _panel_inputs(gen, m, b, damp=1 / 32)
        before = dict(ops.PANEL_ROUTES)
        ops.panel_update(linv, a21, c, **kw)
        routes = {k: ops.PANEL_ROUTES[k] - before[k] for k in before}
        panels.append({
            "panel": p, "shape": [m, b], "routes": routes,
            "ms": cuda_ms(lambda: panel.panel_update(linv, a21, c, **kw),
                          reps=5, warmup=1),
            "plain_ms": (cuda_ms(lambda: ref.panel_update_ref(
                linv, a21, c, **kw), reps=3, warmup=1) if p == 0 else None),
            **_panel_bound(meta, m, b, 4, rates)})
        del linv, a21, c
    torch.cuda.empty_cache()
    head = panels[0]
    return checks, {
        "max_abs_err": err, "tol": f"{GRID['f16']:g} x max|ref|",
        "ms": head["ms"], "plain_ms": head["plain_ms"], "library_ms": None,
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "shape": head["shape"], "ladder": "f16x3_f32", "panel": 0,
        "routes": head["routes"], "panels": panels}


def kernel_residual(rates, gen, n):
    """residual_fused against residual_ref: f32 and f64, vector and
    k = 1, 3, 16, 32 columns, ragged n = 129, 300 and the main path's
    n = 16384; then column independence, bitwise."""
    from repro_torch.kernels import ref, residual
    checks = []
    dtypes = {"f32": torch.float32, "f64": torch.float64}
    # n-term sums of N(0, 1) products in another order: f32 at the
    # reference suite's tolerance (tests/test_kernels.py), f64 at 1e-12
    # times sqrt(n)
    tols = {"f32": lambda m: (2e-4, 2e-3),
            "f64": lambda m: (0.0, 1e-12 * math.sqrt(m))}
    for m in (129, 300, n):
        for tn, dt in dtypes.items():
            a = torch.randn((m, m), generator=gen, device="cuda", dtype=dt)
            for k in (None, 1, 3, 16, 32):
                shape = (m,) if k is None else (m, k)
                x = torch.randn(shape, generator=gen, device="cuda", dtype=dt)
                b = torch.randn(shape, generator=gen, device="cuda", dtype=dt)
                rtol, atol = tols[tn](m)
                err = check_close(f"residual {tn} n={m} k={k}",
                                  residual.residual_fused(a, x, b),
                                  ref.residual_ref(a, x, b), rtol, atol)
                checks.append({"n": m, "k": k or "vector", "dtype": tn,
                               "max_abs_err": err,
                               "tol": f"rtol {rtol:g} atol {atol:g}"})
            del a
    # column j of a k = 32 launch == the same column in a k = 16 launch
    # with other neighbours, in a k = 2 launch and alone; A's ragged
    # leading dimension (scalar loads) == an aligned one (16-byte loads)
    for tn, dt in dtypes.items():
        m = 300
        big = torch.randn((304, 304), generator=gen, device="cuda", dtype=dt)
        a_al, a_rg = big[:m, :m], big[:m, :m].contiguous()
        x = torch.randn((m, 32), generator=gen, device="cuda", dtype=dt)
        b = torch.randn((m, 32), generator=gen, device="cuda", dtype=dt)
        full = residual.residual_fused(a_al, x, b)
        other = torch.randn((m, 16), generator=gen, device="cuda", dtype=dt)
        x16, b16 = other.clone(), other.clone()
        same = torch.equal(residual.residual_fused(a_rg, x, b), full)
        for j in range(32):
            x16[:, 11], b16[:, 11] = x[:, j], b[:, j]
            pair = [j, (j + 7) % 32]
            same &= torch.equal(
                residual.residual_fused(a_al, x16, b16)[:, 11], full[:, j])
            same &= torch.equal(residual.residual_fused(
                a_al, x[:, pair], b[:, pair])[:, 0], full[:, j])
            same &= torch.equal(residual.residual_fused(
                a_al, x[:, j], b[:, j]), full[:, j])
        if not same:
            raise AssertionError(f"residual {tn}: a column depends on its "
                                 "neighbours or on k")
        checks.append({"case": "column independence: k=32 vs k=16, k=2, "
                       "vector; aligned vs ragged lda", "dtype": tn,
                       "n": m, "bitwise": True})
    # main path: n = 16384 with the 16-column slot block (and one column),
    # f64 residuals (the serve and refine phases) and the f32 default
    timing = {}
    for tn in ("f64", "f32"):
        dt = dtypes[tn]
        a = torch.randn((n, n), generator=gen, device="cuda", dtype=dt) / 128
        for k in (16, 1):
            x = torch.randn((n, k), generator=gen, device="cuda", dtype=dt)
            b = torch.randn((n, k), generator=gen, device="cuda", dtype=dt)
            out = torch.empty_like(b)
            rtol, atol = tols[tn](n)
            full = residual.residual_fused(a, x, b)
            err = check_close(f"residual main {tn} k={k}", full,
                              ref.residual_ref(a, x, b), rtol, atol)
            # a rank's block row of A (the distributed refinement's
            # residual, P = 4): its rows bitwise the square launch's
            w = n // 4
            for r0 in range(0, n, w):
                _bitwise(f"residual main {tn} k={k} rows {r0}",
                         residual.residual_fused(a[r0:r0 + w], x,
                                                 b[r0:r0 + w]),
                         full[r0:r0 + w])
            esz = a.element_size()
            bound, by = bound_ms(2.0 * n * n * k, esz * (n * n + 3 * n * k),
                                 tn, rates)
            timing[f"{tn}_k{k}"] = {
                "max_abs_err": err, "tol": f"rtol {rtol:g} atol {atol:g}",
                "ms": cuda_ms(lambda: residual.residual_fused(a, x, b,
                                                              out=out)),
                "plain_ms": cuda_ms(lambda: ref.residual_ref(a, x, b),
                                    reps=5),
                "library_ms": cuda_ms(lambda: torch.addmm(
                    b, a, x, beta=1.0, alpha=-1.0, out=out)),
                "bound_ms": bound, "bound_by": by, "shape": [n, n, k],
                "dtype": tn, "row_blocks_bitwise": True}
        del a
    torch.cuda.empty_cache()
    return checks, {**timing["f64_k16"],
                    **{key: timing[key] for key in ("f64_k1", "f32_k16",
                                                    "f32_k1")}}


def _gamma_atol(k, u, bound):
    """|kernel - plain| for two sums of k products in other orders: each
    lies within k u sum|products| of the exact sum, and ``bound`` bounds
    that sum; one more unit for the epilogue's rounding."""
    return 2 * (k + 2) * u * bound


def _unit(*dtypes):
    return 2.0 ** -53 if torch.float64 in dtypes else 2.0 ** -24


def kernel_trsm(rates, gen, n):
    """trsm_leaf (B @ L^-T through L^-1) against its plain product and, via
    ops.trsm (tri_inv_leaf + trsm_leaf), against the triangular solve, with
    B's rows on the 16-byte grid and off it; then at every M the tree
    factor gives it (leaf 256), each timed beside its bound, the solve and
    its plan."""
    from repro_torch.kernels import ops, potrf, ref, trsm
    checks = []

    def one(what, b, l, dtype):
        linv = potrf.tri_inv_leaf(l)
        got, p = trsm.launch(b, linv)
        want = ref.qgemm_ref(b, linv, trans_b=True, out_dtype=dtype)
        atol = _gamma_atol(l.shape[0], _unit(dtype),
                           float((b.abs() @ linv.abs().T).max()))
        err = check_close(what, got, want, 0, atol)
        dirty = linv + torch.triu(torch.full_like(linv, 1e3), 1)
        if not torch.equal(trsm.trsm_leaf(b, dirty), got):
            raise AssertionError(f"{what}: read above the diagonal")
        if not torch.equal(trsm.trsm_leaf(b, linv), got):
            raise AssertionError(f"{what}: not the same bits again")
        # inverse-then-product vs substitution: the reference suite's
        # tolerance in f32, 1e-12 in f64
        stol = 2e-4 if dtype == torch.float32 else 1e-12
        before = ops.TRSM_ROUTES[p.route]
        err2 = check_close(f"{what} solve", ops.trsm(b, l),
                           ref.trsm_ref(b, l), stol, stol)
        if ops.TRSM_ROUTES[p.route] != before + 1:
            raise AssertionError(f"{what}: not on route {p.route}")
        return err, err2, atol, p

    def tri(m, dtype):
        r = torch.randn((m, m), generator=gen, device="cuda", dtype=dtype)
        return r.tril() + 4 * math.sqrt(m) * torch.eye(m, device="cuda",
                                                        dtype=dtype)
    for (m, nn) in [(128, 128), (700, 256), (1024, 128), (65, 384)]:
        for tn, dt in (("f32", torch.float32), ("f64", torch.float64)):
            wide = torch.randn((m, nn + 32), generator=gen, device="cuda",
                               dtype=dt)
            l = tri(nn, dt)
            for col0 in (16, 1):          # rows on the 16-byte grid, off it
                err, err2, atol, p = one(f"trsm {tn} {m}x{nn} @{col0}",
                                         wide[:, col0:col0 + nn], l, dt)
                checks.append({"shape": [m, nn], "dtype": tn,
                               "col_offset": col0, "route": p.route,
                               "max_abs_err": err,
                               "tol": f"atol {atol:g} (2(n+2) u max "
                                      "|B||Linv|^T)",
                               "solve_err": err2, "upper_never_read": True,
                               "repeat_bitwise": True})
    # main path: the panel leaves of the n = 16384 tree factor, B (M, 256)
    # with M = 256 .. 8192 against the factor of the first diagonal tile;
    # 32 calls at each M a factor
    b = 256
    l = potrf.potrf_leaf(main_tile(b, n, 3))
    linv = potrf.tri_inv_leaf(l)
    by_m = []
    m = 256
    while m <= n // 2:
        x = torch.randn((m, b), generator=gen, device="cuda") / 64
        err, err2, atol, p = one(f"trsm main M={m}", x, l, torch.float32)
        out = torch.empty_like(x)
        flops = m * b * (b + 1.0)        # the lower triangle's MACs, x 2
        nbytes = 4 * (2 * m * b + b * (b + 1) / 2)
        bound, by = bound_ms(flops, nbytes, "f32", rates)
        xt = x.T.contiguous()
        by_m.append({
            "M": m, "max_abs_err": err, "solve_err": err2,
            "tol": f"atol {atol:g} (2(n+2) u max|B||Linv|^T)",
            "ms": cuda_ms(lambda: trsm.trsm_leaf(x, linv, out=out)),
            "graph_ms": graph_ms(lambda: trsm.trsm_leaf(x, linv, out=out)),
            "plain_ms": cuda_ms(lambda: ref.qgemm_ref(x, linv, trans_b=True),
                                reps=5),
            "library_ms": cuda_ms(lambda: torch.linalg.solve_triangular(
                l, xt, upper=False)),
            "bound_ms": bound, "bound_by": by, "route": p.route,
            "tile": list(p.tile), "kc": p.kc, "ctas": p.ctas,
            "reason": p.reason})
        m *= 2
    # the launch's floor: one CTA in one pass, B (64, 32)
    x1 = torch.randn((64, 32), generator=gen, device="cuda")
    l1 = torch.eye(32, device="cuda")
    floor = {"shape": [64, 32], "route": trsm.plan(64, 32, x1.dtype).route,
             "ms": cuda_ms(lambda: trsm.trsm_leaf(x1, l1)),
             "graph_ms": graph_ms(lambda: trsm.trsm_leaf(x1, l1))}
    top = by_m[-1]
    return checks, {
        **top, "shape": [top["M"], b],
        "library": "torch.linalg.solve_triangular(L, B^T) (the solve, "
                   "without the inverse)",
        "timing": _TIMING, "by_m": by_m, "launch_floor": floor,
        "sum32_ms": sum(32 * r["ms"] for r in by_m),
        "sum32_graph_ms": sum(32 * r["graph_ms"] for r in by_m)}


_SYRK_TYPES = {"f32": (torch.float32, torch.float32),
               "bf16": (torch.bfloat16, torch.float32),
               "f16": (torch.float16, torch.float32),
               "int8": (torch.int8, torch.float32),
               "f32-c64": (torch.float32, torch.float64),
               "f64": (torch.float64, torch.float64)}


def _syrk_operands(gen, n, k, tn, amp=1.0):
    adt, cdt = _SYRK_TYPES[tn]
    c = torch.randn((n, n), generator=gen, device="cuda", dtype=cdt)
    if adt == torch.int8:
        a = torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                          dtype=torch.int8)
    else:
        a = (torch.randn((n, k), generator=gen, device="cuda") * amp).to(adt)
    return c, a


def _syrk_check(what, fn, c, a, scale, beta):
    """fn against syrk_ref; the strict upper triangle of c kept bitwise;
    in place (out=c) and a second run give the same bits."""
    from repro_torch.kernels import ref
    got = fn(c, a, scale, beta)
    want = ref.syrk_ref(c, a, scale=scale, beta=beta)
    aw = a.double()
    diag = float((aw * aw).sum(dim=1).max())
    atol = _gamma_atol(a.shape[1], _unit(a.dtype, c.dtype),
                       abs(float(scale)) * diag
                       + abs(float(beta)) * float(c.abs().max()))
    err = check_close(what, got, want, 0, atol)
    if not torch.equal(torch.triu(got, 1), torch.triu(c, 1)):
        raise AssertionError(f"{what}: upper triangle of C changed")
    inplace = c.clone()
    fn(inplace, a, scale, beta, out=inplace)
    if not torch.equal(inplace, got) or not torch.equal(
            fn(c, a, scale, beta), got):
        raise AssertionError(f"{what}: not the same bits in place / again")
    return err, atol


_SYRK_TOL = "atol 2(k+2) u (|scale| max diag(A A^T) + |beta| max|C|)"


#: the rate of bound_ms for a SYRK's products, by A's type: 16-bit
#: and int8 on the tensor cores, f32 on the CUDA cores, f64 sums on DMMA's
#: peak (the f64 rate of the table)
_SYRK_RATE = {"f32": "f32", "bf16": "bf16", "f16": "bf16", "int8": "int8",
              "f32-c64": "f64", "f64": "f64"}


def _syrk_library(c, a, tn):
    """One PyTorch call computing the same products with their wide sums
    (over both triangles, so twice the work), and its label."""
    if tn == "int8":
        return (lambda: torch._int_mm(a, a.T),
                "torch._int_mm(a, a^T): s32 product, no epilogue, both "
                "triangles")
    if tn in ("bf16", "f16"):
        return (lambda: torch.addmm(c, a, a.T, alpha=-1.0,
                                    out_dtype=torch.float32),
                "torch.addmm(c, a, a^T, alpha=-1, out_dtype=f32), both "
                "triangles")
    aw = a.to(c.dtype)
    return (lambda: torch.addmm(c, aw, aw.T, alpha=-1.0),
            f"torch.addmm(c, a, a^T, alpha=-1) in {str(c.dtype)[6:]}, both "
            "triangles")


def kernel_syrk_leaf(rates, gen):
    """syrk_leaf at tests/test_kernels.py's shapes and at the tree leaves'
    k = 256 and 8192, every level type, scale read from the card."""
    from repro_torch.kernels import ref, syrk
    checks = []
    for (n, k) in [(128, 128), (256, 1000), (256, 64), (256, 256),
                   (256, 8192)]:
        for tn in _SYRK_TYPES:
            c, a = _syrk_operands(gen, n, k, tn)
            scale = torch.tensor(-0.37, device="cuda")
            err, atol = _syrk_check(f"syrk_leaf {tn} {n}x{k}",
                                    syrk.syrk_leaf, c, a, scale, 0.9)
            checks.append({"shape": [n, k], "dtype": tn, "max_abs_err": err,
                           "tol": f"{_SYRK_TOL} = {atol:g}",
                           "chunks": syrk.leaf_chunk(
                               n, k, syrk.leaf_block(a.dtype, c.dtype))[1],
                           "upper_kept_inplace_deterministic": True})
    # timing: the main path's widest leaf, f32 (every ladder's tree leaves)
    # and bf16 (on the 64 x 64 core), each bound at its type's rate: A read
    # once, C's lower triangle read and written once
    n, k = 256, 8192
    timing = {}
    for tn in ("f32", "bf16"):
        c, a = _syrk_operands(gen, n, k, tn, amp=1 / 64)
        out = c.clone()
        bound, by = bound_ms(n * (n + 1.0) * k,
                             a.element_size() * n * k + 4 * n * (n + 1),
                             _SYRK_RATE[tn], rates)
        lib, label = _syrk_library(c, a, tn)
        err = next(ch["max_abs_err"] for ch in checks
                   if ch["shape"] == [n, k] and ch["dtype"] == tn)
        timing[tn] = {
            "max_abs_err": err, "tol": _SYRK_TOL,
            "ms": cuda_ms(lambda: syrk.syrk_leaf(c, a, -1.0, 1.0, out=out)),
            "graph_ms": graph_ms(
                lambda: syrk.syrk_leaf(c, a, -1.0, 1.0, out=out)),
            "plain_ms": cuda_ms(lambda: ref.syrk_ref(c, a, scale=-1.0)),
            "library_ms": cuda_ms(lib), "library_graph_ms": graph_ms(lib),
            "library": label, "timing": _TIMING,
            "rate": _SYRK_RATE[tn],
            "bound_ms": bound, "bound_by": by, "shape": [n, k], "dtype": tn,
            "chunks": syrk.leaf_chunk(n, k, syrk.leaf_block(a.dtype,
                                                            c.dtype))}
    return checks, {**timing["f32"], "bf16": timing["bf16"]}


def kernel_syrk_packed(rates, gen, n):
    """syrk_packed at tests/test_kernels.py's shapes (ragged n and k
    included) and at n = k = 8192 for every type pair, each on the route
    its plan gives (ops.SYRK_PACKED_ROUTES); int8 bitwise against exact
    sums with the epilogue's rounding; the f32 sums bitwise qgemm's on the
    CUDA cores (one pass, fma in k order from +0); and the triangular
    decode."""
    from repro_torch.kernels import ops, qgemm, ref, syrk
    checks = []
    count = 200000
    i, j = (t.cpu().numpy().astype(np.int64) for t in syrk.tri_decode(count))
    if not (np.array_equal(i * (i + 1) // 2 + j, np.arange(count))
            and (j <= i).all() and (j >= 0).all()):
        raise AssertionError("tri_decode is not exact below 200000")
    checks.append({"case": "tri_decode t < 200000 vs numpy integer "
                   "arithmetic", "exact": True})

    def packed(c, a, scale, beta, out=None):
        res, p = syrk.packed_launch(c, a, scale, beta, out=out)
        routes.append(p.route)
        return res

    def exact_int8(c, a, scale, beta):
        """int8's exact sums (f64 holds them) in f32, then the epilogue
        (s * scale) + (beta * c) on the lower triangle."""
        s = (a.double() @ a.double().T).float()
        lo = torch.ones_like(c, dtype=torch.bool).tril()
        return torch.where(lo, s * scale + beta * c, c)

    def one(what, tn, m, k, scale, beta, amp=1.0):
        c, a = _syrk_operands(gen, m, k, tn, amp)
        routes.clear()
        before = dict(ops.SYRK_PACKED_ROUTES)
        ops.syrk(c, a, scale, beta, packed=True)
        err, atol = _syrk_check(what, packed, c, a, scale, beta)
        major = qgemm.layout(m, k, *a.stride(), a.element_size(),
                             a.data_ptr() % qgemm.ALIGN)[0]
        route = syrk.packed_plan(m, k, a.dtype, c.dtype, major).route
        want = ("simt" if a.dtype not in syrk.TC_DTYPES else
                "tc" if major == "k" else "tc_staged")
        if set(routes) != {route} or route != want or \
                ops.SYRK_PACKED_ROUTES[route] != before[route] + 1:
            raise AssertionError(f"{what}: routes {routes}, plan {route}, "
                                 f"expected {want}")
        line = {"shape": [m, k], "dtype": tn, "route": route,
                "max_abs_err": err, "tol": f"{_SYRK_TOL} = {atol:g}",
                "upper_kept_inplace_deterministic": True}
        if tn == "int8":
            got = syrk.syrk_packed(c, a, scale, beta)
            if not torch.equal(got, exact_int8(c, a, scale, beta)):
                raise AssertionError(f"{what}: int8 not the exact sums' "
                                     "epilogue")
            line["exact_sums_bitwise"] = True
        return line, c, a, err, atol

    routes = []
    # (300, 256): a tensor-core tile whose second B box and lower half
    # lie wholly past n
    for (m, k) in [(512, 256), (640, 300), (500, 513), (256, 128),
                   (1000, 512), (300, 256)]:
        for tn in _SYRK_TYPES:
            scale = torch.tensor(0.7, device="cuda")
            checks.append(one(f"syrk_packed {tn} {m}x{k}", tn, m, k, scale,
                              0.9)[0])
    # main: n = k = 8192, every type pair, timed
    m = k = n // 2
    timing = {}
    for tn in _SYRK_TYPES:
        line, c, a, err, atol = one(f"syrk_packed main {tn}", tn, m, k, -1.0,
                                    1.0, amp=1 / 64)
        checks.append({**line, "case": "main"})
        out = c.clone()
        rate = _SYRK_RATE[tn]
        bound, by = bound_ms(m * (m + 1.0) * k,
                             a.element_size() * m * k
                             + 2 * c.element_size() * m * (m + 1) / 2,
                             rate, rates)
        lib, label = _syrk_library(c, a, tn)
        timing[tn] = {
            "max_abs_err": err, "tol": f"{_SYRK_TOL} = {atol:g}",
            "route": line["route"],
            "ms": cuda_ms(lambda: syrk.syrk_packed(c, a, -1.0, 1.0, out=out),
                          reps=3, warmup=1),
            "plain_ms": cuda_ms(lambda: ref.syrk_ref(c, a, scale=-1.0),
                                reps=3, warmup=1),
            "library_ms": cuda_ms(lib, reps=3, warmup=1), "library": label,
            "bound_ms": bound, "bound_by": by, "rate": rate,
            "shape": [m, k], "dtype": tn}
        if tn == "f32":
            # the sums of the simt route are fma in k order from +0, as
            # qgemm's one-pass SIMT tile sums them: the same bits
            zero = torch.zeros_like(c)
            lo = torch.ones_like(c, dtype=torch.bool).tril()
            q, qp = qgemm.launch(a, a, trans_b=True)
            same = torch.equal(syrk.syrk_packed(zero, a, 1.0, 0.0)[lo], q[lo])
            if qp.chunks != 1 or not same:
                raise AssertionError("syrk_packed f32 sums differ from "
                                     f"qgemm's one-pass ({qp.route})")
            timing[tn]["sums_bitwise_qgemm_simt"] = True
            del q, zero, lo
        del c, a, out
        torch.cuda.empty_cache()
    return checks, {**timing["f32"], "types": timing}


def _flash_atol(q, k, v):
    """|kernel - plain| for one attention: the score is two f32 sums of hd
    products in other orders (``_gamma_atol`` with Cauchy-Schwarz's
    max|q_i| max|k_j| hd^-0.5 for the sum of |products|); a score error ds
    moves each softmax weight by a factor within 1 +- (ds + 4u), which
    moves the output, a convex combination of rows of v, by at most
    2 (ds + 4u) max|v|; the sums of p v and of p over up to T terms in
    other orders, across other block boundaries, add 2 (T + 2) u max|v|
    each; the rescalings and the division a few units more."""
    u = 2.0 ** -24
    hd, T = q.shape[-1], k.shape[-3]
    sdot = (float(q.float().norm(dim=-1).max())
            * float(k.float().norm(dim=-1).max()) * hd ** -0.5)
    ds = _gamma_atol(hd, u, sdot)
    return float(v.float().abs().max()) * (2 * ds + 4 * (T + 2) * u + 16 * u)


#: 16-bit outputs: each side rounds once to its type, up to one unit of
#: the last place of |out| apart: 2^-7 in bf16, 2^-10 in f16
_BF16_RTOL = 2.0 ** -7
_F16_RTOL = 2.0 ** -10
_RTOL = {torch.bfloat16: _BF16_RTOL, torch.float16: _F16_RTOL,
         torch.float32: 0.0}
_TNAME = {torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32"}
_FLASH_TOL = ("atol max|v| (2 ds + 4 (T + 2) u + 16 u), ds = 2 (hd + 2) u "
              "max|q| max|k| hd^-0.5, u = 2^-24; bf16 adds rtol 2^-7, "
              "f16 2^-10")
#: The derived atol is a worst case (Cauchy-Schwarz on the scores, every
#: rounding of a T-term sum the same way) and at gemma's shape is 1e-2,
#: while a late row's |out| is a few 1e-2: a defect confined to rows far
#: from the diagonal could hide under it. So each case is also held to a
#: data-scaled atol of 256 u max|v|, the typical (random-walk) growth of
#: the same sums, sqrt(hd) + sqrt(T) <= 107 units at most here, with room
#: over the f32 readings (under 3 u max|v| at every shape, this script
#: on an NVIDIA H100 80GB HBM3 at 700 W). In a 16-bit type each side
#: rounds its f32 value to within half a unit of the last place, and the
#: unrounded value is within 1 / (1 - rtol / 2) of the rounded |out|:
#: rtol (1 + rtol) on top.
_FLASH_DATA_ULPS = 256
_FLASH_DATA_TOL = ("atol 256 u max|v|, u = 2^-24; bf16 adds rtol "
                   "2^-7 (1 + 2^-7), f16 2^-10 (1 + 2^-10)")


@functools.cache
def _tc_emulation():
    """tests/test_torch_flash.py, which holds the plain-torch emulation of
    flash_tc's arithmetic (with its one-pass-p variant) and the gate on
    the share of rounded outputs that differ from the plain version's: the
    two atols above are wider than what a one-pass p (2^-8 of itself in
    bf16) does to a 16-bit output, so each 16-bit case is also held to
    that share, and the emulation's one-pass p, on the same inputs, must
    exceed it."""
    spec = importlib.util.spec_from_file_location(
        "test_torch_flash", ROOT / "tests" / "test_torch_flash.py")
    mod = importlib.util.module_from_spec(spec)
    threads = torch.get_num_threads()
    spec.loader.exec_module(mod)
    torch.set_num_threads(threads)  # the CPU suite pins 2
    return mod


def _flash_case(gen, B, S, H, KV, hd, dt, T=None, causal=True, bq=256,
                bk=256, strided=False):
    """The kernel through ops' batched form against flash_ref with the
    reference's blocks, on [B, S, H, hd] and [B, T, KV, hd] operands
    (``strided``: each cut from [B, n + 3, heads + 1, hd + 16], every
    base and stride still a multiple of 16 bytes in a 16-bit type)."""
    from repro_torch.kernels import flash, ref
    T = S if T is None else T
    qkv = []
    for (n, heads) in ((S, H), (T, KV), (T, KV)):
        if strided:
            x = torch.randn((B, n + 3, heads + 1, hd + 16), generator=gen,
                            device="cuda").to(dt)[:, 2:-1, 1:, 8:-8]
        else:
            x = torch.randn((B, n, heads, hd), generator=gen,
                            device="cuda").to(dt)
        qkv.append(x)
    q, k, v = qkv
    got = flash.flash_attention_bshd(q, k, v, causal=causal, bk=bk)
    want = ref.flash_ref(q, k, v, causal=causal, bq=bq, bk=bk)
    atol = _flash_atol(q, k, v)
    data_atol = _FLASH_DATA_ULPS * 2.0 ** -24 * float(v.float().abs().max())
    rtol = _RTOL[dt]
    tn = _TNAME[dt]
    what = f"flash {tn} B={B} S={S} T={T} H={H} KV={KV} hd={hd} " \
           f"causal={causal}" + (" strided" if strided else "")
    if got.dtype != dt:
        raise AssertionError(f"{what}: output dtype {got.dtype}")
    err = check_close(what, got, want, rtol, atol)
    check_close(f"{what} (data-scaled)", got, want, rtol * (1 + rtol),
                data_atol)
    # the error of each output row over that row's own max |out|
    diff = (got.double() - want.double()).abs().amax(dim=-1)
    row_rel = float((diff / want.double().abs().amax(dim=-1)
                     .clamp_min(1e-30)).max())
    chk = {"shape": [B, S, T, H, KV, hd], "dtype": tn, "causal": causal,
           "strided": strided, "max_abs_err": err, "atol": atol,
           "data_atol": data_atol, "rtol": rtol, "row_rel_err": row_rel}
    if dt != torch.float32:
        emu = _tc_emulation()
        share = emu.mismatch_share(got, want)
        control = emu.mismatch_share(
            emu._tc_emulation(q, k, v, causal=causal, one_pass=True).to(dt),
            want)
        if not share <= emu.MISMATCH_SHARE < control:
            raise AssertionError(
                f"{what}: {share:.5f} of the rounded outputs differ from "
                f"flash_ref's, {control:.5f} with a one-pass p; the gate "
                f"needs <= {emu.MISMATCH_SHARE} < the latter")
        chk.update({"mismatch_share": share,
                    "one_pass_mismatch_share": control})
    return (q, k, v), chk


def _flash_refusals():
    """bf16 operands TMA cannot take raise ValueError naming the reason,
    and launch nothing: a base address off 16 bytes, and a head stride of
    65 elements (130 bytes)."""
    from repro_torch.kernels import ops
    bf = torch.bfloat16
    ok = torch.zeros((1, 128, 2, 64), device="cuda", dtype=bf)
    off = torch.zeros((1, 128, 2, 65), device="cuda", dtype=bf)[..., 1:]
    odd = torch.zeros((1, 128, 16, 65), device="cuda", dtype=bf)[
        :, :, :2, :64]
    cases = {"base address": (off, ok, ok), "head stride": (ok, odd, ok)}
    before = flash_launches(bf)
    for reason, (q, k, v) in cases.items():
        try:
            ops.flash_attention_bshd(q, k, v)
        except ValueError as e:
            if reason not in str(e) or "16 bytes" not in str(e):
                raise AssertionError(f"flash refusal: {reason!r} raised "
                                     f"{e!r}") from e
        else:
            raise AssertionError(f"flash refusal: {reason} was accepted")
    if flash_launches(bf) != before:
        raise AssertionError("flash refusal: a refused call was counted")
    return sorted(cases)


def kernel_flash(rates, gen):
    """flash_attention against flash_ref on both routes (bf16 and f16 on
    the tensor-core kernel, f32 on the SIMT one): tests/test_flash.py's
    shapes (S = 300 for the padding, bq = bk = 128), every head dim of the
    dense configs in all three types, S != T and a full (non-causal) call
    in all three, a strided 16-bit view whose rows TMA can take, and the
    refusal of two that it cannot; and every prefill shape the model
    phases give it: gemma-2b's B = 4, S = 2048 and 1 x 8192 (H = 8,
    KV = 1, hd = 256, bf16), its contract's 4 x 1023, the f32 2-layer
    run's 2 x 256 .. 263, nemotron-4-15b's 1 x 4096 and 1 x 1023 (H = 48,
    KV = 8, hd = 128), and hd = 192 (nemotron-4-340b's, G = 12); the
    vlm, audio and moe phases' (_ZOO_TIMED, _ZOO_PREFILLS), and
    zamba2-2.7b's hd 80 (H = KV = 32) on both routes, timed at its
    prefill (_HD80_TIMED) in bf16, f16 and f32; times of each route's
    kernel, the plain version and SDPA beside the card's least time."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash, ref
    checks = []
    bf, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    for (H, KV, S, hd) in [(4, 4, 256, 64), (8, 2, 256, 128), (4, 1, 300, 64),
                           (2, 2, 512, 32)]:
        for dt in (f32, bf, f16):
            checks.append(_flash_case(gen, 1, S, H, KV, hd, dt, bq=128,
                                      bk=128)[1])
    for hd in flash.HEAD_DIMS:
        for dt in (f32, bf, f16):
            checks.append(_flash_case(gen, 2, 300, 6, 2, hd, dt)[1])
    for (S, T, causal) in [(128, 256, True), (256, 100, True),
                           (200, 256, False), (300, 77, True)]:
        for dt in (f32, bf, f16):
            checks.append(_flash_case(gen, 2, S, 4, 2, 64, dt, T=T,
                                      causal=causal, bk=64)[1])
    for dt in (bf, f16):
        checks.append(_flash_case(gen, 2, 200, 4, 2, 64, dt,
                                  strided=True)[1])
        checks.append(_flash_case(gen, 2, 200, 4, 2, 128, dt, causal=False,
                                  bk=200, strided=True)[1])
    checks.append(_flash_case(gen, 1, 1024, 24, 2, 192, bf)[1])
    # the other prefills of the model phases (the timed ones follow)
    for (B, S, H, KV, hd, dt) in [(1, 8192, 8, 1, 256, bf),
                                  (4, 1023, 8, 1, 256, bf),
                                  (2, 256, 8, 1, 256, f32),
                                  (2, 263, 8, 1, 256, f32),
                                  (1, 1023, 48, 8, 128, bf)] + _ZOO_PREFILLS:
        checks.append(_flash_case(gen, B, S, H, KV, hd, dt)[1])
        torch.cuda.empty_cache()
    refusals = _flash_refusals()

    def timed(gen, B, S, H, KV, hd, dt, reps):
        (q, k, v), chk = _flash_case(gen, B, S, H, KV, hd, dt)
        esz = q.element_size()
        # the function's operations; the bound counts no more
        flops = 4.0 * B * H * hd * S * (S + 1) / 2
        nbytes = esz * hd * (2 * B * S * H + 2 * B * S * KV)
        route = flash.route(dt)
        bound, by = bound_ms(flops, nbytes,
                             "bf16" if route == "flash_tc" else "f32", rates)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms = cuda_ms(lambda: flash.flash_attention_bshd(q, k, v), reps=reps)
        line = {
            "route": route,
            "max_abs_err": chk["max_abs_err"],
            "tol": f"{_FLASH_TOL} = {chk['atol']:g}; {_FLASH_DATA_TOL} "
                   f"= {chk['data_atol']:g}",
            "ms": ms,
            "plain_ms": cuda_ms(lambda: ref.flash_ref(q, k, v),
                                reps=3, warmup=1),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), reps=reps),
            "library": "F.scaled_dot_product_attention(is_causal=True, "
                       "enable_gqa=True) on [B, H, S, hd] views",
            "bound_ms": bound, "bound_by": by, "gflop": flops / 1e9,
            "tflop_per_s": flops / ms / 1e9,
            "shape": [B, S, H, KV, hd], "dtype": _TNAME[dt]}
        if route == "flash_tc":
            # the kernel's own cost: p v runs twice (p_hi and p_lo), 1.5x
            # the function's tensor-core work, for a p of f32 accuracy
            split = 1.5
            line.update({
                "split_work_factor": split,
                "tensor_tflop_per_s": split * flops / ms / 1e9,
                "mismatch_share": chk["mismatch_share"],
                "one_pass_mismatch_share": chk["one_pass_mismatch_share"]})
        return chk, line

    main_chk, main = timed(gen, 4, 2048, 8, 1, 256, bf, 20)
    f16_chk, f16_t = timed(gen, 4, 2048, 8, 1, 256, f16, 20)
    f32_chk, f32_t = timed(gen, 4, 2048, 8, 1, 256, f32, 10)
    gqa_chk, gqa = timed(gen, 1, 4096, 48, 8, 128, bf, 20)
    checks += [main_chk, f16_chk, f32_chk, gqa_chk]
    torch.cuda.empty_cache()
    zoo = {}
    for arch, shape in _ZOO_TIMED.items():
        chk, zoo[arch] = timed(gen, *shape, bf, 10)
        checks.append(chk)
        torch.cuda.empty_cache()
    # zamba2's shared attention block, hd 80, on both routes
    hd80 = {}
    for dt, reps in ((bf, 20), (f16, 20), (f32, 10)):
        chk, hd80[_TNAME[dt]] = timed(gen, *_HD80_TIMED, dt, reps)
        checks.append(chk)
        torch.cuda.empty_cache()
    zoo["zamba2-2.7b"] = {**hd80.pop("bf16"), **hd80}
    return checks, {**main, "f16": f16_t, "f32": f32_t,
                    "nemotron-4-15b": gqa, **zoo, "refusals": refusals}


#: the vlm, audio and moe phases' timed prefills (B, S, H, KV, hd):
#: MLA runs flash with H = KV and head dim dn + dr = 192, v padded to it
_ZOO_TIMED = {"deepseek-v2-lite-16b": (4, 2048, 16, 16, 192),
              "deepseek-v3-671b": (1, 4096, 128, 128, 192),
              "pixtral-12b": (2, 4096, 32, 8, 128),
              "musicgen-large": (4, 2048, 32, 32, 64)}
#: zamba2-2.7b's timed prefill (B, S, H, KV, hd): its shared attention
#: block, d 2560 over 32 heads of 80
_HD80_TIMED = (4, 2048, 32, 32, 80)
#: their other prefills: each contract's length - 1 (zamba2's: its
#: prefix of 896 and the full 1024), the f32 2-layer runs' 2 x 256 ..
#: 263 (pixtral's 2 x 512 .. 519; zamba2's 2 x 120 .. 127, 128 and 256),
#: the smoke configs' 2 x 48 on the card
_ZOO_PREFILLS = (
    [(4, 1023, 16, 16, 192, torch.bfloat16),
     (1, 1023, 128, 128, 192, torch.bfloat16),
     (2, 1023, 32, 8, 128, torch.bfloat16),
     (4, 1023, 32, 32, 64, torch.bfloat16),
     (4, 896, 32, 32, 80, torch.bfloat16),
     (4, 1024, 32, 32, 80, torch.bfloat16)]
    + [(2, S, H, KV, hd, torch.float32) for (S, H, KV, hd) in (
        (256, 16, 16, 192), (263, 16, 16, 192), (512, 32, 8, 128),
        (519, 32, 8, 128), (256, 32, 32, 64), (263, 32, 32, 64),
        (120, 32, 32, 80), (127, 32, 32, 80), (128, 32, 32, 80),
        (256, 32, 32, 80))]
    + [(2, 48, H, KV, hd, torch.float32)
       for (H, KV, hd) in ((4, 2, 16), (4, 4, 16), (4, 4, 64))])


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------
def residual(a, x, b, rows=4096):
    """||b - A x|| / ||b|| in f64 on the card, A in row blocks."""
    xd, bd = x.double(), b.double()
    if xd.dim() == 1:
        xd, bd = xd[:, None], bd[:, None]
    num = 0.0
    for r0 in range(0, a.shape[0], rows):
        r = bd[r0:r0 + rows] - a[r0:r0 + rows].double() @ xd
        num += float((r * r).sum())
    return math.sqrt(num) / float(bd.norm())


def panel_routes(cfg, n):
    """The lower tile pairs of one blocked factor's panel updates by the
    route each must take, counted from the plan's names alone: the tensor
    cores for every f16, bf16 and int8 pair of an f32 container at leaf
    128 or 256, the CUDA cores for every other pair."""
    from repro_torch.core.plan import build_plan
    plan = build_plan(n, cfg)
    T = plan.ntiles
    tc_ok = cfg.high_dtype == torch.float32 and cfg.leaf in (128, 256)
    got = {"tc": 0, "simt": 0}
    for i in range(1, T):
        for j in range(1, i + 1):
            # pair (i, j) is updated by panels 0 .. j - 1 at its own name
            on_tc = tc_ok and plan.name(i, j) in ("f16", "bf16", "int8")
            got["tc" if on_tc else "simt"] += j
    return got


def path_run(name, n, seed):
    """cholesky_solve with 16 right-hand sides and with one vector, then
    the factor and the solves timed apart, on the paper matrix."""
    import repro_torch as rt
    from repro_torch.kernels import ops
    cfg = rt.PAPER_CONFIGS[name]
    high = cfg.high_dtype
    a = paper_matrix(n, seed, high)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    b16 = torch.randn((n, 16), generator=g, device="cuda", dtype=high)
    b1 = torch.randn((n,), generator=g, device="cuda", dtype=high)
    T = n // cfg.leaf
    # T - 1 tri_inv_leaf in the factor, and diag_tri_inv's T tiles in one
    # batched launch
    schedule = {**dict.fromkeys(ops.LAUNCHES, 0), "potrf_leaf": T,
                "tri_inv_leaf": T, "panel_update": T - 1,
                "qgemm": 2 * (2 * T - 1)}
    line = {"phase": "path", "ladder": name, "n": n, "leaf": cfg.leaf,
            "dtype": str(high).replace("torch.", "")}
    want_routes = panel_routes(cfg, n)
    counts = {}
    for label, rhs in (("k16", b16), ("k1", b1)):
        before = dict(ops.LAUNCHES)
        routes_before = dict(ops.PANEL_ROUTES)
        tiles_before = ops.TILES["tri_inv_leaf"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        x = rt.cholesky_solve(a, rhs, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES}
        counts[label] = got
        if got != schedule:
            raise AssertionError(f"{name} n={n} {label}: launches {got} "
                                 f"!= schedule {schedule}")
        routes = {k: ops.PANEL_ROUTES[k] - routes_before[k]
                  for k in routes_before}
        if routes != want_routes:
            raise AssertionError(f"{name} n={n} {label}: panel pairs by "
                                 f"route {routes} != {want_routes}")
        tiles = ops.TILES["tri_inv_leaf"] - tiles_before
        if tiles != 2 * T - 1:
            raise AssertionError(f"{name} n={n} {label}: {tiles} tiles "
                                 f"inverted, not {2 * T - 1}")
        if not bool(torch.isfinite(x).all()) or x.shape != rhs.shape:
            raise AssertionError(f"{name} n={n} {label}: bad result")
        res = residual(a, x, rhs)
        line[f"cholesky_solve_{label}_wall_s"] = wall
        line[f"residual_{label}"] = res
        line[f"digits_{label}"] = -math.log10(max(res, 1e-300))
        line[f"peak_mem_gib_{label}"] = (torch.cuda.max_memory_allocated()
                                         / 2 ** 30)
    line["launches_per_cholesky_solve"] = counts["k16"]
    line["panel_routes_per_factor"] = want_routes
    line["schedule"] = schedule
    line["tri_inv_tiles_per_cholesky_solve"] = 2 * T - 1
    # factor and solves timed apart by CUDA events (after the warm-up
    # above); these launches count too
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    mem0 = torch.cuda.memory_stats()
    t0 = time.perf_counter()
    start.record()
    lp = rt.cholesky_padded(a, cfg)
    stop.record()
    torch.cuda.synchronize()
    line["factor_ms"] = start.elapsed_time(stop)
    # the host's view of the same call, and the caching allocator's device
    # allocations and retries inside it (a factor_ms far above the device
    # time of a profiled factor is the host or the allocator)
    line["factor_host_ms"] = (time.perf_counter() - t0) * 1e3
    mem1 = torch.cuda.memory_stats()
    line["factor_allocator"] = {
        k: mem1.get(k, 0) - mem0.get(k, 0)
        for k in ("num_device_alloc", "num_device_free",
                  "num_alloc_retries")}
    for label, rhs in (("k16", b16), ("k1", b1)):
        start.record()
        rt.solve_factored(lp, rhs, cfg)
        stop.record()
        torch.cuda.synchronize()
        line[f"solve_ms_{label}"] = start.elapsed_time(stop)
    floor = DIGITS_FLOOR.get(name)
    if floor is not None:
        for label in ("k16", "k1"):
            digits = line[f"digits_{label}"]
            if digits < floor:
                raise AssertionError(f"{name} n={n}: {digits:.2f} digits "
                                     f"< floor {floor}")
    line["digits_floor"] = floor
    del a, lp
    torch.cuda.empty_cache()
    return line


# ---------------------------------------------------------------------------
# phase 4: the tree engine
# ---------------------------------------------------------------------------
def tree_schedule(cfg, n):
    """Launches of one tree factor and of one two-sweep solve, counted by
    walking the recursion of core/tree.py with ``cfg.split``."""
    from repro_torch.kernels import ops
    fac = dict.fromkeys(ops.LAUNCHES, 0)
    sol = dict.fromkeys(ops.LAUNCHES, 0)

    def walk(m, counts, leaf_keys):
        """A recursion over m (tree_trsm, tree_syrk, tree_trsm_left): one
        qgemm per internal node, ``leaf_keys`` per leaf."""
        if m <= cfg.leaf:
            for key in leaf_keys:
                counts[key] += 1
            return
        counts["qgemm"] += 1
        m1 = cfg.split(m)
        walk(m1, counts, leaf_keys)
        walk(m - m1, counts, leaf_keys)

    def potrf(m):
        if m <= cfg.leaf:
            fac["potrf_leaf"] += 1
            return
        m1 = cfg.split(m)
        potrf(m1)
        walk(m1, fac, ("tri_inv_leaf", "trsm_leaf"))     # L21 = A21 L11^-T
        walk(m - m1, fac, ("syrk_leaf",))                # A22 -= L21 L21^T
        potrf(m - m1)

    potrf(n)
    for _ in range(2):                                   # the two sweeps
        walk(n, sol, ("tri_inv_leaf", "qgemm"))
    return fac, sol


def _diff(before):
    from repro_torch.kernels import ops
    return {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES}


def tree_path_run(name, n, seed):
    """cholesky_solve(..., engine="tree") with 16 right-hand sides and with
    one vector, the factor and the solves timed apart, each call's
    launches against the schedule, and the tree factor against the blocked
    factor of the same matrix."""
    import repro_torch as rt
    from repro_torch.kernels import ops
    base = rt.PAPER_CONFIGS[name]
    cfg = dataclasses.replace(base, engine="tree")
    high = cfg.high_dtype
    a = paper_matrix(n, seed, high)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    b16 = torch.randn((n, 16), generator=g, device="cuda", dtype=high)
    b1 = torch.randn((n,), generator=g, device="cuda", dtype=high)
    fac, sol = tree_schedule(cfg, n)
    both = {k: fac[k] + sol[k] for k in fac}
    line = {"phase": "tree_path", "ladder": name, "engine": "tree", "n": n,
            "leaf": cfg.leaf, "depth": cfg.depth(n),
            "dtype": str(high).replace("torch.", "")}
    for label, rhs in (("k16", b16), ("k1", b1)):
        before = dict(ops.LAUNCHES)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        x = rt.cholesky_solve(a, rhs, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = _diff(before)
        if got != both:
            raise AssertionError(f"tree {name} n={n} {label}: launches {got} "
                                 f"!= schedule {both}")
        if not bool(torch.isfinite(x).all()) or x.shape != rhs.shape:
            raise AssertionError(f"tree {name} n={n} {label}: bad result")
        res = residual(a, x, rhs)
        line[f"cholesky_solve_{label}_wall_s"] = wall
        line[f"residual_{label}"] = res
        line[f"digits_{label}"] = -math.log10(max(res, 1e-300))
        line[f"peak_mem_gib_{label}"] = (torch.cuda.max_memory_allocated()
                                         / 2 ** 30)
    line["schedule_factor"] = fac
    line["schedule_solve"] = sol
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    before = dict(ops.LAUNCHES)
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    start.record()
    lt = rt.cholesky_padded(a, cfg)
    stop.record()
    torch.cuda.synchronize()
    line["factor_ms"] = start.elapsed_time(stop)
    line["factor_peak_gib_over_input"] = (
        (torch.cuda.max_memory_allocated() - base_mem) / 2 ** 30)
    if _diff(before) != fac:
        raise AssertionError(f"tree {name}: factor launches {_diff(before)}")
    for label, rhs in (("k16", b16), ("k1", b1)):
        before = dict(ops.LAUNCHES)
        start.record()
        rt.solve_factored(lt, rhs, cfg)
        stop.record()
        torch.cuda.synchronize()
        line[f"solve_ms_{label}"] = start.elapsed_time(stop)
        if _diff(before) != sol:
            raise AssertionError(f"tree {name}: solve launches "
                                 f"{_diff(before)}")
    # the reference's equivalence test (tests/test_blocked.py:47) at size
    lb = rt.cholesky_padded(a, base)
    rel = float((lt.double() - lb.double()).abs().max()
                / lb.double().abs().max())
    tol = TOL[cfg.levels[0]]
    line["vs_blocked_rel"] = rel
    line["vs_blocked_tol"] = tol
    if not rel < tol:
        raise AssertionError(f"tree {name} n={n}: vs blocked {rel:g} >= "
                             f"{tol:g}")
    floor = TREE_DIGITS_FLOOR.get(name)
    if floor is not None:
        for label in ("k16", "k1"):
            if line[f"digits_{label}"] < floor:
                raise AssertionError(f"tree {name} n={n}: "
                                     f"{line[f'digits_{label}']:.2f} digits "
                                     f"< floor {floor}")
    line["digits_floor"] = floor
    del a, lt, lb
    torch.cuda.empty_cache()
    return line


def tree_packed_run(name, n, seed):
    """tree_potrf_packed on TreeSPD.from_dense: the packed factor's bytes
    against storage_ratio (plus one f32 scale per panel) and the packed
    factor against the dense tree factor of the same matrix."""
    import repro_torch as rt
    cfg = dataclasses.replace(rt.PAPER_CONFIGS[name], engine="tree")
    a = paper_matrix(n, seed)
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    start.record()
    packed = rt.TreeSPD.from_dense(a, cfg)
    lp = rt.tree_potrf_packed(packed, cfg)
    stop.record()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base_mem) / 2 ** 30
    panels = n // cfg.leaf - 1            # one per internal node
    want = rt.storage_ratio(n, cfg) * n * n * 4 + 4 * panels
    got = lp.nbytes()
    if got != want or packed.nbytes() != want:
        raise AssertionError(f"packed {name}: nbytes {got}, "
                             f"{packed.nbytes()} != accounting {want}")
    dense = lp.to_dense()
    lt = rt.cholesky_padded(a, cfg)
    rel = float((dense.double() - lt.double()).abs().max()
                / lt.double().abs().max())
    tol = TOL[cfg.levels[0]]
    if not rel < tol or not bool(torch.isfinite(dense).all()):
        raise AssertionError(f"packed {name}: vs dense tree {rel:g} >= "
                             f"{tol:g}")
    line = {"phase": "tree_packed", "ladder": name, "n": n,
            "nbytes": got, "dense_f32_bytes": n * n * 4,
            "storage_ratio": rt.storage_ratio(n, cfg),
            "nbytes_equals_accounting": True,
            "from_dense_and_factor_ms": start.elapsed_time(stop),
            "peak_gib_over_input": peak,
            "vs_dense_tree_rel": rel, "tol": tol}
    del a, packed, lp, dense, lt
    torch.cuda.empty_cache()
    return line


def syrk_race(n, seed):
    """The paper's Fig. 4 race (benchmarks/bench_syrk.py) at the tree
    factor's top-level trailing update: C - A A^T with C, A (n/2, n/2),
    tree-SYRK (pure_f32: syrk_leaf + qgemm) against the flat syrk_packed
    through ops.syrk(packed=True)."""
    import repro_torch as rt
    from repro_torch.kernels import ops
    m = n // 2
    cfg = dataclasses.replace(rt.PAPER_CONFIGS["pure_f32"], engine="tree")
    c = paper_matrix(m, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    a = torch.randn((m, m), generator=g, device="cuda") / 64
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    out = {}
    for label, fn in (
            ("tree", lambda: rt.tree_syrk(c, a, alpha=-1.0, beta=1.0,
                                          cfg=cfg)),
            ("packed", lambda: ops.syrk(c, a, -1.0, 1.0, packed=True))):
        fn()                                   # warm
        start.record()
        res = fn()
        stop.record()
        torch.cuda.synchronize()
        out[label] = (start.elapsed_time(stop), res)
    lo = torch.ones((m, m), dtype=torch.bool, device="cuda").tril()
    diff = float((out["tree"][1] - out["packed"][1]).abs()[lo].max())
    atol = _gamma_atol(m, 2.0 ** -24, float((a * a).sum(dim=1).max())
                       + float(c.abs().max()))
    if not diff <= atol:
        raise AssertionError(f"syrk race: tree vs packed {diff:g} > {atol:g}")
    line = {"phase": "syrk_race", "n": m, "k": m, "ladder": "pure_f32",
            "tree_ms": out["tree"][0], "packed_ms": out["packed"][0],
            "tree_vs_packed_max_abs": diff, "tol": atol}
    del c, a, out
    torch.cuda.empty_cache()
    return line


# ---------------------------------------------------------------------------
# phase 5: refinement
# ---------------------------------------------------------------------------
def refine_run(name, n, seed, *, method="ir", residual_dtype="f64",
               engine="blocked"):
    """refine_solve with 16 right-hand sides against a cached factor (and
    the blocked engine's diagonal inverses), at most 10 sweeps to 1e-10;
    the launches of the call are checked against the sweep schedule: per
    loop iteration one residual and one correction solve (254 qgemm at
    T = 64, plus 128 tri_inv_leaf on the tree engine, which caches no
    inverses), GMRES-IR adding gmres_restart solves per restart."""
    import repro_torch as rt
    from repro_torch.core import scaled_solve
    from repro_torch.kernels import ops
    cfg = dataclasses.replace(rt.PAPER_CONFIGS[name], engine=engine)
    a = paper_matrix(n, seed, cfg.high_dtype)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    b = torch.randn((n, 16), generator=g, device="cuda", dtype=cfg.high_dtype)
    lp = rt.cholesky_padded(a, cfg)
    linvs = rt.diag_tri_inv(lp, cfg) if engine == "blocked" else None
    x0 = rt.solve_factored(lp, b, cfg, linvs=linvs)
    rcfg = rt.RefineConfig(max_sweeps=10, tol=1e-10, method=method,
                           residual_dtype=residual_dtype)
    before = dict(ops.LAUNCHES)
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    res = rt.refine_solve(a, b, cfg, refine=rcfg, l=lp, linvs=linvs)
    stop.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    got = {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES}
    sweeps = res.iterations.cpu().tolist()
    loops = max(sweeps)
    T = n // cfg.leaf
    solves = 1 + loops * (rcfg.gmres_restart + 1 if method == "gmres" else 1)
    per_solve = (tree_schedule(cfg, n)[1] if engine == "tree" else
                 {**dict.fromkeys(ops.LAUNCHES, 0), "qgemm": 2 * (2 * T - 1)})
    schedule = {k: v * solves for k, v in per_solve.items()}
    schedule["residual_fused"] = loops + 1
    if got != schedule:
        raise AssertionError(f"refine {name} {method}: launches {got} != "
                             f"schedule {schedule}")
    if not bool(torch.isfinite(res.x).all()) or res.x.shape != b.shape:
        raise AssertionError(f"refine {name} {method}: bad result")
    before_d = [-math.log10(residual(a, x0[:, j], b[:, j])) for j in range(16)]
    after_d = [-math.log10(max(residual(a, res.x[:, j], b[:, j]), 1e-300))
               for j in range(16)]
    converged = res.converged.cpu().tolist()
    # one sweep as the loop runs it: the scaled correction solve, the
    # update and the fused residual, on this run's (n, 16) block
    rdt = rcfg.rdtype()
    a_r, b_r, x_r = a.to(rdt), b.to(rdt), res.x

    def base(r):
        return rt.solve_factored(lp, r.to(lp.dtype), cfg,
                                 linvs=linvs).to(rdt)

    correct = scaled_solve(base)
    counted = dict(ops.LAUNCHES)          # timing launches are not the path's
    r = ops.residual(a_r, x_r, b_r)
    sweep_ms = cuda_ms(lambda: ops.residual(a_r, x_r + correct(r), b_r),
                       reps=5, warmup=1)
    ops.LAUNCHES.update(counted)
    line = {"phase": "refine", "ladder": name, "engine": engine, "n": n,
            "k": 16, "method": method, "residual_dtype": residual_dtype,
            "tol": rcfg.tol, "max_sweeps": rcfg.max_sweeps,
            "sweeps_per_column": sweeps, "converged": converged,
            "digits_before_min": min(before_d),
            "digits_after_min": min(after_d),
            "digits_after_max": max(after_d),
            "refine_wall_ms": wall_ms,
            "refine_device_ms": start.elapsed_time(stop),
            "sweep_ms": sweep_ms, "launches": got, "schedule": schedule}
    if residual_dtype == "f64":
        if not all(converged) or min(after_d) < 10:
            raise AssertionError(f"refine {name} {method}: not every "
                                 f"column reached 1e-10: {line}")
    elif any(aft < bef for aft, bef in zip(after_d, before_d)):
        raise AssertionError(f"refine {name}: f32-residual refinement made "
                             f"a column worse: {line}")
    del a, lp, linvs, a_r
    torch.cuda.empty_cache()
    return line


# ---------------------------------------------------------------------------
# phase 5: solve serving
# ---------------------------------------------------------------------------
#: kernel-name fragments of the profiler's device events, by port kernel
#: (potrf_kernel<T, resident, vec> and tri_inv_kernel<T, resident, vec>,
#: whose batched entry launches the same kernel over a grid of tiles)
_SPANS = (("flash_tc", "flash_attention"),
          ("potrf_kernel", "potrf_leaf"), ("tri_inv_kernel", "tri_inv_leaf"),
          ("qgemm_", "qgemm"), ("panel_", "panel_update"),
          ("residual_kernel", "residual_fused"),
          ("trsm_kernel", "trsm_leaf"), ("trsm_reduce", "trsm_leaf"),
          ("syrk_tiles", "syrk_leaf"), ("syrk_reduce", "syrk_leaf"),
          ("syrk_tc_kernel", "syrk_packed"),
          ("syrk_packed_simt", "syrk_packed"),
          ("flash_kernel", "flash_attention"),
          ("nvjet", "torch matmul (cuBLAS)"), ("gemm", "torch matmul (cuBLAS)"),
          ("cutlass", "torch matmul (cuBLAS)"),
          ("xmma", "torch matmul (cuBLAS)"))


#: profiler ranges the port opens (``torch.profiler.record_function``):
#: each one's device time (the kernels launched inside it, already booked
#: by kernel above) is reported apart: moe_expert_loop is the MoE layers'
#: per-expert products (models/moe.py)
_RANGES = ("moe_expert_loop",)


#: empty kernels (torch.cuda._sleep, "spin_kernel") launched at the start
#: of every profiled window. torch.profiler (2.11, on the H100) loses the
#: first device events of a session, more the longer the process has run,
#: whatever idle time comes before or after the work; these take the
#: loss, and at least one of them must be booked
_SENTINELS = 128


#: windows _profiled may take: torch.profiler now and then books no device
#: event of a whole window, not even a sentinel; such a window is measured
#: again, and only a window that booked all of its work is reported
_PROFILE_ATTEMPTS = 3


def _profiled(fn):
    """fn() under torch.profiler: wall ms, device ms by port kernel (the
    rest as torch's matmuls and other torch ops), the number of device
    events (kernel launches, copies) and the device's busy share of the
    wall time. The window opens with _SENTINELS empty kernels, left out
    of every number. Every launch that ops.LAUNCHES counts in the window
    runs at least one CUDA kernel, so a port kernel with fewer booked
    device events than counted launches, or no sentinel booked, means the
    breakdown did not see all of the work: the window is run again, up to
    _PROFILE_ATTEMPTS windows, and the phase fails if none saw it all.
    The lost windows are listed in the line."""
    lost = []
    for _ in range(_PROFILE_ATTEMPTS):
        line, missing = _profile_window(fn)
        if missing is None:
            return {**line, "lost_windows": lost}
        lost.append(missing)
    raise AssertionError(f"profiler booked fewer device events than "
                         f"launches in {len(lost)} windows: {lost}")


def _profile_window(fn):
    """One window of _profiled: (its line, None), or (its line, what the
    profiler missed)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    before = dict(ops.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(_SENTINELS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the device events are summed from the trace's raw events: building
    # key_averages' event tree takes minutes at rwkv6's ~10^6 host events
    # a prefill, and a kernel's self device time is its duration
    by, booked, events, sentinels, ranges = {}, {}, 0, 0, {}
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    has_range = False
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if name in _RANGES:
            has_range = has_range or ev.device_type() == cpu
            continue
        if ev.device_type() != cuda:
            continue
        if "spin_kernel" in name:
            sentinels += 1
            continue
        key = next((k for frag, k in _SPANS if frag in name),
                   "other (torch ops)")
        by[key] = by.get(key, 0.0) + ev.duration_ns() / 1e6
        booked[key] = booked.get(key, 0) + 1
        events += 1
    if has_range:
        # a range's device time is that of the kernels launched inside
        # it: key_averages' tree attributes them
        for ev in prof.key_averages():
            if ev.key in _RANGES and ev.device_type == cpu:
                ranges[ev.key] = {"calls": ev.count,
                                  "device_ms": ev.device_time_total / 1e3}
    launched = {k: v - before[k] for k, v in ops.LAUNCHES.items()
                if v > before[k]}
    unseen = {k: {"launches": v, "device_events": booked.get(k, 0)}
              for k, v in launched.items() if booked.get(k, 0) < v}
    busy = sum(by.values())
    line = {"wall_ms": wall_ms, "device_ms_by_kernel": by,
            "device_events": events, "launches": launched,
            "sentinels_booked": sentinels,
            "device_busy_share": busy / wall_ms if by else None}
    if ranges:
        line["ranges"] = ranges
    if unseen or not sentinels:
        return line, {"unseen": unseen, "sentinels": sentinels}
    return line, None


def serve_phase(n, seed, requests=48, slots=16):
    """48 single-column requests against one cached factor, through the
    continuous scheduler and through a windowed drain; the two compared
    request for request."""
    from repro_torch.serve import (BatchScheduler, InMemoryMetrics,
                                   SolveOptions, SolverEngine,
                                   matrix_fingerprint)
    a = paper_matrix(n, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    bs = [torch.randn((n,), generator=g, device="cuda")
          for _ in range(requests)]
    targets = [(6.0, 8.0, 10.0, 12.0)[i % 4] for i in range(requests)]
    metrics = InMemoryMetrics()
    eng = SolverEngine("bf16_f32", residual_dtype="f64", metrics=metrics)
    fp = matrix_fingerprint(a)
    t0 = time.perf_counter()
    eng.factor(a, "paper", fingerprint=fp)      # once, outside the timing
    torch.cuda.synchronize()
    factor_s = time.perf_counter() - t0
    opts = [SolveOptions(target_digits=t, cache_key="paper", fingerprint=fp)
            for t in targets]

    def continuous():
        sch = BatchScheduler(eng, max_batch=slots, continuous=True)
        sch.start()
        futs = [sch.submit_async(a, b, o) for b, o in zip(bs, opts)]
        out = [f.result(timeout=600) for f in futs]
        sch.stop()
        return out

    def windowed():
        sch = BatchScheduler(eng, max_batch=slots)
        ids = [sch.submit(a, b, o) for b, o in zip(bs, opts)]
        res = sch.drain()
        return [res[i] for i in ids]

    line = {"phase": "serve", "ladder": "bf16_f32", "n": n,
            "residual_dtype": "f64", "requests": requests, "slots": slots,
            "targets": sorted(set(targets)), "factor_s_excluded": factor_s}
    outs = {}
    for mode, fn in (("continuous", continuous), ("window", windowed)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        outs[mode] = out
        infos = [info for _, info in out]
        sweeps = [info.sweeps for info in infos]
        digits = [-math.log10(max(residual(a, x, b), 1e-300))
                  for (x, _), b in zip(out, bs)]
        # the loop's f64 residual and this one differ by summation order,
        # ~1e-14 of ||b||: 0.05 digit at a 12-digit target is far above it
        short = [i for i, (d, t, info) in enumerate(zip(digits, targets,
                                                        infos))
                 if not info.converged or d < t - 0.05]
        if len(out) != requests or short:
            raise AssertionError(f"serve {mode}: requests {short} missed "
                                 "their targets")
        line[mode] = {"wall_s": wall, "req_per_s": requests / wall,
                      "sweeps_mean": sum(sweeps) / len(sweeps),
                      "sweeps_max": max(sweeps),
                      "converged_share": sum(i.converged for i in infos)
                      / len(infos),
                      "digits_min_by_target": {
                          str(t): min(d for d, tt in zip(digits, targets)
                                      if tt == t)
                          for t in sorted(set(targets))}}
    diffs, max_dx = [], 0.0
    for i, ((xc, ic), (xw, iw)) in enumerate(zip(outs["continuous"],
                                                 outs["window"])):
        if (ic.sweeps != iw.sweeps or ic.converged != iw.converged
                or len(ic.history[0]) != len(iw.history[0])):
            diffs.append(i)
        max_dx = max(max_dx, float((xc - xw).abs().max()))
    line["continuous_vs_window"] = {
        "requests_differing_in_sweeps_converged_or_history": diffs,
        "x_bitwise_equal": max_dx == 0.0, "max_abs_dx": max_dx,
        "history_equal": all(oc[1].history == ow[1].history for oc, ow in
                             zip(outs["continuous"], outs["window"]))}
    if diffs:
        raise AssertionError(f"serve: continuous and window differ on "
                             f"requests {diffs}")
    counters = metrics.snapshot()["counters"]
    line["factor_cache_hits"] = counters.get("engine.factor_cache_hit", 0)
    line["factor_cache_misses"] = counters.get("engine.factor_cache_miss", 0)
    for mode, fn in (("continuous", continuous), ("window", windowed)):
        line[mode]["profiled"] = _profiled(fn)
    del a, eng
    torch.cuda.empty_cache()
    return line


# ---------------------------------------------------------------------------
# phase 6b: the tuner (engine="auto", tuning_db=, the tuned max_batch)
# ---------------------------------------------------------------------------
#: the committed database of the card, measured by python -m repro_torch.tune
CUDA_DB = ROOT / "src" / "repro_torch" / "tune" / "data" / "cuda.json"
#: what the tuner's races launch: both engines, and the serving race's
#: refinement residuals
TUNE_KERNELS = REFINE_KERNELS


def _engine_ran(got) -> str:
    """The engine a factor ran on, from its launches: panel_update is the
    blocked engine's, syrk_leaf and trsm_leaf the tree's."""
    if got["panel_update"] > 0:
        return "blocked"
    if got["syrk_leaf"] > 0 and got["trsm_leaf"] > 0:
        return "tree"
    return "none"


def tune_db_line():
    """The committed database, loaded with warnings as errors (a card
    that fell back to the untuned defaults would say nothing otherwise):
    valid, consulted as it says, keyed "cuda", and the one engine="auto"
    reads."""
    import warnings

    from repro_torch import tune
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        db = tune.load_db(str(CUDA_DB))
        tune.clear_cache()
        default = tune.get_default_db("cuda")
    if db is None or default is None or default.payload != db.payload:
        raise AssertionError(f"tune: {CUDA_DB} is not the database "
                             "engine='auto' reads on the card")
    errs = tune.validate_db(db.payload) + tune.verify_consultation(db)
    if errs or db.backend != "cuda":
        raise AssertionError(f"tune: committed database: {errs}, "
                             f"backend {db.backend!r}")
    ladders = sorted({e["ladder"] for e in db.entries})
    return {"phase": "tune", "step": "committed_db",
            "path": str(CUDA_DB.relative_to(ROOT)),
            "entries": len(db.entries),
            "crossover_n": {c["ladder"]: c["n"] for c in db.crossovers},
            "engine_by_n": {lad: {str(e["n"]): e["choice"]["engine"]
                                  for e in db.entries if e["ladder"] == lad}
                            for lad in ladders},
            "max_batch": {lad: db.decide(256, lad).max_batch
                          for lad in ladders}}


def tune_smoke_search():
    """autotune(smoke=True) on the card with the real timer (both
    engines at n = 256 and 512, leaves 128 and 256, and the serving race
    at n = 256); its payload must be valid."""
    from repro_torch import tune
    t0 = time.perf_counter()
    payload = tune.autotune(smoke=True, ladders=("bf16_f32",),
                            device="cuda", log=lambda *args: None)
    wall = time.perf_counter() - t0
    errs = tune.validate_db(payload) + tune.verify_consultation(
        tune.TuningDB(payload))
    if errs or payload["backend"] != "cuda":
        raise AssertionError(f"tune: smoke search payload: {errs}")
    return {"phase": "tune", "step": "smoke_search", "wall_s": wall,
            "payload": payload}


def tune_auto_solves(seed):
    """cholesky_solve with engine="auto" (16 right-hand sides) for
    bf16_f32 and f16x3_f32 at n = 1024 and 16384: the engine that ran (by
    its launches) must be the one the database names, x bitwise the
    explicit engine's, and at 16384 the digits at that engine's floor."""
    import repro_torch as rt
    from repro_torch import tune
    from repro_torch.kernels import ops
    runs = []
    for i, name in enumerate(("bf16_f32", "f16x3_f32")):
        base = rt.PAPER_CONFIGS[name]
        auto = dataclasses.replace(base, engine="auto")
        for j, n in enumerate((1024, N_MAIN)):
            dec = tune.decide(n, tune.ladder_key(base), backend="cuda")
            a = paper_matrix(n, seed + 10 * i + j)
            g = torch.Generator(device="cuda").manual_seed(seed + 1)
            b = torch.randn((n, 16), generator=g, device="cuda")
            before = dict(ops.LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x = rt.cholesky_solve(a, b, auto)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ran = _engine_ran(_diff(before))
            if ran != dec.engine:
                raise AssertionError(f"tune: auto {name} n={n} ran {ran}, "
                                     f"the database names {dec.engine}")
            x_exp = rt.cholesky_solve(a, b, dataclasses.replace(
                base, engine=dec.engine))
            _bitwise(f"tune: auto {name} n={n} vs {dec.engine}", x, x_exp)
            digits = -math.log10(max(residual(a, x, b), 1e-300))
            floor = None
            if n == N_MAIN:
                floor = (DIGITS_FLOOR if dec.engine == "blocked"
                         else TREE_DIGITS_FLOOR)[name]
            if floor is not None and digits < floor:
                raise AssertionError(f"tune: auto {name} n={n}: "
                                     f"{digits:.2f} digits < {floor}")
            runs.append({"ladder": name, "n": n, "engine": dec.engine,
                         "source": dec.source, "ran": ran,
                         "bitwise_explicit": True, "wall_ms": wall * 1e3,
                         "digits": digits, "digits_floor": floor})
            del a, x, x_exp
            torch.cuda.empty_cache()
    return {"phase": "tune", "step": "auto_solves", "k": 16, "runs": runs}


def tune_serving(n, seed):
    """SolverEngine with an engine="auto" bf16_f32 ladder and the
    committed database: 16 columns refined at n = 16384 to 1e-10 with f64
    residuals, on the engine the database names; BatchScheduler's width
    is the database's."""
    import repro_torch as rt
    from repro_torch import tune
    from repro_torch.kernels import ops
    from repro_torch.serve import BatchScheduler, SolveOptions, SolverEngine
    db = tune.load_db(str(CUDA_DB))
    cfg = dataclasses.replace(rt.PAPER_CONFIGS["bf16_f32"], engine="auto")
    key = tune.ladder_key(cfg)
    eng = SolverEngine(cfg, residual_dtype="f64", tuning_db=db)
    a = paper_matrix(n, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    b = torch.randn((n, 16), generator=g, device="cuda")
    want = db.decide(n, key).engine
    before = dict(ops.LAUNCHES)
    t0 = time.perf_counter()
    (x,), (info,) = eng.solve_batched(
        a, [b], SolveOptions(target_digits=10, cache_key="tune"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ran = _engine_ran(_diff(before))
    digits = [-math.log10(max(residual(a, x[:, j], b[:, j]), 1e-300))
              for j in range(16)]
    if ran != want or not info.converged or min(digits) < 10:
        raise AssertionError(f"tune: serving ran {ran} (database {want}), "
                             f"converged {info.converged}, digits "
                             f"{min(digits):.2f}")
    mb = BatchScheduler(eng).max_batch
    if mb != db.decide(256, key).max_batch:
        raise AssertionError(f"tune: BatchScheduler.max_batch {mb} is not "
                             "the database's")
    del a, eng
    torch.cuda.empty_cache()
    return {"phase": "tune", "step": "serving", "ladder": "bf16_f32",
            "engine": want, "ran": ran, "n": n, "k": 16,
            "residual_dtype": "f64", "sweeps": info.sweeps,
            "converged": info.converged, "digits_min": min(digits),
            "wall_s": wall, "max_batch": mb}


def tune_fresh_race():
    """bf16_f32's engine race run again at the two grid sizes around its
    committed crossover; printed beside the committed pick, no gate."""
    from repro_torch import tune
    from repro_torch.tune import search
    db = tune.load_db(str(CUDA_DB))
    key = "bf16_f32"
    grid = sorted(e["n"] for e in db.entries
                  if e["ladder"] == key and e["nshards"] == 1)
    xn = db.crossover(key, 1)["n"]
    hi = next((i for i, n in enumerate(grid) if xn is not None and n >= xn),
              len(grid) - 1)
    pair = grid[max(hi - 1, 0):max(hi - 1, 0) + 2]
    timer = functools.partial(search.timeit, warmup=1, iters=3,
                              device="cuda")
    runs = []
    for n in pair:
        choice, meas, per_engine = search._tune_single(
            n, tuple(key.split("_")), timer, lambda *args: None, "cuda")
        committed = db.decide(n, key)
        cm = next(e["measurements"] for e in db.entries
                  if e["ladder"] == key and e["n"] == n)
        runs.append({"n": n, "fresh_pick": choice["engine"],
                     "committed_pick": committed.engine,
                     "agree": choice["engine"] == committed.engine,
                     "fresh_us": meas,
                     "committed_us": {k: v for k, v in cm.items()
                                      if k.startswith(("us_tree",
                                                       "us_blocked"))}})
    return {"phase": "tune", "step": "fresh_race", "ladder": key,
            "committed_crossover_n": xn, "timer": "median of 3 after 1, "
            "3 interleaved rounds", "runs": runs}


def census_phase(lines, rates, kind):
    """The tree census (GEMM and leaf FLOPs by type, its model time on the
    card's peaks) and the blocked plan's dot FLOPs at n = 16384, leaf
    256, beside the tree and blocked factor_ms of the path lines."""
    import repro_torch as rt
    from repro_torch.core import PEAK_FLOPS, build_plan, census_potrf
    if "PCIe" not in kind:
        for k, v in PEAK_FLOPS.items():
            if v != rates[{"f16": "bf16"}.get(k, k)]:
                raise AssertionError(f"PEAK_FLOPS[{k}] {v:g} is not the "
                                     "card's rate")
    factor_ms = {(ln["phase"], ln["ladder"]): ln["factor_ms"] for ln in lines
                 if ln.get("phase") in ("path", "tree_path")
                 and ln.get("n") == N_MAIN and "factor_ms" in ln}
    runs = []
    for name in ("pure_f32", "bf16_f32", "f16x3_f32", "int8_f32"):
        cfg = rt.PAPER_CONFIGS[name]
        c = census_potrf(N_MAIN, cfg)
        model_ms = c.model_time_s() * 1e3
        dot = build_plan(N_MAIN, cfg).expected_dot_flops()
        dot_ms = sum(v / PEAK_FLOPS[k] for k, v in dot.items()) * 1e3
        tree_ms = factor_ms[("tree_path", name)]
        blocked_ms = factor_ms[("path", name)]
        runs.append({
            "ladder": name, "n": N_MAIN, "leaf": cfg.leaf,
            "tree_gemm_flops": dict(c.gemm_flops),
            "tree_leaf_flops": dict(c.leaf_flops),
            "tree_gemm_count": c.gemm_count, "tree_leaf_count": c.leaf_count,
            "gemm_fraction": c.gemm_fraction,
            "lowp_fraction": c.lowp_fraction(),
            "lowp_fraction_with_int8": c.lowp_fraction(("f16", "bf16",
                                                        "int8")),
            "tree_model_ms": model_ms, "tree_factor_ms": tree_ms,
            "tree_model_share": model_ms / tree_ms,
            "blocked_dot_flops": dot, "blocked_dot_model_ms": dot_ms,
            "blocked_factor_ms": blocked_ms,
            "blocked_model_share": dot_ms / blocked_ms})
    return {"phase": "census", "peak_flops": PEAK_FLOPS,
            "model": "sum over types of FLOPs / PEAK_FLOPS (no bytes)",
            "runs": runs}


# ---------------------------------------------------------------------------
# phase 6b: the precision-conformance audit on the card
# ---------------------------------------------------------------------------
AUDIT_LADDERS = ("pure_f32", "bf16_f32", "f16x3_f32", "int8_f32")
#: what the audit phase must launch: the main path's five kernels audited,
#: and the other four once each for the resource table
AUDIT_KERNELS = ("potrf_leaf", "tri_inv_leaf", "qgemm", "panel_update",
                 "residual_fused", "trsm_leaf", "syrk_leaf", "syrk_packed",
                 "flash_attention")


def _audit_other_kernels(gen, dev="cuda"):
    """One small call of each kernel off the blocked path, on each of its
    type routes (and qgemm's tensor-core route, which the blocked path
    does not take): their launches' shared memory for the resource
    table."""
    from repro_torch.kernels import ops
    l = (torch.rand((256, 256), generator=gen, device=dev).tril(-1)
         + 16 * torch.eye(256, device=dev))
    for m in (8192, 256):               # trsm_leaf's wide and split plans
        ops.trsm(torch.randn((m, 256), generator=gen, device=dev), l)
    for dt in (torch.float32, torch.bfloat16, torch.float16, torch.int8):
        a = torch.randn((512, 1024), generator=gen, device=dev)
        a = (a * 20).to(dt) if dt == torch.int8 else a.to(dt)
        c = torch.zeros((512, 512), device=dev)
        ops.syrk(c, a)
        ops.syrk(c, a, packed=True)
        if dt != torch.float32:
            ops.qgemm(a, a, trans_b=True)
    for dt, hd in ((torch.bfloat16, 256), (torch.float16, 128),
                   (torch.float32, 64)):
        q = torch.randn((1, 512, 8, hd), generator=gen, device=dev).to(dt)
        k = torch.randn((1, 512, 1, hd), generator=gen, device=dev).to(dt)
        ops.flash_attention_bshd(q, k, k)


def audit_phase(kind, smi):
    """The precision-conformance audit of the card's launches
    (``repro_torch.audit``): the launch audits of the blocked factor at
    N_MAIN for AUDIT_LADDERS (every product's FLOPs by name against the
    plan, every 16-bit and int8 pair of an f32 container on the tensor
    cores and every other on the CUDA cores, the leaves in the high
    dtype), of bf16_f32's solve (every qgemm wide, on the CUDA cores) and
    refinement (f64 residuals), all under torch.profiler with one small
    call of each other kernel; the resource table, one row a compiled
    kernel (cuobjdump: static shared memory, registers, local memory; the
    launchers' own list: dynamic shared memory; CUPTI: the launches'
    shared memory, which must be the table's) against 232,448 B and 255
    registers; the kernel sources' static checks; and the card-route
    mutants (a pair's name, a pair's dispatch), which must be caught and
    localized. ``parts_s`` times each part of the phase."""
    from repro_torch.audit import kernelaudit, launchaudit, selftest
    from repro_torch.core.precision import PAPER_CONFIGS
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(950)
    checks, parts = [], {}

    def work():
        t = time.perf_counter()
        for name in AUDIT_LADDERS:
            checks.append(launchaudit.audit_launch_blocked(
                N_MAIN, PAPER_CONFIGS[name]))
        cfg = PAPER_CONFIGS["bf16_f32"]
        checks.append(launchaudit.audit_launch_solve(N_MAIN, cfg))
        checks.append(launchaudit.audit_launch_refine(N_MAIN, cfg))
        torch.cuda.synchronize()
        parts["launch_audits_s"] = time.perf_counter() - t
        t = time.perf_counter()
        _audit_other_kernels(gen)
        torch.cuda.synchronize()
        parts["other_kernels_s"] = time.perf_counter() - t
    resources, table, secs = kernelaudit.card_resources(work)
    parts["profiler_s"] = (secs["profiled_s"] - parts["launch_audits_s"]
                           - parts["other_kernels_s"])
    parts["resource_table_s"] = secs["table_s"]
    t = time.perf_counter()
    checks += [resources, kernelaudit.audit_kernels()]
    parts["static_checks_s"] = time.perf_counter() - t
    t = time.perf_counter()
    route_misses = selftest.mut_card_route("cuda")
    parts["card_route_mutants_s"] = time.perf_counter() - t
    launched = [r for r in table if r["launches"]]
    listed = [r for r in table if r["dynamic_smem"] is not None]
    line = {"phase": "audit", "device": kind, "nvidia_smi": smi,
            "checks": [{"name": c.name, "target": c.target, "ok": c.ok,
                        "violations": [str(v) for v in c.violations]}
                       for c in checks],
            "card_route_mutation": {"caught": not route_misses,
                                    "mutants": ["names", "dispatch"],
                                    "misses": [str(v)
                                               for v in route_misses]},
            "kernels_compiled": len(table),
            "kernels_listed": len(listed),
            "kernels_launched": len(launched),
            "resource_maxima": {
                "regs": max(r["regs"] for r in table),
                "static_smem": max(r["static_smem"] for r in table),
                "dynamic_smem": max((r["dynamic_smem"] for r in listed),
                                    default=None),
                "total_smem": max((r["static_smem"] + r["dynamic_smem"]
                                   for r in listed), default=None),
                "launch_smem": max((r["launch_smem"] for r in launched),
                                   default=None),
                "local_bytes": max(r["local_bytes"] for r in table)},
            "limits": {"smem": kernelaudit.SMEM_LIMIT,
                       "regs": kernelaudit.REG_LIMIT},
            "resources": table,
            "parts_s": parts,
            "phase_s": time.perf_counter() - t0}
    bad = [c.target for c in checks if not c.ok]
    if bad or route_misses:
        emit(line)
        raise AssertionError(f"audit: {bad} failed; card-route mutation "
                             f"misses {line['card_route_mutation']}")
    return line


# ---------------------------------------------------------------------------
# phase 6c: the distributed path, 4 ranks sharing the card over gloo
# ---------------------------------------------------------------------------
DIST_RANKS = 4
#: what the dist phase's ranks must launch (summed over the ranks)
DIST_KERNELS = ("potrf_leaf", "tri_inv_leaf", "qgemm", "panel_update",
                "residual_fused", "trsm_leaf", "syrk_leaf")
DIST_NOTE = ("4 processes sharing one card, their collectives through gloo "
             "and host memory: the port's kernels, schedule, wire format "
             "and numerics on the card, not a 4-GPU node; NCCL is not used")
DIST_LADDERS = ("bf16_f32", "f16x3_f32", "int8_f32", "pure_f32")
DIST_SOLVE_LADDERS = ("bf16_f32", "f16x3_f32", "int8_f32")
#: limit on a dist factor's entries below the diagonal against the
#: single-device factor's, relative to their max, by the ladder's first
#: level: 3.4-18x the card's readings (bf16 2.2e-2, int8 4.5e-2, f16
#: 4.1e-3, f32 1.1e-6 at n = 16384), and a quarter or less of what
#: leaving out the trailing updates gives (0.55-0.61 at n = 2048)
DIST_LOWER_TOL = {"bf16": 0.15, "int8": 0.15, "f16": 2e-2, "f32": 2e-5}
DIST_SCHEDULES = [(bd, cc) for bd in (True, False) for cc in (True, False)]


def dist_cases():
    """The dist phase's cases, in the order the ranks run them
    (repro_torch.launch.drive). The factors and solves take paper §IV-A's
    matrix with sqrt(n) on the diagonal in place of n (condition about
    10): its factor's entries below the diagonal are a sizable share of
    the diagonal, and the trailing updates a sizable share of them, so
    that a fault there shows against the single-device factor; serving
    takes the paper's matrix itself."""
    def shifted(n):
        return {"n": n, "shift": math.sqrt(n)}
    # a first, smaller factor takes each rank's first-call costs (kernel
    # loads, the caching allocator) out of the timed full-width ones
    cases = [{"kind": "gloo"},
             {"kind": "factor", "ladder": "bf16_f32", "seed": 999,
              "yardstick": True, **shifted(4096)}]
    cases += [{"kind": "factor", "ladder": name, "seed": 1000 + i,
               "yardstick": True, **shifted(N_MAIN)}
              for i, name in enumerate(DIST_LADDERS)]
    cases.append({"kind": "factor", "ladder": "f16x3_f32", "seed": 1010,
                  "engine": "tree", "yardstick": True, **shifted(8192)})
    cases += [{"kind": "factor", "ladder": "f16_f32", "leaf": 128,
               "seed": 1020 + i, "broadcast_diag_only": bd,
               "compress_comm": cc, "yardstick": True, **shifted(4096)}
              for i, (bd, cc) in enumerate(DIST_SCHEDULES)]
    cases += [{"kind": "solve", "ladder": name, "seed": 1030 + i, "k": 16,
               "compare_single": True, **shifted(N_MAIN)}
              for i, name in enumerate(DIST_SOLVE_LADDERS)]
    cases.append({"kind": "serve", "ladder": "bf16_f32", "n": N_MAIN,
                  "n_local": 1024, "seed": 1040,
                  "targets": (6.0, 8.0, 10.0, 12.0), "waves": (1, 7),
                  "residual_dtype": "f64", "max_sweeps": 10,
                  "fault_rank": 1})
    cases.append({"kind": "tune", "smoke": True})
    cases.append({"kind": "imports"})
    return cases


def dist_schedule(cfg, n, rank):
    """Launches of one dist_cholesky on ``rank``, and how many of its
    qgemm launches take the tensor cores (None: not counted). Every rank
    factors each of the P diagonal blocks; each rank below a panel solves
    its row block against it and updates its trailing rows (1 qgemm).
    Blocked: a diagonal block is tps potrf_leaf, tps - 1 tri_inv_leaf and
    panel_update; a row block's solve one batched tri_inv_leaf and
    2 tps - 1 qgemm; the trailing qgemm takes the tensor cores where the
    panel's comm name is 16-bit or int8. Tree: the diagonal block is the
    recursion's factor at w (tree_schedule), the row block's solve its
    right-side TRSM recursion over w (one qgemm a node, tri_inv_leaf and
    trsm_leaf a leaf)."""
    from repro_torch.core.plan import build_plan, shard
    from repro_torch.kernels import ops
    sp = shard(build_plan(n, cfg), DIST_RANKS)
    tps, P, w = sp.tps, DIST_RANKS, n // DIST_RANKS
    if cfg.engine == "tree":
        fac, _ = tree_schedule(cfg, w)
        trsm = dict.fromkeys(ops.LAUNCHES, 0)

        def walk(m):
            if m <= cfg.leaf:
                trsm["tri_inv_leaf"] += 1
                trsm["trsm_leaf"] += 1
                return
            trsm["qgemm"] += 1
            walk(cfg.split(m))
            walk(m - cfg.split(m))
        walk(w)
        sched = {k: P * fac[k] + rank * trsm[k] for k in fac}
        sched["qgemm"] += rank
        return sched, None
    sched = {**dict.fromkeys(ops.LAUNCHES, 0), "potrf_leaf": P * tps,
             "tri_inv_leaf": P * (tps - 1) + rank,
             "panel_update": P * (tps - 1), "qgemm": 2 * tps * rank}
    tc = sum(sp.comm_name(j) in ("f16", "bf16", "int8") for j in range(rank))
    return sched, tc


def dist_phase(kind, smi):
    """The dist cases on DIST_RANKS ranks sharing the card, one line a
    case from rank 0, every gate checked here; returns the lines and the
    launches summed over the ranks, by entry of KERNELS."""
    from repro_torch.audit.conformance import wire_expectation
    from repro_torch.core.precision import PAPER_CONFIGS
    from repro_torch.kernels import ops
    from repro_torch.launch import drive, launch
    torch.cuda.empty_cache()
    cases = dist_cases()
    t0 = time.perf_counter()
    results = launch(drive.run_cases, DIST_RANKS, (cases, "cuda"),
                     device="cuda", timeout=600)[0]
    wall = time.perf_counter() - t0
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    batched = dict.fromkeys(ops.BATCHED, 0)
    lines = []
    for case, res in zip(cases, results):
        line = {"phase": "dist", "case": case["kind"], "ranks": DIST_RANKS,
                "device": kind, "nvidia_smi": smi, "note": DIST_NOTE}
        for r in (res["ranks"] if isinstance(res, dict) else ()):
            for k, v in r.get("launches", {}).items():
                launches[k] += v
            for k, v in r.get("batched", {}).items():
                batched[k] += v
        if case["kind"] == "gloo":
            if not res["ok"]:
                raise AssertionError(f"dist: gloo moved a CUDA tensor "
                                     f"wrongly: {res['ranks']}")
            line.update({"collectives_on_device": res["ranks"][0]["checks"],
                         "all_gather_mib_per_rank": res["nbytes"] / 2 ** 20,
                         "all_gather_s_per_rank": [r["all_gather_s"]
                                                   for r in res["ranks"]]})
        elif case["kind"] == "factor":
            cfg = dataclasses.replace(
                PAPER_CONFIGS[case["ladder"]], engine=res["engine"],
                leaf=res["leaf"])
            bd = case.get("broadcast_diag_only", True)
            cc = case.get("compress_comm")
            # None: the database's choice; cuda.json has no nshards=4 entry
            cc = True if cc is None else cc
            label = (f"{case['ladder']} n={case['n']} leaf={cfg.leaf} "
                     f"{res['engine']} bd={bd} cc={cc}")
            tol = TOL[cfg.levels[0]]
            lower_tol = DIST_LOWER_TOL[cfg.levels[0]]
            if not (res["upper_zero"] and res["finite"]
                    and res["rel_to_single"] < tol
                    and res["rel_lower_to_single"] < lower_tol):
                raise AssertionError(
                    f"dist {label}: {res['rel_to_single']} from the "
                    f"single-device factor relative to max|L| (tol {tol}), "
                    f"{res['rel_lower_to_single']} below the diagonal "
                    f"relative to its max (tol {lower_tol}), upper zero "
                    f"{res['upper_zero']}, finite {res['finite']}")
            want_wire = wire_expectation(cfg, case["n"], DIST_RANKS,
                                         broadcast_diag_only=bd,
                                         compress=cc)
            for rank, r in enumerate(res["ranks"]):
                if r["wire"] != want_wire:
                    raise AssertionError(f"dist {label} rank {rank}: wire "
                                         f"{r['wire']} != {want_wire}")
                sched, tc = dist_schedule(cfg, case["n"], rank)
                if r["launches"] != sched:
                    raise AssertionError(f"dist {label} rank {rank}: "
                                         f"launches {r['launches']} != "
                                         f"{sched}")
                if tc is not None and r["qgemm_routes"]["tc"] != tc:
                    raise AssertionError(f"dist {label} rank {rank}: "
                                         f"{r['qgemm_routes']} tensor-core "
                                         f"trailing updates, want {tc}")
            line.update({
                "ladder": case["ladder"], "n": case["n"], "leaf": cfg.leaf,
                "engine": res["engine"], "broadcast_diag_only": bd,
                "compress_comm": cc, "shift": case["shift"],
                "rel_to_single": res["rel_to_single"],
                "rel_lower_to_single": res["rel_lower_to_single"],
                "tol": tol, "lower_tol": lower_tol, "upper_zero": True,
                "finite": True,
                "factor_ms_per_rank": [r["ms"] for r in res["ranks"]],
                "factor_wall_s_per_rank": [r["wall_s"] for r in res["ranks"]],
                "wire_bytes_per_rank": want_wire,
                "launches_per_rank": [r["launches"] for r in res["ranks"]],
                "qgemm_routes_per_rank": [r["qgemm_routes"]
                                          for r in res["ranks"]]})
        elif case["kind"] == "solve":
            if not res["digits"] >= res["single_digits"] - 0.3:
                raise AssertionError(f"dist solve {case['ladder']}: "
                                     f"{res['digits']:.2f} "
                                     f"digits, single-device "
                                     f"{res['single_digits']:.2f}")
            line.update({
                "ladder": case["ladder"], "n": case["n"], "k": case["k"],
                "shift": case["shift"], "digits": res["digits"],
                "single_device_digits": res["single_digits"],
                "factor_ms_per_rank": [r["factor_ms"] for r in res["ranks"]],
                "solve_ms_per_rank": [r["solve_ms"] for r in res["ranks"]],
                "solve_wall_s_per_rank": [r["solve_wall_s"]
                                          for r in res["ranks"]],
                "factor_and_solve_launches_per_rank": [
                    r["launches"] for r in res["ranks"]]})
        elif case["kind"] == "serve":
            line.update(dist_serve_checks(case, res))
        elif case["kind"] == "imports":
            if any(res):
                raise AssertionError(f"dist: ranks imported {res}")
            line["jax_or_reference_modules_per_rank"] = res
        else:
            payload = res["payload"]
            line.update({
                "smoke": True, "wall_s": res["wall_s"],
                "entries": [{"n": e["n"], "nshards": e["nshards"],
                             "choice": e["choice"],
                             "measurements": e["measurements"]}
                            for e in payload["entries"]
                            if e["nshards"] == DIST_RANKS],
                "crossovers": payload["crossovers"],
                "note": DIST_NOTE + "; printed only, nothing of it goes "
                        "into cuda.json"})
        lines.append(line)
    lines.append({"phase": "dist_launches", "wall_s": wall,
                  "summed_over_ranks": launches,
                  "batched_summed_over_ranks": batched})
    for k in DIST_KERNELS:
        if launches[k] == 0:
            raise AssertionError(f"{k} was not launched on the dist path")
    return lines, split_launches(launches, batched)


def dist_serve_checks(case, res):
    """Mesh-mode serving: the large requests ran distributed, the later
    wave found the sharded factor cached, every request reached its
    target within the sweep budget, the small one stayed local, and each x
    is bitwise engine.solve's for the same request."""
    sched, direct = res["scheduled"], res["direct"]
    waves = case["waves"]
    for i, (s, d, t) in enumerate(zip(sched, direct, res["targets"])):
        info = s["info"]
        if not (info["distributed"] and info["converged"]
                and info["sweeps"] <= case["max_sweeps"]
                and s["digits"] >= t - 0.05):
            raise AssertionError(f"dist serve request {i}: {info}, "
                                 f"{s['digits']:.2f} digits for {t}")
        if info["factor_cached"] != (i >= waves[0]):
            raise AssertionError(f"dist serve request {i}: factor_cached "
                                 f"{info['factor_cached']}")
        if not np.array_equal(s["x"], d["x"]):
            raise AssertionError(f"dist serve request {i}: x differs from "
                                 "engine.solve's")
    loc = res["local"]
    if loc["info"]["distributed"] or not loc["info"]["converged"] or \
            not np.array_equal(loc["x"], res["direct_local"]["x"]):
        raise AssertionError(f"dist serve local request: {loc['info']}")
    fault = res["fault"]
    want = f"rank {case['fault_rank']}: RuntimeError: fault injected"
    if fault is None or fault["type"] != "MeshCallError" or \
            want not in fault["message"]:
        raise AssertionError(f"dist serve: the failed request gave {fault}")
    if res["wrong_shape"] is None or \
            res["wrong_shape"]["type"] != "ValueError":
        raise AssertionError(f"dist serve: the wrong shape gave "
                             f"{res['wrong_shape']}")
    off = res["off_fingerprint"]
    if not (off["info"]["distributed"] and off["info"]["factor_cached"]
            and off["info"]["converged"]
            and off["digits"] >= off["target"] - 0.05
            and off["digits_against_a"] < off["target"] - 2):
        raise AssertionError(f"dist serve: the request after the failed "
                             f"one, on a matrix off the fingerprint: "
                             f"{off['info']}, {off['digits']:.2f} digits "
                             f"({off['digits_against_a']:.2f} against the "
                             f"cached matrix) for {off['target']}")
    followed = [r["followed"] for r in res["ranks"][1:]]
    if len(set(followed)) != 1:
        raise AssertionError(f"dist serve: followers ran {followed} calls")
    return {"ladder": case["ladder"], "n": case["n"],
            "n_local": case["n_local"], "residual_dtype": "f64",
            "waves": list(waves), "wave_wall_s": res["wave_wall_s"],
            "targets": res["targets"],
            "digits": [s["digits"] for s in sched],
            "sweeps": [s["info"]["sweeps"] for s in sched],
            "factor_cached": [s["info"]["factor_cached"] for s in sched],
            "distributed": [s["info"]["distributed"] for s in sched],
            "local": {"distributed": False, "digits": loc["digits"],
                      "sweeps": loc["info"]["sweeps"]},
            "failed_request": fault["message"],
            "wrong_shape": res["wrong_shape"]["message"],
            "off_fingerprint": {"digits": off["digits"],
                                "digits_against_cached": off[
                                    "digits_against_a"],
                                "target": off["target"],
                                "sweeps": off["info"]["sweeps"],
                                "factor_cached": True},
            "calls_followed_per_rank": followed,
            "x_bitwise_engine_solve": True}


def factor_probe(when, n, seed, reps=3):
    """The blocked f16x3_f32 factor, the main path's, timed ``reps`` times
    (CUDA events and the host clock), beside the allocator's reserved
    bytes and the card's SM clock, power draw and temperature read after
    it. Run before the kernel phases and after them, it shows whether what
    they leave behind (the CUDA graphs' memory pools, the allocator's
    cache) moves the path's factor time."""
    import repro_torch as rt
    cfg = rt.PAPER_CONFIGS["f16x3_f32"]
    a = paper_matrix(n, seed, cfg.high_dtype)
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ms, host = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        rt.cholesky_padded(a, cfg)
        stop.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        ms.append(start.elapsed_time(stop))
    reserved = torch.cuda.memory_reserved()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    del a
    torch.cuda.empty_cache()
    return {"phase": "factor_probe", "when": when, "ladder": "f16x3_f32",
            "n": n, "factor_ms": ms, "factor_host_ms": host,
            "reserved_gib": reserved / 2 ** 30,
            "sm_clock_power_temp": smi}


def breakdown(name, n, seed):
    """Device time by kernel inside one factor and one 16-column solve of
    each engine (torch.profiler), and the device's busy share of the wall
    time; beside them the vendor's f32 and f64 Cholesky of the same
    matrix."""
    import repro_torch as rt
    cfg = rt.PAPER_CONFIGS[name]
    tcfg = dataclasses.replace(cfg, engine="tree")
    a = paper_matrix(n, seed)
    b16 = torch.ones((n, 16), device="cuda")
    lp = rt.cholesky_padded(a, cfg)
    lt = rt.cholesky_padded(a, tcfg)
    line = {"phase": "breakdown", "ladder": name, "n": n}
    # the paper's vendor baseline: cuSOLVER's f32 Cholesky of the same
    # matrix (no host sync), a yardstick and no claim
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.linalg.cholesky_ex(a)
    times = []
    for _ in range(3):
        start.record()
        torch.linalg.cholesky_ex(a)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    line["library_ms"] = min(times)
    line["library_ms_all"] = times
    line["library"] = "torch.linalg.cholesky_ex(A), f32 (cuSOLVER)"
    # and in f64, the diagonal precision of the f32x3_f64 ladder
    a64 = a.double()
    torch.linalg.cholesky_ex(a64)
    times = []
    for _ in range(3):
        start.record()
        torch.linalg.cholesky_ex(a64)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    del a64
    line["library_f64_ms"] = min(times)
    line["library_f64_ms_all"] = times
    line["library_f64"] = "torch.linalg.cholesky_ex(A.double()) (cuSOLVER)"
    for label, fn in (("factor", lambda: rt.cholesky_padded(a, cfg)),
                      ("solve_k16", lambda: rt.solve_factored(lp, b16, cfg)),
                      ("tree_factor", lambda: rt.cholesky_padded(a, tcfg)),
                      ("tree_solve_k16",
                       lambda: rt.solve_factored(lt, b16, tcfg))):
        line[label] = _profiled(fn)
    del a, lp, lt
    torch.cuda.empty_cache()
    return line


def tree_qgemm_shapes(name, n, seed, top=2):
    """The tree factor's qgemm calls grouped by shape, operand types and
    route (ops.QGEMM_ROUTES around each call), ranked by device time (CUDA
    events around each call of one factor); every call with 16-bit or
    int8 operands must have taken the tensor cores (tc or tc_staged). The
    top shapes timed (CUDA events, and graph_ms) against torch.addmm with
    the operands widened to f32 and the library call of the same function
    (_qgemm_library), unless the qgemm kernel line's tree_shapes times
    them already (_TREE_TIMED)."""
    import repro_torch as rt
    from repro_torch.kernels import ops, qgemm
    cfg = dataclasses.replace(rt.PAPER_CONFIGS[name], engine="tree")
    a = paper_matrix(n, seed)
    rt.cholesky_padded(a, cfg)                       # warm
    timed, inner = {}, ops.qgemm

    def recording(x, y, scale=1.0, *, c=None, beta=0.0, trans_b=False,
                  out_dtype=torch.float32, out=None):
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        before = dict(ops.QGEMM_ROUTES)
        start.record()
        res = inner(x, y, scale, c=c, beta=beta, trans_b=trans_b,
                    out_dtype=out_dtype, out=out)
        stop.record()
        route = next(r for r, v in ops.QGEMM_ROUTES.items()
                     if v > before[r])
        key = (tuple(x.shape), tuple(y.shape), trans_b,
               str(x.dtype).replace("torch.", ""),
               str(y.dtype).replace("torch.", ""), c is not None, route)
        timed.setdefault(key, []).append((start, stop))
        return res

    ops.qgemm = recording
    try:
        rt.cholesky_padded(a, cfg)
    finally:
        ops.qgemm = inner
    torch.cuda.synchronize()
    rows = sorted(({"a": list(k[0]), "b": list(k[1]), "trans_b": k[2],
                    "dtypes": [k[3], k[4]], "c": k[5], "route": k[6],
                    "calls": len(v),
                    "device_ms": sum(s0.elapsed_time(s1) for s0, s1 in v)}
                   for k, v in timed.items()),
                  key=lambda r: -r["device_ms"])
    narrow = [r for r in rows if r["dtypes"][0] in ("float16", "bfloat16",
                                                    "int8")]
    off_tc = [r for r in narrow if r["route"] not in ("tc", "tc_staged")]
    if off_tc:
        raise AssertionError(f"tree {name}: 16-bit/int8 qgemm calls off the "
                             f"tensor cores: {off_tc[:3]}")
    by_route = {}
    for r in rows:
        d = by_route.setdefault(r["route"], {"calls": 0, "device_ms": 0.0})
        d["calls"] += r["calls"]
        d["device_ms"] += r["device_ms"]
    total = sum(r["device_ms"] for r in rows)
    for r in rows[:top]:
        (m, k), tb = r["a"], r["trans_b"]
        nn = r["b"][0] if tb else r["b"][1]
        tn = {"float16": "f16", "bfloat16": "bf16", "int8": "int8",
              "float32": "f32"}.get(r["dtypes"][0])
        r["timed_in_kernel_line"] = (m, nn, k, tn) in _TREE_TIMED and tb
        if (r["timed_in_kernel_line"] or tn is None
                or r["dtypes"][0] != r["dtypes"][1]):
            continue
        g = torch.Generator(device="cuda").manual_seed(seed + 1)
        x = _qgemm_operand(g, m, k, _QGEMM_TYPES[tn], "k")
        # B as its (N, K) view, stored as the call's b was
        y = _qgemm_operand(g, nn, k, _QGEMM_TYPES[tn], "k" if tb else "mn")
        yb = y if tb else y.T
        c32 = torch.randn((m, nn), generator=g, device="cuda")
        out = torch.empty_like(c32)

        def run():
            return qgemm.qgemm(x, yb, -1.0, c=c32, beta=1.0, trans_b=tb,
                               out=out)
        r["kernel_ms"] = cuda_ms(run, reps=10)
        r["graph_ms"] = graph_ms(run, 10)
        xw, yw = x.float(), y.float()
        r["addmm_f32_operands_ms"] = cuda_ms(
            lambda: torch.addmm(c32, xw, yw.T, alpha=-1.0), reps=10)
        r.update(_qgemm_library(x, y, c32, tn))
        del x, y, yb, xw, yw, c32, out
    del a
    torch.cuda.empty_cache()
    return {"phase": "tree_qgemm_shapes", "ladder": name, "n": n,
            "qgemm_device_ms": total, "calls": sum(r["calls"] for r in rows),
            "by_route": by_route,
            "narrow_calls_on_tensor_cores": sum(r["calls"] for r in narrow),
            "shapes": rows[:8]}


def cpu_agreement(name, n, seed, engine="blocked"):
    """The card's factor against the same port run on the CPU."""
    import repro_torch as rt
    cfg = dataclasses.replace(rt.PAPER_CONFIGS[name], engine=engine)
    a = paper_matrix(n, seed, cfg.high_dtype)
    lg = rt.cholesky(a, cfg).cpu()
    lc = rt.cholesky(a.cpu(), cfg)
    rel = float((lg.double() - lc.double()).abs().max()
                / lc.double().abs().max())
    tol = TOL[cfg.levels[0]]
    if not rel < tol:
        raise AssertionError(f"{name} {engine} n={n}: card vs CPU {rel:g} >= "
                             f"{tol:g}")
    return {"ladder": name, "engine": engine, "n": n, "rel_err": rel,
            "tol": tol}


# ---------------------------------------------------------------------------
# phase 9: model serving, the dense transformer family
# ---------------------------------------------------------------------------
def nonzero_leaves(cfg, params, seed):
    """Draw anew, in place, the leaves that init sets to zero or one in
    the recurrent families, as tests/test_torch_recurrent.py draws them
    (rwkv's ``mu``, ``mu_c`` in (0.05, 0.95), ``w0`` in (-1, 1), ``u``
    N(0, 1), ``ln_x`` 0.2 N(0, 1); mamba's ``A_log`` 0.5 N(0, 1), ``D`` in
    (0.5, 1.5), ``dt_bias`` 0.5 N(0, 1)), from a generator seeded with
    ``seed`` on their device: at zero the token shift is a no-op and the
    bonus vanishes, so a wrong carry would pass every contract. Other
    families are left as they are."""
    if cfg.family == "rwkv":
        draws = {"mu": ("uniform", 0.05, 0.95), "mu_c": ("uniform", 0.05,
                                                         0.95),
                 "w0": ("uniform", -1.0, 1.0), "u": ("normal", 0.0, 1.0),
                 "ln_x": ("normal", 0.0, 0.2)}
    elif cfg.family == "hybrid":
        draws = {"A_log": ("normal", 0.0, 0.5), "D": ("uniform", 0.5, 1.5),
                 "dt_bias": ("normal", 0.0, 0.5)}
    else:
        return
    g = torch.Generator(device=params["embed"].device).manual_seed(seed)
    for layer in params["layers"]:
        for key, (kind, a, b) in draws.items():
            t = torch.empty(layer[key].shape, dtype=torch.float32,
                            device=layer[key].device)
            if kind == "uniform":
                t.uniform_(a, b, generator=g)
            else:
                t.normal_(a, b, generator=g)
            layer[key].copy_(t)


def _tree_map(fn, node):
    """fn on every tensor of nested dicts and lists of parameters."""
    if isinstance(node, dict):
        return {k: _tree_map(fn, v) for k, v in node.items()}
    if isinstance(node, list):
        return [_tree_map(fn, v) for v in node]
    return fn(node)


def flash_per_prefill(cfg) -> int:
    """flash_attention launches of one prefill: one per attention layer,
    none for rwkv, and for the hybrid the shared block's applications,
    ``max(L // attn_every, 1)`` (the reference's ``_forward_hybrid``)."""
    if cfg.family == "rwkv":
        return 0
    if cfg.family == "hybrid":
        return max(cfg.n_layers // (cfg.attn_every or cfg.n_layers), 1)
    return cfg.n_layers


def _model(arch, seed, **overrides):
    """``arch``'s full config (with ``overrides``) and random weights drawn
    on the card from a generator seeded with ``seed`` (the recurrent
    families' zero-initialised leaves drawn nonzero, :func:`nonzero_leaves`,
    with ``seed + 1``)."""
    from repro_torch import configs
    from repro_torch.models import transformer as T
    cfg = configs.get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    params = T.init_params(cfg, seed=seed, device="cuda")
    nonzero_leaves(cfg, params, seed + 1)
    nbytes = 0
    stack = [params]
    while stack:
        node = stack.pop()
        items = node.values() if isinstance(node, dict) else node
        for v in items:
            if torch.is_tensor(v):
                nbytes += v.numel() * v.element_size()
            else:
                stack.append(v)
    return cfg, params, nbytes / 2 ** 30


def _prompt(cfg, batch, length, seed):
    """Random tokens on the card from a generator seeded with ``seed``:
    [batch, length] (audio: [batch, length, n_codebooks])."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (batch, length) + ((cfg.n_codebooks,) if cfg.family == "audio"
                               else ())
    return torch.randint(0, cfg.vocab, shape, generator=g, device="cuda")


def _prompt_batch(cfg, batch, length, seed, device="cuda"):
    """A prompt batch: :func:`_prompt`'s tokens and, for vlm, the stub
    frontend's patch embeddings [batch, n_img_tokens, d] in f32 from a
    generator seeded with ``seed + 1`` (on the card, then moved to
    ``device``)."""
    out = {"tokens": _prompt(cfg, batch, length, seed)}
    if cfg.family == "vlm":
        g = torch.Generator(device="cuda").manual_seed(seed + 1)
        out["patch_embeds"] = torch.randn(
            (batch, cfg.n_img_tokens, cfg.d_model), generator=g,
            device="cuda")
    return {k: v.to(device) for k, v in out.items()}


def _prefix(batch, n):
    """The batch's first n positions (the patch embeddings as they are)."""
    return {k: (v[:, :n] if k == "tokens" else v) for k, v in batch.items()}


def _token_shape(cfg, batch, n):
    return (batch, n) + ((cfg.n_codebooks,) if cfg.family == "audio"
                         else ())


def generate_run(label, cfg, params, param_gib, batch, prompt_len, n_new,
                 seed, note=None, profile=False):
    """One request batch of random prompts through ``generate`` (greedy),
    then the same loop timed: prefill_step by CUDA events, each serve_step
    on the host clock between synchronizations; with ``profile``, one more
    prefill and decode step under torch.profiler. Every prefill must
    launch flash_attention :func:`flash_per_prefill` times (once per
    attention layer), on the route of the model's dtype; every logit must
    be finite."""
    from repro_torch import serve
    from repro_torch.models import transformer as T
    prompt = _prompt_batch(cfg, batch, prompt_len, seed)
    L = flash_per_prefill(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = flash_launches(cfg.adt)
    t0 = time.perf_counter()
    out = serve.generate(params, prompt, cfg, n_tokens=n_new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    flash_gen = flash_launches(cfg.adt) - before
    what = f"{label} {cfg.name} B={batch} S={prompt_len}"
    if flash_gen != L:
        raise AssertionError(f"{what}: generate launched flash_attention "
                             f"{flash_gen} times, not {L} (one a prefill "
                             "per attention layer)")
    if (tuple(out.shape) != _token_shape(cfg, batch, n_new)
            or int(out.min()) < 0 or int(out.max()) >= cfg.vocab):
        raise AssertionError(f"{what}: bad tokens {tuple(out.shape)}")
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    before = flash_launches(cfg.adt)
    start.record()
    last, caches = serve.prefill_step(params, prompt, cfg)
    stop.record()
    torch.cuda.synchronize()
    prefill_ms = start.elapsed_time(stop)
    flash_prefill = flash_launches(cfg.adt) - before
    if flash_prefill != L:
        raise AssertionError(f"{what}: prefill launched flash_attention "
                             f"{flash_prefill} times, not {L}")
    caches = T.pad_caches(caches, prompt_len + n_new)
    finite = [bool(torch.isfinite(last).all())]
    tok = serve.pick(last, cfg)
    toks, steps = [tok], []
    for i in range(1, n_new):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = serve.serve_step(params, caches, tok,
                                          prompt_len + i - 1, cfg)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
        finite.append(bool(torch.isfinite(logits).all()))
        tok = serve.pick(logits, cfg)
        toks.append(tok)
    if not all(finite):
        raise AssertionError(f"{what}: non-finite logits")
    step_ms = statistics.median(steps)
    line = {"phase": label, "arch": cfg.name, "n_layers": cfg.n_layers,
            "dtype": cfg.activ_dtype, "param_gib": param_gib,
            "batch": batch, "prompt_len": prompt_len, "new_tokens": n_new,
            "generate_s": gen_s,
            "generate_tok_per_s": batch * n_new / gen_s,
            "prefill_ms": prefill_ms,
            "prefill_tok_per_s": batch * prompt_len / prefill_ms * 1e3,
            "decode_ms_per_step_median": step_ms,
            "decode_ms_per_step_min": min(steps),
            "decode_ms_per_step_max": max(steps),
            "decode_tok_per_s": batch / step_ms * 1e3,
            "peak_gib": peak, "flash_launches_per_prefill": flash_prefill,
            "flash_head_dim": cfg.hd if L else None,
            "logits_finite": True,
            "timed_loop_tokens_equal_generate": torch.equal(
                torch.cat(toks, dim=1), out)}
    if note:
        line["note"] = note
    if profile:
        line["prefill_profiled"] = _profiled(
            lambda: serve.prefill_step(params, prompt, cfg))
        line["decode_step_profiled"] = _profiled(
            lambda: serve.serve_step(params, caches, tok,
                                     prompt_len + n_new - 1, cfg))
    del caches
    torch.cuda.empty_cache()
    return line


#: The bf16 decode-vs-prefill gap has no tight derivation: the 2 L
#: branch outputs round to bf16 in both paths and the next layers mix
#: those roundings, so 2 L 2^-8 max|logits| is only a ceiling (0.68 at
#: gemma-2b's 18 layers, 9 times the reading). The gate is the smaller
#: of that and 3 x the largest reading of the sound runs at these seeds
#: (this script on an NVIDIA H100 80GB HBM3 at 700 W; the same seeds
#: read the same in every run); the f32 run holds the reference's 5e-4.
#: An MoE layer adds the router, which is not continuous: a token whose
#: k-th and (k+1)-th expert are closer than the bf16 noise of its input
#: picks another expert in decode than in prefill, and its hidden state
#: moves by the expert's output (max ~268 on unit-RMS inputs at
#: deepseek-v2-lite's layer 0: the reference's init draws the expert
#: stacks at fan-in E), so the logits would move by as much as they
#: measure. The contract therefore replays the full prefill's experts in
#: the prefix's prefill and in the decode step (:func:`_replayed_routes`,
#: the gates from each run's own probabilities): the ceiling's
#: derivation holds again, and the flips that the runs' own routers
#: would have made are reported beside the reading, not gated.
#: zamba2's contract is 128 teacher-forced steps after a prefix of 896
#: (:func:`decode_contract_steps`): its reading is the largest gap over
#: the 129 positions compared, which grows with the steps (0.148 at the
#: first, 1.56 at the last) as the bf16 roundings of the two paths travel
#: through the recurrent states and the KV cache; 3 x the reading is
#: above the ceiling, which then gates it. Its line reports the bf16
#: prefill's own distance from the same prefill on f32 weights: 2.66 at
#: these seeds (this script on an NVIDIA H100 80GB HBM3 at 700 W), more
#: than the decode's gap, which is the bf16 model's own noise.
_BF16_CONTRACT_READ = {"gemma-2b": 0.07421875, "nemotron-4-15b": 0.03125,
                       "deepseek-v2-lite-16b": 0.6171875,
                       "deepseek-v3-671b": 0.095703125,
                       "pixtral-12b": 0.109375, "musicgen-large": 1.25,
                       "rwkv6-3b": 0.107421875,
                       "zamba2-2.7b": 1.5859375}


@contextlib.contextmanager
def _recorded_routes():
    """Every ``moe.route`` call's top-k experts, in call order (one per
    MoE layer and forward), while the block runs."""
    from repro_torch.models import moe
    calls, route = [], moe.route

    def recording(xf, router_w, k):
        out = route(xf, router_w, k)
        calls.append(out[2])
        return out
    moe.route = recording
    try:
        yield calls
    finally:
        moe.route = route


@contextlib.contextmanager
def _replayed_routes(full, pick):
    """While the block runs, the i-th ``moe.route`` call returns the
    experts ``pick(full[i])`` (rows of the full prefill's i-th call) with
    the gates taken from this call's own probabilities and renormalised
    as ``moe.route`` does; the experts this call's router chose itself
    are collected in the list yielded."""
    from repro_torch.models import moe
    own, route = [], moe.route

    def replaying(xf, router_w, k):
        probs, _, idx_own = route(xf, router_w, k)
        idx = pick(full[len(own)])
        own.append(idx_own)
        gate = probs.gather(-1, idx)
        gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
        return probs, gate, idx
    moe.route = replaying
    try:
        yield own
    finally:
        moe.route = route


def _flips(want, got):
    """Rows whose top-k expert sets differ."""
    return int((want.sort(-1).values != got.sort(-1).values).any(-1).sum())


def decode_contract(label, cfg, params, batch, length, seed):
    """The reference's contract (tests/test_archs.py:55-77) at size:
    prefill length - 1 tokens, pad the caches, decode the last token; its
    logits against the full prefill's last logits. MoE layers replay the
    full prefill's experts in both later runs (see
    :data:`_BF16_CONTRACT_READ`)."""
    from repro_torch import serve
    from repro_torch.models import transformer as T
    prompt = _prompt_batch(cfg, batch, length, seed)
    with _recorded_routes() as full_routes:
        full, _ = serve.prefill_step(params, prompt, cfg)
    K = cfg.moe_topk

    def rows(f, sl):
        return f.reshape(batch, length, -1)[:, sl].reshape(-1, K)
    head, last = slice(0, length - 1), slice(length - 1, length)
    with _replayed_routes(full_routes, lambda f: rows(f, head)) as pre:
        _, caches = serve.prefill_step(params, _prefix(prompt, length - 1),
                                       cfg)
    caches = T.pad_caches(caches, length)
    with _replayed_routes(full_routes, lambda f: rows(f, last)) as own:
        dec, _ = serve.serve_step(params, caches,
                                  prompt["tokens"][:, -1:], length - 1, cfg)
    what = f"{label} {cfg.name} decode vs prefill"
    if not (bool(torch.isfinite(full).all())
            and bool(torch.isfinite(dec).all())):
        raise AssertionError(f"{what}: non-finite logits")
    err = float((dec - full).abs().max())
    scale = float(full.abs().max())
    tol, how = _contract_gate(cfg, scale)
    line = {"phase": f"{label}_decode_vs_prefill", "arch": cfg.name,
            "n_layers": cfg.n_layers, "dtype": cfg.activ_dtype,
            "batch": batch, "length": length, "max_abs_err": err,
            "max_abs_logit": scale, "tol": tol, "tol_is": how,
            "argmax_agree_share": float(
                (dec.argmax(-1) == full.argmax(-1)).float().mean())}
    if full_routes:
        line["moe_layers_replayed"] = len(full_routes)
        line["own_routing_flips_decode_by_moe_layer"] = [
            _flips(rows(f, last), o) for f, o in zip(full_routes, own)]
        line["own_routing_flips_prefix_by_moe_layer"] = [
            _flips(rows(f, head), o) for f, o in zip(full_routes, pre)]
    if not err < tol:
        raise AssertionError(f"{what}: {err:g} >= {tol:g} ({how}); {line}")
    del caches
    torch.cuda.empty_cache()
    return line


def _contract_gate(cfg, scale):
    """(tol, how) of a decode-vs-prefill contract whose prefill logits
    reach ``scale``: the reference's 5e-4 in f32; in bf16 the smaller of
    the ceiling 2 L 2^-8 scale and 3 x the reading in
    :data:`_BF16_CONTRACT_READ`."""
    if cfg.activ_dtype == "f32":
        return 5e-4, "5e-4, the reference's contract"
    read = _BF16_CONTRACT_READ[cfg.name]
    return (min(2 * cfg.n_layers * 2.0 ** -8 * scale, 3 * read),
            f"min(2 L 2^-8 max|logits|, 3 x the sound runs' reading {read:g})")


def decode_contract_steps(label, cfg, params, batch, prefix, steps, seed):
    """The decode contract in the form the hybrid's prefills allow (the
    SSD takes at most 128 positions or a multiple of 128, and attention
    over more than 1024 keys a multiple of 1024, so neither length - 1
    nor 1024 + 128): prefill ``prefix`` tokens, then ``steps``
    teacher-forced decode steps over the rest of a prompt of ``prefix +
    steps`` tokens; the prefix's last logits and every step's against the
    full prompt's prefill at the same positions, gated as
    :func:`decode_contract`."""
    from repro_torch import serve
    from repro_torch.models import transformer as T
    length = prefix + steps
    prompt = _prompt_batch(cfg, batch, length, seed)
    full = T.forward(params, prompt, cfg, mode="prefill")[0]
    last, caches = serve.prefill_step(params, _prefix(prompt, prefix), cfg)
    caches = T.pad_caches(caches, length)
    errs = [float((last - full[:, prefix - 1]).abs().max())]
    agree = [(last.argmax(-1) == full[:, prefix - 1].argmax(-1)).float()]
    finite = bool(torch.isfinite(full).all()) and bool(
        torch.isfinite(last).all())
    for j in range(steps):
        p = prefix + j
        dec, _ = serve.serve_step(params, caches,
                                  prompt["tokens"][:, p:p + 1], p, cfg)
        finite = finite and bool(torch.isfinite(dec).all())
        errs.append(float((dec - full[:, p]).abs().max()))
        agree.append((dec.argmax(-1) == full[:, p].argmax(-1)).float())
    what = f"{label} {cfg.name} decode vs prefill"
    if not finite:
        raise AssertionError(f"{what}: non-finite logits")
    err = max(errs)
    scale = float(full[:, prefix - 1:].abs().max())
    tol, how = _contract_gate(cfg, scale)
    full = full[:, prefix - 1:]
    gap = None
    if cfg.activ_dtype != "f32":
        # the same prefill on an f32 copy of the weights: how far the
        # 16-bit model itself is from f32 at these positions, beside the
        # decode's gap from its own prefill (reported, not gated)
        c32 = cfg.replace(param_dtype="f32", activ_dtype="f32")
        p32 = _tree_map(lambda t: t.float(), params)
        gap = float((T.forward(p32, prompt, c32, mode="prefill")[0][
            :, prefix - 1:] - full).abs().max())
        del p32
    line = {"phase": f"{label}_decode_vs_prefill", "arch": cfg.name,
            "n_layers": cfg.n_layers, "dtype": cfg.activ_dtype,
            "batch": batch, "prefix": prefix, "decode_steps": steps,
            "length": length, "max_abs_err": err,
            "max_abs_err_prefix_last": errs[0],
            "max_abs_err_first_step": errs[1],
            "max_abs_err_last_step": errs[-1],
            "max_abs_logit": scale, "tol": tol, "tol_is": how,
            "argmax_agree_share": float(torch.cat(agree).mean()),
            "prefill_vs_f32_weights_max_abs": gap}
    if not err < tol:
        raise AssertionError(f"{what}: {err:g} >= {tol:g} ({how}); {line}")
    del caches, full
    torch.cuda.empty_cache()
    return line


def token_exact(label, cfg, params, batch, length, n_new, seed):
    """tests/test_serve.py:14-41 at size: greedy generate equals re-running
    the full prefill for every new token."""
    from repro_torch import serve
    prompt = _prompt_batch(cfg, batch, length, seed)
    got = serve.generate(params, prompt, cfg, n_tokens=n_new)
    cur = dict(prompt)
    for _ in range(n_new):
        last, _ = serve.prefill_step(params, cur, cfg)
        cur["tokens"] = torch.cat([cur["tokens"], serve.pick(last, cfg)],
                                  dim=1)
    want = cur["tokens"][:, length:]
    if not torch.equal(got, want):
        raise AssertionError(f"{label} {cfg.name}: generate != "
                             f"teacher-forced greedy: {got.tolist()} vs "
                             f"{want.tolist()}")
    return {"phase": label, "arch": cfg.name, "n_layers": cfg.n_layers,
            "dtype": cfg.activ_dtype, "batch": batch, "prompt_len": length,
            "new_tokens": n_new, "generate_equals_teacher_forced": True}


#: the smoke MLA configs' head dim dn + dr = 32 + 16 = 48 is none the
#: flash kernels are built for (flash.HEAD_DIMS): the card runs them at
#: nope_head_dim 48, dn + dr = 64, on both sides
_SMOKE_OVERRIDES = {"deepseek-v2-lite-16b": {"nope_head_dim": 48},
                    "deepseek-v3-671b": {"nope_head_dim": 48}}


def model_cpu_agreement(arch, seed):
    """Prefill logits of a smoke config on the card against the same port
    run on the CPU (the plain versions), f32 on the same weights; 1e-4 as
    tests/test_torch_models.py holds the port to the reference (f32 sums
    in other orders move these logits by a few 1e-6)."""
    from repro_torch import configs
    from repro_torch.models import transformer as T
    cfg = configs.get_config(arch, smoke=True)
    over = _SMOKE_OVERRIDES.get(arch, {})
    cfg = cfg.replace(**over)
    pc = T.init_params(cfg, seed=seed, device="cpu")
    nonzero_leaves(cfg, pc, seed + 1)

    pg = _tree_map(lambda t: t.cuda(), pc)
    bc = _prompt_batch(cfg, 2, 48, seed, device="cpu")
    lc = T.forward(pc, bc, cfg, mode="prefill")[0]
    lg = T.forward(pg, {k: v.cuda() for k, v in bc.items()}, cfg,
                   mode="prefill")[0]
    err = check_close(f"{arch} smoke card vs CPU", lg.cpu(), lc, 0, 1e-4)
    line = {"arch": cfg.name, "shape": [2, 48], "max_abs_err": err,
            "tol": 1e-4}
    if over:
        line["overrides"] = over
    return line


#: The first-order bound below is a worst case (every rounding and every
#: f32 sum's error the same way), 1682 against outputs of 268 in bf16 at
#: deepseek-v2-lite's layer 0, so each case is also held to a data-scaled
#: atol: 8 u max|out| for the roundings to the type (h, g, silu(g) h,
#: the expert output, its gate weight, the adds: each at most a unit, and
#: summing like a walk), plus 4 (sqrt(D) + sqrt(F)) 2^-24 max|out| for
#: the f32 sums in other orders (their random-walk growth), with room
#: over the readings (f32 4.3e-4 and bf16 2.0 against 5.4e-3 and 8.4 on
#: 512 rows, bf16 1.0 against 5.5 on 4, on an NVIDIA H100 80GB HBM3 at
#: 700 W; the same seeds read the same in every run).
_MOE_DATA_TOL = ("atol (8 u + 4 (sqrt(D) + sqrt(F)) 2^-24) max|out|, "
                 "u = 2^-8 in bf16, 2^-24 in f32")
_MOE_TOL = ("first-order bound, each side: sum_k g_k [eps_in (P_k @ "
            "|W_out|) + ((K + 3) u + (F + E) 2^-24) (|a_k| @ |W_out|)], "
            "a = silu(g) h, P = |silu(g)| (|x| @ |W_in|) + 1.1 |h| (|x| @ "
            "|W_gate|), eps_in = u + D 2^-24; twice that, the max over "
            "outputs; u = 2^-8 in bf16, 2^-24 in f32")


def _moe_tol(x, p, cfg, u):
    """The routed output's tolerance against the dense oracle for inputs
    of unit roundoff u (:data:`_MOE_TOL`), in f32 on x's [T, D] rows:
    each side rounds h, g, silu(g) h, the expert output, its gate weight
    and K adds (or the oracle's E-term combine) to x's type, and sums D
    and F products in f32 in an order of its own."""
    from repro_torch.models import moe
    import torch.nn.functional as F
    T, D = x.shape[0] * x.shape[1], cfg.d_model
    E, K, Fd = cfg.moe_experts, cfg.moe_topk, cfg.moe_dff
    xf = x.reshape(T, D).float()
    w_in, w_gate, w_out = (p[k].float() for k in ("w_in", "w_gate",
                                                  "w_out"))
    _, gate, idx = moe.route(xf, p["router"], K)
    wts = torch.zeros((T, E), device=x.device).scatter_(1, idx, gate)
    h = torch.einsum("td,edf->tef", xf, w_in)
    g = torch.einsum("td,edf->tef", xf, w_gate)
    a = F.silu(g) * h
    ax = xf.abs()
    P = (F.silu(g).abs() * torch.einsum("td,edf->tef", ax, w_in.abs())
         + 1.1 * h.abs() * torch.einsum("td,edf->tef", ax, w_gate.abs()))
    del g
    eps_in = u + D * 2.0 ** -24
    eps_out = (K + 3) * u + (Fd + E) * 2.0 ** -24
    wo = w_out.abs()
    side = torch.einsum("te,ted->td", wts,
                        eps_in * torch.einsum("tef,efd->ted", P, wo)
                        + eps_out * torch.einsum("tef,efd->ted", a.abs(),
                                                 wo))
    return 2 * float(side.max())


def _moe_routed_and_oracle(cfg, pw, x, reduced):
    """The routed path (twice) and the dense oracle on x, with cuBLAS's
    reduced-precision bf16 reductions set to ``reduced`` and restored
    after."""
    from repro_torch.models import moe
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        reduced
    try:
        got, _, routing = moe.moe_local(x, pw["router"], pw["w_in"],
                                        pw["w_gate"], pw["w_out"], cfg=cfg)
        again = moe.moe_local(x, pw["router"], pw["w_in"], pw["w_gate"],
                              pw["w_out"], cfg=cfg)[0]
        want = moe.moe_ffn_dense_reference(x, pw, cfg)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            flag
    return got, again, want, routing


def moe_oracle(cfg, params, cases, seed):
    """Layer 0's routed experts at full width on random rows, for each
    ``(dtype, tokens)`` of ``cases`` (f32: the bf16 weights widened),
    against the dense per-expert oracle (``moe.moe_ffn_dense_reference``)
    within :func:`_moe_tol` and a data-scaled atol; the two route alike,
    and two runs of the routed path give the same bits. The runs use the
    served setting of cuBLAS's reduced-precision bf16 reductions (on by
    default); the bounds assume f32 sums, so a bf16 case is run with them
    off as well and must give the same bits on both sides (on the H100
    with torch 2.11 and CUDA 12.8 they do: the expert products take no
    split-K reduction), which carries the check over to the served
    setting. Times: the routed path and the oracle (events), the expert
    loop's products by profile."""
    from repro_torch.models import moe
    p = params["layers"][0]["moe"]
    served = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    runs = []
    for dt, tokens in cases:
        u = 2.0 ** -8 if dt == torch.bfloat16 else 2.0 ** -24
        g = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randn((1, tokens, cfg.d_model), generator=g,
                        device="cuda").to(dt)
        pw = {k: (v if k == "router" else v.to(dt))
              for k, v in p.items() if k != "shared"}
        got, again, want, routing = _moe_routed_and_oracle(cfg, pw, x,
                                                           served)
        what = f"moe {cfg.name} layer 0 {_TNAME[dt]} T={tokens}"
        _, _, idx = moe.route(x.reshape(tokens, -1), pw["router"],
                              cfg.moe_topk)
        if not torch.equal(routing["idx"], idx):
            raise AssertionError(f"{what}: the oracle routes otherwise")
        if not torch.equal(got, again):
            raise AssertionError(f"{what}: two runs differ")
        if dt == torch.bfloat16:
            g32, _, w32, _ = _moe_routed_and_oracle(cfg, pw, x, False)
            if not (torch.equal(got, g32) and torch.equal(want, w32)):
                raise AssertionError(
                    f"{what}: cuBLAS's reduced-precision reductions change "
                    "the bits, and the bounds assume f32 sums")
            del g32, w32
        tol = _moe_tol(x, pw, cfg, u)
        err = check_close(what, got.float(), want.float(), 0, tol)
        out_max = float(want.abs().max())
        data_tol = (8 * u + 4 * (math.sqrt(cfg.d_model)
                                 + math.sqrt(cfg.moe_dff))
                    * 2.0 ** -24) * out_max
        check_close(f"{what} (data-scaled)", got.float(), want.float(),
                    0, data_tol)

        def routed():
            return moe.moe_local(x, pw["router"], pw["w_in"], pw["w_gate"],
                                 pw["w_out"], cfg=cfg)
        runs.append({
            "dtype": _TNAME[dt], "tokens": tokens,
            "cublas_bf16_reduced_reductions": served,
            "same_bits_with_them_off": True if dt == torch.bfloat16
            else None,
            "experts_used": int(routing["idx"].unique().numel()),
            "max_abs_err": err, "tol": tol, "tol_is": _MOE_TOL,
            "data_tol": data_tol, "data_tol_is": _MOE_DATA_TOL,
            "max_abs_out": out_max, "repeat_bitwise": True,
            "routed_ms": cuda_ms(routed, reps=5, warmup=1),
            "oracle_ms": cuda_ms(
                lambda: moe.moe_ffn_dense_reference(x, pw, cfg),
                reps=3, warmup=1),
            "routed_profiled": _profiled(routed)})
        del pw, got, again, want
        torch.cuda.empty_cache()
    return {"phase": "moe_oracle", "arch": cfg.name,
            "experts": cfg.moe_experts, "topk": cfg.moe_topk,
            "shared": cfg.moe_shared, "d_ff_expert": cfg.moe_dff,
            "d_model": cfg.d_model, "runs": runs}


# ---------------------------------------------------------------------------
# training: K-FAC's batched kernels and the gemma-2b train step
# ---------------------------------------------------------------------------
#: the batched entries' ops.BATCHED names (their kernels are KERNELS')
BATCHED_OF = {"potrf_leaf_batched": "potrf_leaf",
              "tri_inv_leaf_batched": "tri_inv_leaf",
              "panel_update_batched": "panel_update",
              "qgemm_batched": "qgemm"}
#: the solver kernels K-FAC's refactor and whitening launch
KFAC_KERNELS = ("potrf_leaf", "tri_inv_leaf", "qgemm", "panel_update")
#: the kernels the train phase must launch
TRAIN_KERNELS = tuple(BATCHED_OF) + ("flash_attention",)
#: the train phase's batch: B sequences of S tokens of gemma-2b
TRAIN_B, TRAIN_S = 2, 2048


def kfac_blocks(cfg, block):
    """{dout: number of (block x block) statistics} of the dense model's
    eligible matrices (kfac.ELIGIBLE) at ``cfg``'s widths, from its shapes
    alone: the whitening's batches; their sum is the refactor's."""
    d, hq, hkv = cfg.d_model, cfg.n_heads * cfg.hd, cfg.n_kv * cfg.hd
    shapes = [(d, hq), (d, hkv), (d, hkv), (hq, d), (d, cfg.d_ff),
              (d, cfg.d_ff), (cfg.d_ff, d)]
    out = {}
    for din, dout in shapes:
        if din % block == 0:
            out[dout] = out.get(dout, 0) + cfg.n_layers * din // block
    return out


def tree_left_schedule(n, cfg):
    """(tri_inv_leaf, qgemm) launches of one batched tree_trsm_left sweep
    of order n: a batched tri_inv and qgemm a leaf, one qgemm a node."""
    if n <= cfg.leaf:
        return 1, 1
    a = tree_left_schedule(cfg.split(n), cfg)
    b = tree_left_schedule(n - cfg.split(n), cfg)
    return a[0] + b[0], a[1] + b[1] + 1


def kfac_schedule(tn, ngroups, refactor):
    """The solver launches of one TreeNewton step: per whitening group two
    sweeps (refine_sweeps 0); with a refactor, T potrf_leaf, T - 1
    tri_inv_leaf and T - 1 panel_update (T = block / leaf), one batch for
    every block."""
    ti, qg = tree_left_schedule(tn.block, tn.precision)
    T = tn.block // tn.precision.leaf
    return {"potrf_leaf": T if refactor else 0,
            "tri_inv_leaf": 2 * ti * ngroups + (T - 1 if refactor else 0),
            "qgemm": 2 * qg * ngroups,
            "panel_update": T - 1 if refactor else 0}


def _blocks_err(what, got, want, rel):
    """max over the blocks of a stack of max|got - want| / max|want|
    (each block against its own scale); raise above ``rel``."""
    g = got.double().flatten(1)
    w = want.double().flatten(1)
    if not torch.equal(torch.isnan(g), torch.isnan(w)):
        raise AssertionError(f"{what}: NaN pattern differs")
    err = float(((g - w).abs().nan_to_num(0.0).amax(1)
                 / w.abs().nan_to_num(0.0).amax(1).clamp_min(1e-30)).max())
    if err > rel:
        raise AssertionError(f"{what}: {err:g} of a block's largest entry, "
                             f"over {rel:g}")
    return err


def _each_bitwise(what, got, one):
    """Element i of a batched result bitwise ``one(i)``, for every i."""
    for i in range(got.shape[0]):
        _bitwise(f"{what} element {i}", got[i], one(i))
    return True


def timed_once(fn):
    """(fn(), its device ms by CUDA events around the one call)."""
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    res = fn()
    stop.record()
    torch.cuda.synchronize()
    return res, start.elapsed_time(stop)


def _kfac_stack(gen, N, n):
    """N SPD blocks of order n, as K-FAC's damped statistics are: the
    paper's matrix (symmetric uniform(-1, 1), +n on the diagonal) times a
    scale per block from 1e-3 to 1e3, so that a scale shared across the
    batch would show."""
    a = torch.rand((N, n, n), generator=gen, device="cuda") * 2 - 1
    a = (a + a.transpose(1, 2)) / 2
    a.diagonal(dim1=1, dim2=2).add_(n)
    e = torch.rand((N, 1, 1), generator=gen, device="cuda") * 6 - 3
    return a * 10.0 ** e


_KFAC_TIMING = ("ms: CUDA events around 5 batched launches; single_ms_x_n: "
                "one launch's events mean (20 launches) times N")


def kernel_kfac_batched(rates, gen):
    """The batched entries at K-FAC's shapes on gemma-2b (N = 1008 blocks
    of 512, leaf 128, bf16_f32; the whitening's groups by dout): each
    element bitwise the one-matrix launch on it, within tolerance of the
    batched plain version, timed beside one launch's time N times, the
    plain version and a library call on the batch."""
    from repro_torch import configs
    from repro_torch.core.plan import build_plan
    from repro_torch.core.precision import PAPER_CONFIGS
    from repro_torch.kernels import panel, potrf, qgemm, ref
    cfg = PAPER_CONFIGS["bf16_f32"]
    b, n = 128, 512
    cfg = dataclasses.replace(cfg, leaf=b)
    groups = kfac_blocks(configs.get_config("gemma-2b"), n)
    N = sum(groups.values())
    a = _kfac_stack(gen, N, n)
    out, checks = {}, []

    # potrf_leaf: the refactor's first diagonal tiles
    t = a[:, :b, :b].contiguous()
    got = potrf.potrf_leaf_batched(t)
    _each_bitwise("potrf_leaf_batched", got, lambda i: potrf.potrf_leaf(t[i]))
    want, plain_ms = timed_once(lambda: ref.potrf_batched_ref(t))
    err = _blocks_err("potrf_leaf_batched", got, want, 1e-5)
    bound, by = bound_ms(N * b ** 3 / 3, N * leaf_bytes(b, 4), "f32", rates)
    out["potrf_leaf_batched"] = {
        "shape": [N, b, b], "max_abs_err": err,
        "tol": "1e-5 of each block's largest entry", "bitwise_each": True,
        "ms": cuda_ms(lambda: potrf.potrf_leaf_batched(t), reps=5),
        "single_ms_x_n": cuda_ms(lambda: potrf.potrf_leaf(t[0])) * N,
        "plain_ms": plain_ms,
        "library_ms": cuda_ms(lambda: torch.linalg.cholesky_ex(t), reps=5),
        "library": "torch.linalg.cholesky_ex on the (N, b, b) batch",
        "bound_ms": bound, "bound_by": by}
    # tri_inv_leaf on those factors
    l = got
    inv = potrf.tri_inv_leaf_batched(l)
    _each_bitwise("tri_inv_leaf_batched", inv,
                  lambda i: potrf.tri_inv_leaf(l[i]))
    want, plain_ms = timed_once(lambda: ref.tri_inv_batched_ref(l))
    err = _blocks_err("tri_inv_leaf_batched", inv, want, 1e-5)
    eye = torch.eye(b, device="cuda").expand(N, b, b)
    out["tri_inv_leaf_batched"] = {
        "shape": [N, b, b], "max_abs_err": err,
        "tol": "1e-5 of each block's largest entry", "bitwise_each": True,
        "ms": cuda_ms(lambda: potrf.tri_inv_leaf_batched(l), reps=5),
        "single_ms_x_n": cuda_ms(lambda: potrf.tri_inv_leaf(l[0])) * N,
        "plain_ms": plain_ms,
        "library_ms": cuda_ms(lambda: torch.linalg.solve_triangular(
            l, eye, upper=False), reps=5),
        "library": "torch.linalg.solve_triangular(l, I) on the batch",
        "bound_ms": bound, "bound_by": by}
    del t

    # panel_update: panels 0, 1, 2 of the refactor (m = 384, 256, 128)
    plan = build_plan(n, cfg)
    linv = inv.clone()
    panels = []
    for p in range(n // b - 1):
        r0, r1 = p * b, (p + 1) * b
        meta = plan.panel_meta(p)
        kw = dict(store_names=meta.store_names,
                  store_quants=meta.store_quants,
                  pair_names=meta.pair_names, pair_quants=meta.pair_quants)
        m = n - r1
        w = a.clone()
        panel.panel_update(linv, w[:, r1:, r0:r1], w[:, r1:, r1:], **kw)
        line = {"panel": p, "shape": [N, m, b]}
        if p == 0:
            def one(i):
                wi = a[i].clone()
                panel.panel_update(linv[i], wi[r1:, r0:r1], wi[r1:, r1:],
                                   **kw)
                return wi
            _each_bitwise("panel_update_batched", w, one)
            (want_l, want_c), plain_ms = timed_once(
                lambda: ref.panel_update_batched_ref(
                    linv, a[:, r1:, r0:r1], a[:, r1:, r1:], **kw))
            unit = GRID["bf16"]
            err = max(_blocks_err("panel_update_batched l21",
                                  w[:, r1:, r0:r1], want_l, unit),
                      _blocks_err("panel_update_batched c", w[:, r1:, r1:],
                                  want_c, unit))
            line.update(max_abs_err=err, bitwise_each=True,
                        tol=f"{unit:g} of each block's largest entry",
                        plain_ms=plain_ms)
            del want_l, want_c
        w2 = a.clone()
        line["ms"] = cuda_ms(lambda: panel.panel_update(
            linv, w2[:, r1:, r0:r1], w2[:, r1:, r1:], **kw), reps=5,
            warmup=1)
        w3 = a[0].clone()
        line["single_ms_x_n"] = cuda_ms(lambda: panel.panel_update(
            linv[0], w3[r1:, r0:r1], w3[r1:, r1:], **kw)) * N
        l21 = w[:, r1:, r0:r1].contiguous()
        c = w[:, r1:, r1:].contiguous()
        line["library_ms"] = cuda_ms(lambda: torch.baddbmm(
            c, l21, l21.transpose(1, 2), alpha=-1.0), reps=5)
        single = _panel_bound(meta, m, b, 4, rates)
        line.update(bound_ms=single["bound_ms"] * N,
                    bound_by=single["bound_by"])
        panels.append(line)
        del w, w2, l21, c
    head = panels[0]
    out["panel_update_batched"] = {
        **head, "ladder": "bf16_f32", "panels": panels,
        "library": "torch.baddbmm(c, l21, l21^T, alpha=-1), f32, on the "
                   "batch: the trailing update alone, no rounding"}
    del linv, inv, l
    torch.cuda.empty_cache()

    # qgemm: the whitening's three calls per group (level 0 bf16 on the
    # tensor cores, level 1 f32, a leaf's product with its inverse)
    shapes = []
    for dout, nb in sorted(groups.items()):
        x = torch.randn((nb, n, dout), generator=gen, device="cuda")
        lw = a[:nb]
        s = -torch.ones(nb, device="cuda")
        calls = {
            "level0_bf16": (lw[:, 256:, :256].to(torch.bfloat16),
                            x[:, :256].to(torch.bfloat16), s, x[:, 256:],
                            1.0, "bf16"),
            "level1_f32": (lw[:, 128:256, :128], x[:, :128], -1.0,
                           x[:, 128:256], 1.0, "f32"),
            "leaf_f32": (lw[:, :128, :128].contiguous(), x[:, :128], 1.0,
                         None, 0.0, "f32")}
        for name, (qa, qb, sc, qc, beta, kind) in calls.items():
            got = qgemm.qgemm(qa, qb, sc, c=qc, beta=beta)
            sf = [float(sc[i]) if torch.is_tensor(sc) else sc
                  for i in range(nb)]
            _each_bitwise(f"qgemm_batched {name} dout={dout}", got,
                          lambda i: qgemm.qgemm(qa[i], qb[i], sf[i],
                                                c=None if qc is None
                                                else qc[i], beta=beta))
            # the plain version (one column at a time) on every product of
            # the smallest group, on the first and last of the others
            full = dout == min(groups)
            sample = list(range(nb)) if full else [0, nb - 1]
            want, plain_ms = timed_once(lambda: ref.qgemm_batched_ref(
                qa[sample], qb[sample],
                scale=sc[sample] if torch.is_tensor(sc) else sc,
                c=None if qc is None else qc[sample], beta=beta))
            err = 0.0
            for j, i in enumerate(sample):
                atol = _qgemm_gamma(qa[i], qb[i].T, sf[i],
                                    None if qc is None else qc[i], beta,
                                    qa.shape[-1])
                err = max(err, check_close(
                    f"qgemm_batched {name} dout={dout} element {i}",
                    got[i], want[j], 0, atol))
            M, K = qa.shape[-2:]
            nbytes = (qa.numel() * qa.element_size()
                      + qb.numel() * qb.element_size()
                      + nb * M * dout * 4 * (2 if qc is not None else 1))
            bound, by = bound_ms(2.0 * nb * M * K * dout, nbytes, kind,
                                 rates)
            cq = qc if qc is not None else torch.zeros(
                (nb, M, dout), device="cuda")
            if kind == "bf16":
                try:
                    lib = (lambda: torch.baddbmm(cq, qa, qb, alpha=-1.0,
                                                 out_dtype=torch.float32),
                           "torch.baddbmm(c, a, b, alpha=-1, "
                           "out_dtype=f32)")
                    lib[0]()
                except (TypeError, RuntimeError):
                    c16 = cq.to(torch.bfloat16)
                    lib = (lambda: torch.baddbmm(c16, qa, qb, alpha=-1.0),
                           "torch.baddbmm in bf16: output in bf16, speed "
                           "only")
            else:
                lib = (lambda: torch.baddbmm(cq, qa, qb, alpha=-1.0),
                       "torch.baddbmm(c, a, b, alpha=-1), f32")
            row = {"call": name, "dout": dout, "shape": [nb, M, K, dout],
                   "max_abs_err": err, "bitwise_each": True,
                   "tol": "data-scaled gamma atol (_qgemm_gamma), on "
                          + ("every element" if full else
                             f"elements {sample}"),
                   "ms": cuda_ms(lambda: qgemm.qgemm(
                       qa, qb, sc, c=qc, beta=beta), reps=5),
                   "single_ms_x_n": cuda_ms(lambda: qgemm.qgemm(
                       qa[0], qb[0], sf[0],
                       c=None if qc is None else qc[0], beta=beta)) * nb,
                   ("plain_ms" if full else "plain_ms_2_of_n"): plain_ms,
                   "library_ms": cuda_ms(lib[0], reps=5), "library": lib[1],
                   "bound_ms": bound, "bound_by": by}
            shapes.append(row)
        del x, calls
        torch.cuda.empty_cache()
    head = next(r for r in shapes if r["call"] == "level0_bf16"
                and r["dout"] == min(groups))
    out["qgemm_batched"] = {**head, "shapes": shapes}
    for name, line in out.items():
        checks.append({"entry": name, "max_abs_err": line["max_abs_err"],
                       "bitwise_each": True})
    del a
    torch.cuda.empty_cache()
    solves = kfac_solves_agreement(gen, groups, n, b)
    checks.append({"entry": "treenewton_solves", "max_err": {
        k: v["max_err"] for k, v in solves["ladders"].items()}})
    return checks, {"entries": out, "timing": _KFAC_TIMING, "groups": groups,
                    "n_blocks": N, "treenewton_solves": solves}


def _kfac_stats(gen, N, n):
    """N statistics of order n as K-FAC accumulates them, G G^T / k with
    G (n x k, k = 2n) standard normal (condition ~35 once damped, far from
    diagonal: L^-1 and L^-T differ as much as they can), times a scale per
    block from 1e-3 to 1e3."""
    g = torch.randn((N, n, 2 * n), generator=gen, device="cuda")
    a = torch.bmm(g, g.mT) / (2 * n)
    del g
    e = torch.rand((N, 1, 1), generator=gen, device="cuda") * 6 - 3
    return a * 10.0 ** e


#: card vs CPU bounds of TreeNewton's solves, relative to each block's
#: largest entry. On _kfac_stats' statistics the CPU's plain path moves
#: by 4.3e-4 (factors) and 4e-3 (bf16) / 1e-2 (int8) (whitened gradient)
#: when its inputs move by 1e-7; a transposed L11^-1 in the panels moves
#: the factors by 6.4e-2, a transposed leaf inverse the whitened gradient
#: by 0.34-0.36 and an MN-major A read K-major by 0.97 (CPU runs of these
#: mutations on 4 such blocks of 512).
KFAC_SOLVE_TOL = {"refactor": 1e-2, "whiten": 4e-2}
#: blocks a matrix in the solves check (din 2048: wq, wo, w_in, w_gate)
_KFAC_MATRIX_BLOCKS = 4


def kfac_solves_agreement(gen, groups, n, leaf):
    """TreeNewton's solves at K-FAC's shapes on gemma-2b, on statistics far
    from diagonal: the refactor of all N blocks and each whitening group
    (both sweeps and the graft, matrices of 4 blocks) on the card, against
    the CPU's plain path on sampled matrices (the first and last of a
    group; the last alone at dout 16384, whose plain sweeps take the
    longest); whitening from the card's factors on both, under the
    bf16_f32 ladder (the main path's) and int8_f32 (its quantized back
    sweep: L21^T an MN-major int8 operand; dout 256 and 2048)."""
    from repro_torch.core.precision import PAPER_CONFIGS
    from repro_torch.optim import kfac
    N = sum(groups.values())
    a = _kfac_stats(gen, N, n)
    ladders = {}
    t0 = time.perf_counter()
    l = None
    for ladder in ("bf16_f32", "int8_f32"):
        tn = kfac.TreeNewtonConfig(block=n, precision=dataclasses.replace(
            PAPER_CONFIGS[ladder], leaf=leaf))
        row = {"whiten": []}
        if l is None:
            l = kfac._refactor(a, tn)
            sample = [0, N // 2, N - 1]
            want = kfac._refactor(a[sample].cpu(), tn)
            row["refactor"] = {"blocks": sample, "err": _blocks_err(
                f"refactor {ladder} card vs CPU", l[sample].cpu(), want,
                KFAC_SOLVE_TOL["refactor"])}
        off = 0
        for dout, nb in sorted(groups.items()):
            nm = nb // _KFAC_MATRIX_BLOCKS
            if ladder == "int8_f32" and dout > 2048:
                off += nb
                continue
            g = torch.randn((nm, _KFAC_MATRIX_BLOCKS * n, dout),
                            generator=gen, device="cuda")
            blk = [slice(off + i * _KFAC_MATRIX_BLOCKS,
                         off + (i + 1) * _KFAC_MATRIX_BLOCKS)
                   for i in range(nm)]
            items = [(g[i], l[blk[i]], a[blk[i]]) for i in range(nm)]
            got = kfac._whiten_group(items, tn)
            err = 0.0
            picks = [nm - 1] if dout > 2048 else [0, nm - 1]
            for i in picks:
                want = kfac._whiten_group([tuple(t.cpu() for t in items[i])],
                                          tn)[0]
                err = max(err, _blocks_err(
                    f"whiten {ladder} dout={dout} matrix {i} card vs CPU",
                    got[i].cpu().reshape(-1, n, dout),
                    want.reshape(-1, n, dout), KFAC_SOLVE_TOL["whiten"]))
            row["whiten"].append({"dout": dout, "matrices": nm,
                                  "checked": picks, "err": err})
            off += nb
            del g, items, got
        row["max_err"] = max([r["err"] for r in row["whiten"]]
                             + ([row["refactor"]["err"]]
                                if "refactor" in row else []))
        ladders[ladder] = row
    del a, l
    torch.cuda.empty_cache()
    return {"n_blocks": N, "block": n, "leaf": leaf,
            "stats": "G G^T / 2n, G (n x 2n) normal, x 10^U(-3, 3) a block",
            "tol": KFAC_SOLVE_TOL, "ladders": ladders,
            "seconds": time.perf_counter() - t0}


def _train_batch(cfg, B, S, seed):
    """B random sequences of S + 1 tokens on the card: tokens and the
    next-token labels."""
    toks = _prompt(cfg, B, S + 1, seed)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _kfac_launches(before):
    from repro_torch.kernels import ops
    return {k: ops.LAUNCHES[k] - before[k] for k in KFAC_KERNELS}


def _train_steps(step_fn, state, batch, steps, label):
    """``steps`` steps on one batch: each step's loss, device ms (CUDA
    events around the step), solver and flash launches; every loss must
    be finite."""
    from repro_torch.kernels import ops
    rows = []
    for _ in range(steps):
        before = dict(ops.LAUNCHES)
        flash0 = ops.LAUNCHES["flash_attention"]
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        state, m = step_fn(state, batch)
        stop.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        loss = float(m["loss"])
        if not math.isfinite(loss):
            raise AssertionError(f"{label}: loss {loss} at step "
                                 f"{state['step']}")
        rows.append({"step": state["step"], "loss": loss,
                     "ce": float(m["ce"]), "aux": float(m["aux"]),
                     "grad_norm": float(m["grad_norm"]), "lr": float(m["lr"]),
                     "step_ms": start.elapsed_time(stop), "wall_ms": wall,
                     "solver_launches": _kfac_launches(before),
                     "flash_launches": ops.LAUNCHES["flash_attention"]
                     - flash0})
    return state, rows


def _train_configs(block=512, lr=5e-4):
    """The train phase's optimizers: AdamW at ``lr`` (warmup 1, so that
    4 steps on one batch move the loss) and TreeNewton with that AdamW,
    the default bf16_f32 ladder at leaf 128, block 512, a refactor every
    second step."""
    from repro_torch.optim import AdamWConfig, TreeNewtonConfig
    from repro_torch.train import TrainConfig
    adam = AdamWConfig(lr=lr, warmup=1, total_steps=100)
    tn = TreeNewtonConfig(adam=adam, block=block, factor_every=2)
    return (TrainConfig(optimizer="adamw", adam=adam),
            TrainConfig(optimizer="tree_newton", adam=adam, tree_newton=tn))


def _check_schedule(label, rows, tn, ngroups):
    """Each TreeNewton step's solver launches against kfac_schedule."""
    for r in rows:
        want = kfac_schedule(tn, ngroups, r["step"] % tn.factor_every == 0)
        if r["solver_launches"] != want:
            raise AssertionError(f"{label}: step {r['step']} launched "
                                 f"{r['solver_launches']}, the grouped "
                                 f"schedule is {want}")


def train_phase(kind, smi, B=TRAIN_B, S=TRAIN_S):
    """gemma-2b full() (18 layers, d 2048, d_ff 16384, vocab 256000, bf16,
    random weights from a seed) on one batch of B x S tokens: 4 AdamW
    steps, then 4 TreeNewton steps from the same initial weights (a
    refactor at steps 2 and 4); each loss finite and the last below the first for each
    optimizer; every TreeNewton step's solver launches equal to the
    grouped schedule, and equal to a 2-layer copy's; the last factors
    reconstruct their damped statistics within the bf16 ladder's 4e-2 (a
    block's largest entry); one step of each optimizer profiled; the
    refactor and each whitening group timed alone."""
    from repro_torch import configs
    from repro_torch.optim import kfac
    from repro_torch.optim.adamw import leaves
    from repro_torch.train import init_state, make_train_step
    cfg = configs.get_config("gemma-2b")
    t_adam, t_tn = _train_configs()
    tn = t_tn.tree_newton
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = init_state(cfg, t_adam, seed=950, device="cuda")
    batch = _train_batch(cfg, B, S, 951)
    params_gib = sum(p.numel() * p.element_size()
                     for _, p in leaves(state["params"])) / 2 ** 30
    line = {"phase": "train", "arch": cfg.name, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
            "dtype": cfg.param_dtype, "remat": cfg.remat, "batch": B,
            "seq": S, "param_gib": params_gib, "device": kind,
            "nvidia_smi": smi, "timing": "step_ms: CUDA events around one "
            "step (forward, backward, optimizer); wall_ms: host clock to a "
            "synchronize"}
    step = make_train_step(cfg, t_adam)
    state, rows = _train_steps(step, state, batch, 4, "train adamw")
    line["adamw"] = {"steps": rows, "peak_gib":
                     torch.cuda.max_memory_allocated() / 2 ** 30}
    line["adamw"]["profiled"] = _profiled(lambda: step(state, batch))
    # TreeNewton from the same initial weights
    del state
    torch.cuda.empty_cache()
    state = init_state(cfg, t_tn, seed=950, device="cuda")
    groups = kfac.whiten_groups(state["params"], tn)
    nblocks = {d: sum(state["opt"]["stats"][p].shape[0] for p in paths)
               for d, paths in groups.items()}
    torch.cuda.reset_peak_memory_stats()
    step = make_train_step(cfg, t_tn)
    state, rows = _train_steps(step, state, batch, 4, "train tree_newton")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _check_schedule("train tree_newton", rows, tn, len(groups))
    for name, opt_rows in (("adamw", line["adamw"]["steps"]),
                           ("tree_newton", rows)):
        if not opt_rows[-1]["loss"] < opt_rows[0]["loss"]:
            raise AssertionError(f"train {name}: the loss did not fall: "
                                 f"{[r['loss'] for r in opt_rows]}")
    for r in line["adamw"]["steps"] + rows:
        if r["flash_launches"] != 2 * cfg.n_layers:
            raise AssertionError(f"train: {r['flash_launches']} flash "
                                 f"launches a step, not 2 n_layers (the "
                                 f"forward and remat's recompute)")
    # the factors of step 4 against the damped statistics they factor
    opt = state["opt"]
    rec_err = 0.0
    for p, l in opt["factors"].items():
        d = kfac._damped(opt["stats"][p], tn)
        rec = torch.matmul(l, l.transpose(-1, -2))
        rec_err = max(rec_err, float(((rec - d).abs().amax((-2, -1))
                                      / d.abs().amax((-2, -1))).max()))
    if not rec_err < 4e-2:
        raise AssertionError(f"train: factors reconstruct the damped stats "
                             f"only to {rec_err:g}")
    line["tree_newton"] = {
        "steps": rows, "peak_gib": peak, "blocks_by_dout": nblocks,
        "refactor_blocks": sum(nblocks.values()),
        "factor_reconstruction_rel": rec_err,
        "schedule": {"refactor_step": kfac_schedule(tn, len(groups), True),
                     "whiten_only_step": kfac_schedule(tn, len(groups),
                                                       False)}}
    # the optimizer's own parts, each timed alone by CUDA events
    stats = opt["stats"]
    flat = torch.cat([stats[p].reshape(-1, tn.block, tn.block)
                      for p in stats])
    _, refactor_ms = timed_once(lambda: kfac._refactor(flat, tn))
    del flat
    grads = {p: torch.randn(w.shape, device="cuda", dtype=w.dtype)
             for p, w in leaves(state["params"]) if p in stats}
    whiten_ms = {}
    for dout, paths in groups.items():
        items = [(grads[p], opt["factors"][p], stats[p]) for p in paths]
        _, whiten_ms[dout] = timed_once(
            lambda: kfac._whiten_group(items, tn))
    del grads
    line["tree_newton"]["optimizer_ms"] = {
        "refactor": refactor_ms, "whiten_by_dout": whiten_ms,
        "whiten_total": sum(whiten_ms.values())}
    line["tree_newton"]["profiled"] = _profiled(lambda: step(state, batch))
    for part in (line["adamw"], line["tree_newton"]):
        ms = statistics.median(r["step_ms"] for r in part["steps"])
        part["step_ms_median"] = ms
        part["tokens_per_s"] = B * S / ms * 1e3
    del state, step, opt, stats
    torch.cuda.empty_cache()
    return line


def train_depth_check(line):
    """A 2-layer copy of gemma-2b (full width) takes two TreeNewton steps
    (the second with a refactor): its solver launches per step must equal
    the 18-layer run's steps 1 and 2, since the batches do not grow with
    the depth."""
    from repro_torch import configs
    from repro_torch.train import init_state, make_train_step
    cfg = configs.get_config("gemma-2b").replace(n_layers=2)
    _, t_tn = _train_configs()
    torch.cuda.empty_cache()
    state = init_state(cfg, t_tn, seed=960, device="cuda")
    batch = _train_batch(cfg, 1, 512, 961)
    state, rows = _train_steps(make_train_step(cfg, t_tn), state, batch, 2,
                               "train 2 layers")
    deep = line["tree_newton"]["steps"][:2]
    got = [r["solver_launches"] for r in rows]
    want = [r["solver_launches"] for r in deep]
    if got != want:
        raise AssertionError(f"train: 2 layers launched {got}, 18 layers "
                             f"{want}")
    del state
    torch.cuda.empty_cache()
    return {"phase": "train_depth", "n_layers": 2, "batch": 1, "seq": 512,
            "solver_launches_per_step": got,
            "equal_to_18_layers": True}


def _step_close(what, got_p, want_p, m_ref, adam, lr):
    """Parameters after one step on two devices: where the first moment
    says |g| > 100 eps, within 2e-6 + 1e-3 lr (AdamW's first step is flat
    in g there); elsewhere within the step's own size, lr (1 + wd |p|)
    (tests/test_torch_train.py)."""
    from repro_torch.optim.adamw import leaves
    worst = 0.0
    gm = dict(leaves(m_ref))
    for (path, g), (_, w) in zip(leaves(got_p), leaves(want_p)):
        err = (g.float().cpu() - w.float()).abs()
        flat = gm[path].float().abs() / (1 - adam.b1) > 100 * adam.eps
        own = lr * (1 + adam.weight_decay * w.float().abs())
        if bool((err[flat] > 2e-6 + 1e-3 * lr).any()) or bool(
                (err[~flat] > 2e-6 + own[~flat]).any()):
            raise AssertionError(f"{what}: {path} differs by "
                                 f"{float(err.max()):g}")
        worst = max(worst, float(err[flat].max()) if flat.any() else 0.0)
    return worst


def train_cpu_agreement(seed=970):
    """One AdamW step and one TreeNewton step with a refactor (block 256,
    leaf 128: two panels, so every batched kernel runs) of a 2-layer
    dense config (d_model 256, d_ff 512, f32) on the card and on the CPU
    from the same weights and batch: the losses within 1e-5 relative and
    the parameters within _step_close's bounds."""
    from repro_torch.models import transformer as T
    from repro_torch.models.common import ModelConfig
    from repro_torch.optim import AdamWConfig, TreeNewtonConfig
    from repro_torch.optim.adamw import tree_map
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train.step import init_opt
    cfg = ModelConfig(name="train-agree", family="dense", n_layers=2,
                      d_model=256, d_ff=512, vocab=256, n_heads=4, n_kv=2,
                      head_dim=64, mlp="geglu", max_seq=64)
    adam = AdamWConfig(lr=1e-2, warmup=2, total_steps=100)
    tn = TreeNewtonConfig(adam=adam, block=256, factor_every=1)
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 65)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    runs = []
    for tcfg in (TrainConfig(optimizer="adamw", adam=adam),
                 TrainConfig(optimizer="tree_newton", adam=adam,
                             tree_newton=tn)):
        base = T.init_params(cfg, seed=seed, device="cpu")
        out = {}
        for dev in ("cpu", "cuda"):
            params = tree_map(lambda _, p: p.to(dev, copy=True), base)
            state = {"params": params, "opt": init_opt(params, tcfg),
                     "step": 0}
            b = {k: v.to(dev) for k, v in batch.items()}
            state, m = make_train_step(cfg, tcfg)(state, b)
            out[dev] = (state, {k: float(v) for k, v in m.items()})
        (cs, cm), (gs, gm) = out["cpu"], out["cuda"]
        if abs(gm["loss"] - cm["loss"]) > 1e-5 * abs(cm["loss"]):
            raise AssertionError(f"train card vs CPU ({tcfg.optimizer}): "
                                 f"loss {gm['loss']} vs {cm['loss']}")
        adam_state = cs["opt"] if tcfg.optimizer == "adamw" else \
            cs["opt"]["adam"]
        err = _step_close(f"train card vs CPU ({tcfg.optimizer})",
                          gs["params"], cs["params"], adam_state["m"],
                          adam, cm["lr"])
        runs.append({"optimizer": tcfg.optimizer, "loss_card": gm["loss"],
                     "loss_cpu": cm["loss"], "param_max_abs_err": err,
                     "lr": cm["lr"]})
    families = [train_family_cpu_agreement(arch, seed + 20 + i)
                for i, arch in enumerate(AGREEMENT_FAMILIES)]
    return {"phase": "train_cpu_agreement", "config": "2 layers, d_model "
            "256, d_ff 512, f32; TreeNewton block 256, leaf 128, refactor "
            "every step; families: each smoke config at 2 layers, f32, "
            "one AdamW step", "runs": runs, "families": families,
            "tol": "where |g| > 100 eps: 2e-6 + 1e-3 lr; elsewhere the "
                   "step's own size (tests/test_torch_train.py)"}


def train_dp_phase(kind, smi):
    """The reference's mini data-parallel trainer
    (tests/test_train.py:122-153) with the int8 error-feedback
    all-reduce, as 4 ranks sharing the card over gloo
    (repro_torch.launch): it must converge within that test's bound,
    max|w - w_true| < 5e-2."""
    from repro_torch.launch import drive, launch
    t0 = time.perf_counter()
    res = launch(drive.run_cases, DIST_RANKS, ([{"kind": "train_dp"}],
                                               "cuda"),
                 device="cuda", timeout=600)[0][0]
    if not res["err"] < 5e-2:
        raise AssertionError(f"train_dp: max|w - w_true| = {res['err']}")
    return {"phase": "train_dp", "ranks": DIST_RANKS, "device": kind,
            "nvidia_smi": smi, "note": DIST_NOTE, **res,
            "bound": "max|w - w_true| < 5e-2 (tests/test_train.py:152)",
            "phase_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# the training driver, and a train step of every family
# ---------------------------------------------------------------------------
#: the driver's runs: gemma-2b full, AdamW, the train phase's batch shape
#: (the driver draws a new SyntheticLM batch each step), 5 steps; one save
#: at step 3: the card's machine takes 45 GiB of disk writes a call, and
#: the state is 28.2 GiB
DRIVER_ARCH = "gemma-2b"
DRIVER_ARGS = ("--steps", "5", "--batch", str(TRAIN_B), "--seq",
               str(TRAIN_S), "--lr", "5e-4")
DRIVER_SAVE_AT = 3
#: where the driver's checkpoints go (git-ignored, removed after the phase)
DRIVER_DIR = ROOT / "build" / "train_driver_ckpt"


def _dir_gib(path) -> float:
    return sum(f.stat().st_size for f in Path(path).iterdir()) / 2 ** 30


def _params_gap(a, b) -> float:
    """max |a - b| over every parameter (0.0: bitwise equal)."""
    from repro_torch.optim.adamw import leaves
    return max(float((x.float() - y.float()).abs().max())
               for (_, x), (_, y) in zip(leaves(a), leaves(b)))


def _restored_bitwise(path, step, layout):
    """``checkpoint.restore`` of ``step`` into the structure of
    ``layout`` (the tree save wrote, its tensors unchanged since): every
    leaf bitwise equal, in its dtype. Returns (leaves compared, restore
    seconds)."""
    from repro_torch import checkpoint as ckpt
    t0 = time.perf_counter()
    restored, got_step = ckpt.restore(str(path), layout, step=step)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if got_step != step:
        raise AssertionError(f"train_driver: restored step {got_step}")
    want = dict(ckpt.leaves(layout))
    n = 0
    for name, got in ckpt.leaves(restored):
        w = want[name]
        if isinstance(w, int):
            same = got == w
        elif isinstance(w, ckpt.Stacked):
            same = all(g.dtype == p.dtype and torch.equal(g, p)
                       for g, p in zip(got.parts, w.parts))
        else:
            same = got.dtype == w.dtype and torch.equal(got, w)
        if not same:
            raise AssertionError(f"train_driver: {name} restored from step "
                                 f"{step} differs from the state it saved")
        n += 1
    del restored
    return n, seconds


@contextlib.contextmanager
def _checked_saves(record):
    """While open, ``checkpoint.save`` (which the driver calls) saves as
    always, then waits for its writer and holds ``checkpoint.restore``
    of the step against the tree it saved, before the driver's loop goes
    on to change it: ``record`` gets the step, the save's blocking host
    seconds, the writer's seconds, the GiB on disk, the leaves compared
    and the restore's seconds."""
    from repro_torch import checkpoint as ckpt
    real = ckpt.save

    def checked(path, step, tree, **kw):
        t0 = time.perf_counter()
        h = real(path, step, tree, **kw)
        block = time.perf_counter() - t0
        h.wait()
        torch.cuda.empty_cache()
        n, restore_s = _restored_bitwise(path, step, tree)
        record.append({"step": step, "save_block_s": block,
                       "writer_s": h.seconds, "gib_on_disk":
                       _dir_gib(h.final), "restored_leaves": n,
                       "restore_s": restore_s,
                       "restored_equals_saved": True})
        return h
    ckpt.save = checked
    try:
        yield
    finally:
        ckpt.save = real


def train_driver_phase(kind, smi, arch=DRIVER_ARCH, args=DRIVER_ARGS,
                       save_at=DRIVER_SAVE_AT, root=DRIVER_DIR,
                       device="cuda"):
    """``repro_torch.launch.train.main`` on ``arch`` full, AdamW: run A
    saves at step ``save_at`` (the restore of that step held bitwise
    against the state it saved, before the next step changes it), run B
    runs uninterrupted, run C resumes A's checkpoint to the last step.
    Gates: every loss finite; the restored state equals the saved one
    bitwise; C's parameters differ from B's by no more than A's do (0
    means bitwise). Reports the driver's step ms (host clock, batch to
    loss, as its heartbeat) beside the train line's, the save's blocking
    host seconds, the writer's seconds, the checkpoint's GiB on disk, and
    the restore's seconds (C's ``restore_into`` and the check's
    ``restore``)."""
    from repro_torch.launch import train as driver
    t_phase = time.perf_counter()
    shutil.rmtree(root, ignore_errors=True)
    base = ["--arch", arch, "--device", device, *args]

    def run(label, *extra):
        if device == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        out = driver.main([*base, *extra])
        if not all(math.isfinite(x) for x in out["losses"]):
            raise AssertionError(f"train_driver {label}: losses "
                                 f"{out['losses']}")
        row = {"start": out["start"], "losses": out["losses"],
               "step_ms": [s * 1e3 for s in out["step_s"]],
               "restore_s": out["restore_s"]}
        if device == "cuda":
            row["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        return out, row
    saves = []
    try:
        with _checked_saves(saves):
            a, row_a = run("A", "--ckpt-every", str(save_at), "--ckpt-dir",
                           str(root / "a"))
        if [r["step"] for r in saves] != [save_at]:
            raise AssertionError(f"train_driver: A saved {saves}")
        params_a = a["state"]["params"]
        del a
        b, row_b = run("B", "--ckpt-every", "1000", "--ckpt-dir",
                       str(root / "b"))
        gap_runs = _params_gap(b["state"]["params"], params_a)
        del params_a
        params_b = b["state"]["params"]
        del b
        c, row_c = run("C", "--ckpt-every", "1000", "--ckpt-dir",
                       str(root / "a"), "--resume")
        if c["start"] != save_at:
            raise AssertionError(f"train_driver: C resumed at {c['start']}")
        gap_resume = _params_gap(c["state"]["params"], params_b)
        del c, params_b
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if not gap_resume <= gap_runs:
        raise AssertionError(f"train_driver: the resumed run is {gap_resume} "
                             f"from the uninterrupted one, two uninterrupted "
                             f"runs {gap_runs} apart")
    return {"phase": "train_driver", "arch": arch, "args": list(base),
            "device": kind, "nvidia_smi": smi,
            "runs": {"A_save": row_a, "B_uninterrupted": row_b,
                     "C_resume": row_c},
            "save": saves[0],
            "step_ms_median": statistics.median(row_a["step_ms"][1:]
                                                + row_b["step_ms"][1:]),
            "gap_resumed_vs_uninterrupted": gap_resume,
            "gap_uninterrupted_vs_uninterrupted": gap_runs,
            "gates": {"restored_equals_saved": "bitwise, every leaf",
                      "resume": "gap_resumed <= gap_uninterrupted"},
            "timing": "step_ms: host clock per driver step, the batch "
                      "fetched and moved to the card to the loss read "
                      "back (the first step warms up); save_block_s: "
                      "save's host copy before it returns; writer_s: the "
                      "writer thread's files (fsync not forced); "
                      "restore_s: the files read (warm in the page cache) "
                      "and copied to the card",
            "phase_s": time.perf_counter() - t_phase}


#: the non-dense families' train steps: (arch, overrides, B, S, lr, note).
#: lr 5e-4 as the train phase, but 1e-4 for the MoE: AdamW's first steps,
#: about lr a weight whatever the gradient, turn the random router's
#: logits by ~lr d |x|, its load-balance loss grows and the loss rises
#: for two steps (the phase's ``moe_at_train_lr`` run records it)
FAMILY_RUNS = (
    ("rwkv6-3b", {}, 2, 512, 5e-4, None),
    ("zamba2-2.7b", {}, 2, 1024, 5e-4, None),
    ("musicgen-large", {}, 2, 1024, 5e-4, None),
    ("deepseek-v2-lite-16b", {"n_layers": 6}, 2, 1024, 1e-4,
     "depth cut to 6 of 27 layers (1 dense + 5 MoE): the AdamW state of "
     "all 27 (15.7 B parameters at 2 + 2 + 8 bytes) is 176 GiB"),
    ("pixtral-12b", {"n_layers": 12}, 2, 1024, 5e-4,
     "depth cut to 12 of 40 layers: the AdamW state of all 40 (12.3 B "
     "parameters at 2 + 2 + 8 bytes) is 137 GiB"),
)
#: TreeNewton on the cut deepseek-v2-lite
FAMILY_TN = "deepseek-v2-lite-16b"


def _family_batch(cfg, B, S, seed, device="cuda"):
    """B random sequences of S + 1 tokens (audio: [B, S + 1, C]): tokens
    and next-token labels; vlm adds patch embeddings [B, n, d] f32."""
    g = torch.Generator(device=device).manual_seed(seed)
    shape = (B, S + 1) + ((cfg.n_codebooks,) if cfg.family == "audio"
                          else ())
    toks = torch.randint(0, cfg.vocab, shape, generator=g, device=device)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        out["patch_embeds"] = torch.randn(
            (B, cfg.n_img_tokens, cfg.d_model), generator=g, device=device)
    return out


def _family_run(arch, overrides, B, S, tcfg, steps, seed, note=None,
                falls=True):
    """``steps`` steps of ``tcfg`` on one batch of ``arch``'s config (with
    ``overrides``), random weights from ``seed`` on the card: losses
    finite and (with ``falls``) the last below the first, flash launches
    per step twice the prefill's (the forward and remat's recompute)."""
    from repro_torch import configs
    from repro_torch.optim.adamw import leaves
    from repro_torch.train import init_state, make_train_step
    cfg = configs.get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_state(cfg, tcfg, seed=seed, device="cuda")
    nonzero_leaves(cfg, state["params"], seed + 1)
    nparams = sum(p.numel() for _, p in leaves(state["params"]))
    batch = _family_batch(cfg, B, S, seed + 2)
    label = f"train_families {arch} {tcfg.optimizer}"
    state, rows = _train_steps(make_train_step(cfg, tcfg), state, batch,
                               steps, label)
    losses = [r["loss"] for r in rows]
    if falls and not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: the loss did not fall: {losses}")
    want_flash = 2 * flash_per_prefill(cfg)
    for r in rows:
        if r["flash_launches"] != want_flash:
            raise AssertionError(f"{label}: {r['flash_launches']} flash "
                                 f"launches a step, not {want_flash}")
    line = {"arch": arch, "family": cfg.family, "optimizer": tcfg.optimizer,
            "n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "dtype": cfg.param_dtype, "remat": cfg.remat, "batch": B,
            "seq": S, "params_b": nparams / 1e9, "steps": rows,
            "losses": losses,
            "step_ms_median": statistics.median(r["step_ms"] for r in rows),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "flash_launches_per_step": want_flash,
            "run_s": time.perf_counter() - t0}
    if note:
        line["note"] = note
    return line, state, cfg


def train_families_phase(kind, smi):
    """3 AdamW steps of each non-dense family at full width
    (``FAMILY_RUNS``: rwkv6-3b, zamba2-2.7b and musicgen-large at full
    depth; deepseek-v2-lite-16b and pixtral-12b cut in depth, each cut in
    its ``note``), then 2 TreeNewton steps on the cut deepseek-v2-lite (a
    refactor at step 2, a third step to see the loss fall): losses finite
    and falling, flash launches per step, the solver launches of each
    TreeNewton step equal to the grouped schedule, and no MoE expert stack
    (``moe/w_in``, ``moe/w_out``) among the whitened matrices; step ms,
    peak GiB and the losses of each."""
    from repro_torch.optim import kfac
    t_phase = time.perf_counter()
    runs = []
    for i, (arch, over, B, S, lr, note) in enumerate(FAMILY_RUNS):
        t_adam, _ = _train_configs(lr=lr)
        line, state, _ = _family_run(arch, over, B, S, t_adam, 3, 1000 + i,
                                     note)
        line["lr"] = lr
        runs.append(line)
        del state
    arch, over, B, S, lr, note = next(r for r in FAMILY_RUNS
                                      if r[0] == FAMILY_TN)
    # the MoE at the train phase's lr, recorded, not gated
    t_adam, _ = _train_configs()
    line, state, _ = _family_run(arch, over, B, S, t_adam, 3, 1000 + len(
        FAMILY_RUNS), note, falls=False)
    del state
    moe_at_train_lr = {"lr": t_adam.adam.lr, "losses": line["losses"],
                       "ce": [r["ce"] for r in line["steps"]],
                       "aux": [r["aux"] for r in line["steps"]]}
    _, t_tn = _train_configs(lr=lr)
    line, state, cfg = _family_run(arch, over, B, S, t_tn, 3, 1100, note)
    line["lr"] = lr
    tn = t_tn.tree_newton
    groups = kfac.whiten_groups(state["params"], tn)
    whitened = [p for ps in groups.values() for p in ps]
    experts = [p for p in whitened if p.endswith(("moe/w_in", "moe/w_out"))]
    if experts or not whitened:
        raise AssertionError(f"train_families: TreeNewton whitens "
                             f"{len(whitened)} matrices, expert stacks "
                             f"among them: {experts}")
    _check_schedule(f"train_families {arch} tree_newton", line["steps"], tn,
                    len(groups))
    line["whitened_paths"] = len(whitened)
    line["whitened_by_dout"] = {d: len(ps) for d, ps in groups.items()}
    line["expert_stacks_whitened"] = 0
    runs.append(line)
    del state
    torch.cuda.empty_cache()
    return {"phase": "train_families", "device": kind, "nvidia_smi": smi,
            "runs": runs, "moe_at_train_lr": moe_at_train_lr,
            "timing": "step_ms: CUDA events around one step "
            "(forward, backward, optimizer) on one batch",
            "phase_s": time.perf_counter() - t_phase}


#: one AdamW step of each family's smoke config at 2 layers, card vs CPU
AGREEMENT_FAMILIES = ("pixtral-12b", "musicgen-large",
                      "deepseek-v2-lite-16b", "rwkv6-3b", "zamba2-2.7b")


def train_family_cpu_agreement(arch, seed):
    """One AdamW step of ``arch``'s smoke config at 2 layers (f32; the
    deepseek smoke with ``_SMOKE_OVERRIDES``; the recurrent leaves drawn
    nonzero) on the card and on the CPU from the same weights and batch:
    the loss within 1e-5 relative, the parameters within _step_close's
    bounds."""
    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import tree_map
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train.step import init_opt
    cfg = configs.get_config(arch, smoke=True).replace(
        n_layers=2, **_SMOKE_OVERRIDES.get(arch, {}))
    adam = AdamWConfig(lr=1e-2, warmup=2, total_steps=100)
    tcfg = TrainConfig(optimizer="adamw", adam=adam)
    base = T.init_params(cfg, seed=seed, device="cpu")
    nonzero_leaves(cfg, base, seed + 1)
    batch = _family_batch(cfg, 2, 64, seed + 2, device="cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda _, p: p.to(dev, copy=True), base)
        state = {"params": params, "opt": init_opt(params, tcfg), "step": 0}
        state, m = make_train_step(cfg, tcfg)(
            state, {k: v.to(dev) for k, v in batch.items()})
        out[dev] = (state, {k: float(v) for k, v in m.items()})
    (cs, cm), (gs, gm) = out["cpu"], out["cuda"]
    if not abs(gm["loss"] - cm["loss"]) <= 1e-5 * abs(cm["loss"]):
        raise AssertionError(f"train card vs CPU ({arch}): loss "
                             f"{gm['loss']} vs {cm['loss']}")
    err = _step_close(f"train card vs CPU ({arch})", gs["params"],
                      cs["params"], cs["opt"]["m"], adam, cm["lr"])
    return {"arch": cfg.name, "family": cfg.family, "n_layers": 2,
            "loss_card": gm["loss"], "loss_cpu": cm["loss"],
            "param_max_abs_err": err, "lr": cm["lr"]}


# ---------------------------------------------------------------------------
# the tree recursion on stacks (TreeNewton's refactor, engine="tree")
# ---------------------------------------------------------------------------
TREE_STACK_KERNELS = ("potrf_leaf_batched", "tri_inv_leaf_batched",
                      "qgemm_batched", "trsm_leaf", "syrk_leaf")


def tree_stack_schedule(cfg, n, N) -> dict:
    """Launches, by entry of KERNELS, of tree_potrf on an (N, n, n)
    stack: a batched potrf_leaf a potrf leaf, a batched qgemm a node of
    the right solves and SYRKs, a batched tri_inv_leaf and N trsm_leaf a
    right-solve leaf, N syrk_leaf a SYRK leaf."""
    want = dict.fromkeys(KERNELS, 0)

    def walk(m, leaf):
        if m <= cfg.leaf:
            leaf()
            return
        want["qgemm_batched"] += 1
        m1 = cfg.split(m)
        walk(m1, leaf)
        walk(m - m1, leaf)

    def trsm_leaf():
        want["tri_inv_leaf_batched"] += 1
        want["trsm_leaf"] += N

    def syrk_leaf():
        want["syrk_leaf"] += N

    def potrf(m):
        if m <= cfg.leaf:
            want["potrf_leaf_batched"] += 1
            return
        m1 = cfg.split(m)
        potrf(m1)
        walk(m1, trsm_leaf)
        walk(m - m1, syrk_leaf)
        potrf(m - m1)

    potrf(n)
    return want


def tree_stacks_run(name, N, n, leaf, seed):
    """tree_potrf of a stack of N SPD blocks of order n at ``leaf`` on
    the card (the stack recursion: K-FAC's refactor with engine="tree"),
    timed once after a warm-up; its launches against
    :func:`tree_stack_schedule`; every block against its own 2-D factor
    on the card (how many are bitwise equal, and the largest difference
    relative to the block's largest entry, within TOL) and two blocks
    against the plain version (the same call on the CPU) within TOL."""
    from repro_torch.core import tree_potrf
    from repro_torch.core.precision import PAPER_CONFIGS
    cfg = dataclasses.replace(PAPER_CONFIGS[name], leaf=leaf, engine="tree")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = _kfac_stack(gen, N, n)
    tree_potrf(a[:2], cfg)
    before = launch_counts()
    l, ms = timed_once(lambda: tree_potrf(a, cfg))
    after = launch_counts()
    got = {k: after[k] - before[k] for k in KERNELS}
    want = tree_stack_schedule(cfg, n, N)
    if got != want:
        raise AssertionError(f"tree_stacks {name}: launches "
                             f"{ {k: v for k, v in got.items() if v} } != "
                             f"the schedule "
                             f"{ {k: v for k, v in want.items() if v} }")
    tol = TOL[cfg.levels[0]]
    one = torch.stack([tree_potrf(a[i], cfg) for i in range(N)])
    bitwise = sum(bool(torch.equal(l[i], one[i])) for i in range(N))
    err_2d = _blocks_err(f"tree_stacks {name} stack vs 2-D", l, one, tol)
    sample = [0, N - 1]
    plain = tree_potrf(a[sample].cpu(), cfg)
    err_plain = _blocks_err(f"tree_stacks {name} card vs plain",
                            l[sample].cpu(), plain, tol)
    _, ms_2d = timed_once(lambda: [tree_potrf(a[i], cfg) for i in range(N)])
    return {"phase": "tree_stacks", "ladder": name, "N": N, "n": n,
            "leaf": leaf, "ms": ms, "ms_2d_one_by_one": ms_2d,
            "launches": {k: v for k, v in got.items() if v},
            "schedule_ok": True, "bitwise_2d_blocks": bitwise,
            "rel_err_vs_2d": err_2d, "rel_err_vs_plain": err_plain,
            "plain_blocks": sample, "tol": tol}


# ---------------------------------------------------------------------------
# model serving under a (2, 2) data x model mesh of 4 ranks on the card
# ---------------------------------------------------------------------------
MESH_NOTE = ("4 gloo processes sharing one card as a (2, 2) data x model "
             "mesh, their collectives staged through host memory "
             "(launch/hostwire.py): the port's sharding, kernels and "
             "numerics on the card, not a node; every time is theirs")
#: f32 at 2 layers: the mesh's logits against the single-card port's
MESH_LOGIT_RTOL = 1e-4
#: (arch, seed, config overrides): the MoE gate runs dropless at EP = 2
#: (capacity factor 2: the capacity ceil(T K / 2) 2 >= T K), since with
#: expert parallelism the reference's capacity drops assignments that
#: one shard keeps (a decode step's 2 tokens a rank: 12 assignments, a
#: capacity of 7 a shard at 1.25)
MESH_GATE_RUNS = (("gemma-2b", 1002, None),
                  ("deepseek-v2-lite-16b", 1004,
                   {"moe_capacity_factor": 2.0}))
#: full width, bf16, layout tp: (arch, layers or None, B, S, new tokens)
MESH_FULL_RUNS = (("gemma-2b", None, 4, 1024, 8),
                  ("deepseek-v2-lite-16b", 4, 4, 1024, 4))
MESH_CUTS = {"deepseek-v2-lite-16b": "depth cut to 4 of 27 layers: its "
             "dense layer and 3 MoE layers, at full width"}


def generate_mesh_cases():
    """The generate_mesh phase's rank cases: the f32 gates, the MoE
    oracle, then the full-width bf16 runs."""
    from repro_torch import configs
    cases = [{"kind": "mesh_serve", "arch": arch, "smoke": False,
              "n_layers": 2, "dtype": "f32", "over": over, "B": 4,
              "S": 256, "n_tokens": 4, "seed": seed, "one_rank": True}
             for arch, seed, over in MESH_GATE_RUNS]
    moe_cfg = configs.get_config("deepseek-v2-lite-16b").replace(
        param_dtype="f32", activ_dtype="f32")
    cases.append({"kind": "moe_ep", "cfg": dataclasses.asdict(moe_cfg),
                  "seed": 1006, "x_shape": (4, 128, moe_cfg.d_model)})
    cases += [{"kind": "mesh_serve", "arch": arch, "smoke": False,
               "n_layers": layers, "B": B, "S": S, "n_tokens": n,
               "seed": 1010 + i, "one_rank": False, "generate": False}
              for i, (arch, layers, B, S, n) in enumerate(MESH_FULL_RUNS)]
    return cases, moe_cfg


def _mesh_rank_lines(res):
    """Per rank: prefill ms, decode ms a step, peak GiB, bytes by
    collective."""
    return [{"prefill_ms": r["prefill_s"] * 1e3,
             "decode_ms_per_step": [t * 1e3 for t in r["decode_s"]],
             "peak_gib": r.get("peak_gib"),
             "flash_launches_prefill": r["flash_launches_prefill"],
             "wire_prefill_bytes": r["wire_prefill"],
             "wire_decode_bytes": r["wire_decode"]} for r in res["ranks"]]


def generate_mesh_phase(kind, smi):
    """The mesh serving cases on DIST_RANKS ranks sharing the card; every
    gate checked here. Returns the lines and the launches summed over the
    ranks and cases, by entry of KERNELS."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import drive, launch
    from repro_torch.models import moe
    torch.cuda.empty_cache()
    cases, moe_cfg = generate_mesh_cases()
    t0 = time.perf_counter()
    results = launch(drive.run_mesh_cases, DIST_RANKS, (cases, "cuda"),
                     device="cuda", timeout=900)[0]
    wall = time.perf_counter() - t0
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    batched = dict.fromkeys(ops.BATCHED, 0)
    routes = dict.fromkeys(ops.FLASH_ROUTES, 0)
    lines = []
    base = {"phase": "generate_mesh", "ranks": DIST_RANKS, "mesh": [2, 2],
            "layout": "tp", "device": kind, "nvidia_smi": smi,
            "note": MESH_NOTE}
    for case, res in zip(cases, results):
        line = dict(base)
        if case["kind"] == "moe_ep":
            g = torch.Generator(device="cuda").manual_seed(case["seed"])
            p = moe.moe_params(moe_cfg, generator=g, device="cuda")
            x = torch.randn(case["x_shape"], generator=g, device="cuda")
            tol = _moe_tol(x, p, moe_cfg, 2.0 ** -24)
            dense = torch.as_tensor(res["dense"])
            want = moe.moe_ffn_dense_reference(x, p, moe_cfg).cpu()
            check_close("generate_mesh moe: the rank's dense oracle",
                        dense, want, 0, tol)
            first, capped = res["cases"]
            err = check_close("generate_mesh moe: expert-parallel routed",
                              torch.as_tensor(first["routed"]), want, 0, tol)
            if not capped["finite"]:
                raise AssertionError("generate_mesh moe: non-finite output "
                                     "at capacity_factor 1.0")
            line.update({"case": "moe_ep", "arch": moe_cfg.name,
                         "dtype": "f32", "ep": 2,
                         "tokens": int(x.shape[0] * x.shape[1]),
                         "max_abs_err_vs_dense": err, "tol": tol,
                         "tol_is": _MOE_TOL, "aux": first["aux"],
                         "capacity_1_finite": True})
            lines.append(line)
            continue
        cfg = configs.get_config(case["arch"]).replace(
            n_layers=case["n_layers"] or configs.get_config(
                case["arch"]).n_layers)
        per = flash_per_prefill(cfg)
        for rank, r in enumerate(res["ranks"]):
            if r["flash_launches_prefill"] != per:
                raise AssertionError(
                    f"generate_mesh {case['arch']} rank {rank}: "
                    f"{r['flash_launches_prefill']} flash launches in the "
                    f"prefill, {per} attention layers")
            c = r["counters"]
            for k, v in c["launches"].items():
                launches[k] += v
            for k, v in c["batched"].items():
                batched[k] += v
            for k, v in r["flash_routes"].items():
                routes[k] += v
        line.update({"case": "mesh_serve", "arch": case["arch"],
                     "n_layers": cfg.n_layers,
                     "dtype": case.get("dtype") or cfg.param_dtype,
                     "batch": case["B"], "prompt": case["S"],
                     "new_tokens": case["n_tokens"],
                     "param_shards_checked": res["param_shards"],
                     "cache_shards_checked": res["cache_shards"],
                     "per_rank": _mesh_rank_lines(res)})
        if case["arch"] in MESH_CUTS and case["n_layers"]:
            line["cut"] = MESH_CUTS[case["arch"]]
        if case.get("one_rank"):
            one = res["one_rank"]
            errs = {}
            for key in ("prefill_logits", "decode_logits"):
                want = one[key]
                scale = max(1.0, float(abs(want).max()))
                errs[key] = float(abs(res[key] - want).max())
                if not errs[key] <= MESH_LOGIT_RTOL * scale:
                    raise AssertionError(
                        f"generate_mesh {case['arch']} f32: {key} "
                        f"{errs[key]} from the single-card port's, over "
                        f"{MESH_LOGIT_RTOL} x {scale}")
            agree = {"teacher_forced": res["teacher_forced"],
                     "generate": bool((res["generated"]
                                       == one["generated"]).all()),
                     "serve_steps": bool((res["greedy"]
                                          == one["generated"]).all())}
            if not all(agree.values()):
                raise AssertionError(
                    f"generate_mesh {case['arch']} f32: the mesh's tokens "
                    f"differ from the single-card port's greedy ones "
                    f"({agree}): mesh {res['greedy'].tolist()}, "
                    f"{res['generated'].tolist()}, single card "
                    f"{one['generated'].tolist()}")
            line.update({"gate": "f32 vs the single-card port",
                         "overrides": case["over"],
                         "max_abs_diff": errs,
                         "tol": f"{MESH_LOGIT_RTOL} x max(1, max|logits|)",
                         "generate_equals_single_card": True,
                         "teacher_forced_greedy": True})
        lines.append(line)
    lines.append({"phase": "generate_mesh_launches", "wall_s": wall,
                  "summed_over_ranks": launches,
                  "flash_routes_summed_over_ranks": routes})
    if launches["flash_attention"] == 0:
        raise AssertionError("flash_attention was not launched on the "
                             "generate_mesh path")
    return lines, split_launches(launches, batched, routes)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    rates = card_rates(kind)
    _build.build_all()
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": kind,
          "build_s": _build.BUILD_SECONDS, "rates": rates})

    emit(factor_probe("before_kernel_phases", N_MAIN, 850))
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for name, fn in (("potrf_leaf", lambda: kernel_potrf(rates, gen)),
                     ("tri_inv_leaf", lambda: kernel_tri_inv(rates, gen)),
                     ("qgemm", lambda: kernel_qgemm(rates, gen, N_MAIN)),
                     ("panel_update", lambda: kernel_panel(rates, gen,
                                                           N_MAIN)),
                     ("residual_fused", lambda: kernel_residual(rates, gen,
                                                                N_MAIN)),
                     ("trsm_leaf", lambda: kernel_trsm(rates, gen, N_MAIN)),
                     ("syrk_leaf", lambda: kernel_syrk_leaf(rates, gen)),
                     ("syrk_packed", lambda: kernel_syrk_packed(rates, gen,
                                                                N_MAIN)),
                     ("flash_attention", lambda: kernel_flash(rates, gen)),
                     ("kfac_batched", lambda: kernel_kfac_batched(rates,
                                                                  gen))):
        t0 = time.perf_counter()
        checks, timing = fn()
        torch.cuda.synchronize()
        results[name] = timing
        emit({"phase": "kernel", "name": name, **timing,
              "checks": checks, "phase_s": time.perf_counter() - t0})
    results["flash_attention_f32"] = results["flash_attention"]["f32"]
    results.update(results.pop("kfac_batched")["entries"])
    emit(factor_probe("after_kernel_phases", N_MAIN, 850))

    # each driven path runs with fresh counts and must launch its kernels;
    # the kernels line sums the paths' counts
    launches = {k: 0 for k in KERNELS}
    lines = []                  # every line the driven paths emitted

    def drive(label, kernels, runs):
        ops.reset_launches()
        for run in runs:
            out = run()         # a line, or a list of lines
            for line in (out if isinstance(out, list) else [out]):
                lines.append(line)
                emit(line)
        got = launch_counts()
        for k in kernels:
            if got[k] == 0:
                raise AssertionError(f"{k} was not launched on the {label} "
                                     "path")
        for k in launches:
            launches[k] += got[k]
        emit({"phase": f"{label}_launches", **got})
        emit({"phase": f"{label}_routes", **route_counts()})

    # warm-up of the whole path, then the main path
    path_run("pure_f32", 2048, 11)
    tree_path_run("pure_f32", 2048, 12)
    ladders = ("pure_f32", "bf16_f32", "f16x3_f32", "int8_f32")
    drive("path", PATH_KERNELS,
          [lambda i=i, name=name: path_run(name, N_MAIN, 100 + i)
           for i, name in enumerate(ladders)])
    drive("tree_path", TREE_KERNELS,
          [lambda i=i, name=name: tree_path_run(name, N_MAIN, 800 + i)
           for i, name in enumerate(ladders)]
          + [lambda: tree_path_run("f32x3_f64", 4096, 810),
             lambda: tree_packed_run("f16x3_f32", N_MAIN, 811),
             lambda: tree_packed_run("int8_f32", N_MAIN, 812)])
    drive("tree_stacks", TREE_STACK_KERNELS,
          [lambda: tree_stacks_run("pure_f32", 64, 512, 128, 830),
           lambda: tree_stacks_run("bf16_f32", 64, 512, 128, 831)])
    drive("syrk_race", ("syrk_packed", "syrk_leaf", "qgemm"),
          [lambda: syrk_race(N_MAIN, 820)])
    drive("refine", REFINE_KERNELS,
          [lambda i=i, name=name: refine_run(name, N_MAIN, 600 + i)
           for i, name in enumerate(ladders)]
          + [lambda: refine_run("bf16_f32", N_MAIN, 610, method="gmres"),
             lambda: refine_run("bf16_f32", N_MAIN, 611,
                                residual_dtype="f32"),
             lambda: refine_run("bf16_f32", N_MAIN, 612, engine="tree")])
    drive("serve", SERVE_KERNELS, [lambda: serve_phase(N_MAIN, 700)])
    drive("tune", TUNE_KERNELS,
          [tune_db_line, tune_smoke_search, lambda: tune_auto_solves(720),
           lambda: tune_serving(N_MAIN, 740), tune_fresh_race])
    emit(census_phase(lines, rates, kind))
    drive("audit", AUDIT_KERNELS, [lambda: audit_phase(kind, smi)])
    dist_lines, dist_launches = dist_phase(kind, smi)
    for line in dist_lines:
        emit(line)
    for k in launches:
        launches[k] += dist_launches.get(k, 0)
    mesh_lines, mesh_launches = generate_mesh_phase(kind, smi)
    for line in mesh_lines:
        emit(line)
    for k in launches:
        launches[k] += mesh_launches.get(k, 0)

    # model serving: gemma-2b at full width and depth, bf16
    cfg, params, gib = _model("gemma-2b", 900)
    drive("generate", ("flash_attention",),
          [lambda: generate_run("generate", cfg, params, gib, 4, 2048, 32,
                                901, profile=True),
           lambda: generate_run("generate", cfg, params, gib, 1, cfg.max_seq,
                                8, 902),
           lambda: decode_contract("generate", cfg, params, 4, 1024, 903)])
    del params
    torch.cuda.empty_cache()
    cfg, params, gib = _model("nemotron-4-15b", 910, n_layers=2)
    cut = ("depth cut to 2 of 32 layers: the GQA path (KV = 8, G = 6, "
           "hd = 128) and the relu2 MLP at full width")
    drive("generate_gqa", ("flash_attention",),
          [lambda: generate_run("generate_gqa", cfg, params, gib, 1, 4096, 8,
                                911, note=cut),
           lambda: decode_contract("generate_gqa", cfg, params, 1, 1024,
                                   912)])
    del params
    torch.cuda.empty_cache()

    elapsed = time.perf_counter() - t_start
    if elapsed < 500:
        emit(path_run("bf16_f32", 32768, 200))
    else:
        emit({"phase": "path", "ladder": "bf16_f32", "n": 32768,
              "skipped": f"{elapsed:.0f} s spent before it"})

    # the vlm, audio and moe families, bf16, random weights (after the
    # n = 32768 path, whose time guard they would otherwise eat into)
    cfg, params, gib = _model("deepseek-v2-lite-16b", 940)
    drive("generate_moe", ("flash_attention",),
          [lambda: generate_run("generate_moe", cfg, params, gib, 4, 2048,
                                32, 941, profile=True),
           lambda: decode_contract("generate_moe", cfg, params, 4, 1024,
                                   942),
           lambda: moe_oracle(cfg, params, ((torch.float32, 512),
                                            (torch.bfloat16, 512),
                                            (torch.bfloat16, 4)), 943)])
    del params
    torch.cuda.empty_cache()
    cfg, params, gib = _model("deepseek-v3-671b", 945, n_layers=4)
    cut = ("depth cut to 4 of 61 layers (its 3 dense + 1 MoE; the whole "
           "model is ~1.2 TiB in bf16, no fit on one card): MLA with "
           "q_lora 1536 and H = 128, 256 routed experts top-8 + 1 shared "
           "at full width")
    drive("generate_moe_v3", ("flash_attention",),
          [lambda: generate_run("generate_moe_v3", cfg, params, gib, 1,
                                4096, 8, 946, note=cut, profile=True),
           lambda: decode_contract("generate_moe_v3", cfg, params, 1, 1024,
                                   947)])
    del params
    torch.cuda.empty_cache()
    cfg, params, gib = _model("pixtral-12b", 950)
    drive("generate_vlm", ("flash_attention",),
          [lambda: generate_run("generate_vlm", cfg, params, gib, 2, 4096,
                                16, 951, profile=True),
           lambda: decode_contract("generate_vlm", cfg, params, 2, 1024,
                                   952)])
    del params
    torch.cuda.empty_cache()
    cfg, params, gib = _model("musicgen-large", 955)
    drive("generate_audio", ("flash_attention",),
          [lambda: generate_run("generate_audio", cfg, params, gib, 4, 2048,
                                32, 956, profile=True),
           lambda: decode_contract("generate_audio", cfg, params, 4, 1024,
                                   957)])
    del params
    torch.cuda.empty_cache()

    # the recurrent families, uncut, bf16, random weights (the leaves
    # that init sets to zero or one drawn nonzero)
    cfg, params, gib = _model("rwkv6-3b", 975)
    note = ("rwkv6's path runs no kernel of the repo: the reference's "
            "recurrence is a lax.scan, not Pallas, and runs here in plain "
            "torch, one step a position and layer")
    drive("generate_rwkv", (),
          [lambda: generate_run("generate_rwkv", cfg, params, gib, 4, 1024,
                                32, 976, note=note, profile=True),
           lambda: decode_contract("generate_rwkv", cfg, params, 4, 1024,
                                   977)])
    del params
    torch.cuda.empty_cache()
    cfg, params, gib = _model("zamba2-2.7b", 980)
    drive("generate_hybrid", ("flash_attention",),
          [lambda: generate_run("generate_hybrid", cfg, params, gib, 4, 2048,
                                32, 981, profile=True),
           lambda: decode_contract_steps("generate_hybrid", cfg, params, 4,
                                         896, 128, 982)])
    del params
    torch.cuda.empty_cache()

    # f32 at 2 layers: generate == teacher-forced greedy for each family
    # (deepseek-v2-lite: its dense layer and one MoE layer; zamba2: two
    # mamba blocks and one application of the shared block)
    def exact_runs(arch, seed):
        cfg, params, _ = _model(arch, seed, n_layers=2, param_dtype="f32",
                                activ_dtype="f32")
        if cfg.family == "hybrid":
            # the SSD takes at most 128 positions or a multiple of 128:
            # the teacher-forced prefills stay in one chunk, and the
            # contract is 128 + 128
            out = [token_exact("token_exact_f32", cfg, params, 2, 120, 8,
                               seed + 1),
                   decode_contract_steps("token_exact_f32", cfg, params, 2,
                                         128, 128, seed + 2)]
        else:
            # a vlm prompt no longer than n_img_tokens is all patches, and
            # so is its prefix's prefill, which the stub fills to
            # n_img_tokens positions: the contract needs text after them
            S = 2 * cfg.n_img_tokens if cfg.family == "vlm" else 256
            out = [token_exact("token_exact_f32", cfg, params, 2, S, 8,
                               seed + 1),
                   decode_contract("token_exact_f32", cfg, params, 2, S,
                                   seed + 2)]
        del params
        torch.cuda.empty_cache()
        return out
    drive("token_exact_f32", ("flash_attention_f32",),
          [lambda arch=arch, seed=seed: exact_runs(arch, seed)
           for arch, seed in (("gemma-2b", 920), ("pixtral-12b", 960),
                              ("musicgen-large", 964),
                              ("deepseek-v2-lite-16b", 968),
                              ("rwkv6-3b", 972), ("zamba2-2.7b", 984))])
    emit({"phase": "model_cpu_agreement",
          "runs": [model_cpu_agreement(arch, 930 + i) for i, arch in
                   enumerate(("gemma-2b", "granite-34b", "nemotron-4-15b",
                              "pixtral-12b", "musicgen-large",
                              "deepseek-v2-lite-16b",
                              "deepseek-v3-671b", "rwkv6-3b",
                              "zamba2-2.7b"))]})
    emit(path_run("f32x3_f64", 4096, 300))
    line = breakdown("f16x3_f32", N_MAIN, 500)
    # the kernel phase's trsm_leaf times at the tree's M, 32 calls each,
    # beside the tree factor's profiled trsm_leaf device time
    line["trsm_leaf_32_calls_each_m"] = {
        "sum_ms": results["trsm_leaf"]["sum32_ms"],
        "sum_graph_ms": results["trsm_leaf"]["sum32_graph_ms"],
        "tree_factor_device_ms": line["tree_factor"][
            "device_ms_by_kernel"].get("trsm_leaf")}
    emit(line)
    emit(tree_qgemm_shapes("f16x3_f32", N_MAIN, 510))
    emit(tree_qgemm_shapes("int8_f32", N_MAIN, 511))
    agree = [cpu_agreement(name, 2048, 400 + i, engine)
             for engine in ("blocked", "tree")
             for i, name in enumerate(ladders + ("f32x3_f64",))]
    emit({"phase": "cpu_agreement", "runs": agree})

    # training: gemma-2b at full width and depth, AdamW then TreeNewton
    train_line = {}

    def run_train():
        t0 = time.perf_counter()
        train_line.update(train_phase(kind, smi))
        train_line["phase_s"] = time.perf_counter() - t0
        return train_line
    drive("train", TRAIN_KERNELS,
          [run_train, lambda: train_depth_check(train_line),
           train_cpu_agreement])
    emit(train_dp_phase(kind, smi))
    # the training driver (gemma-2b full: save, restore, resume), then a
    # train step of every other family at full width
    drive("train_driver", ("flash_attention",),
          [lambda: train_driver_phase(kind, smi)])
    drive("train_families", TRAIN_KERNELS,
          [lambda: train_families_phase(kind, smi)])

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": launches[name],
         "max_abs_err": results[name]["max_abs_err"],
         "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"],
         "bound_ms": results[name]["bound_ms"],
         "bound_by": results[name]["bound_by"],
         "library_ms": results[name]["library_ms"]}
        for name in KERNELS]})
    if any(m == "jax" or m.startswith(("jax.", "repro."))
           or m == "repro" for m in sys.modules):
        raise AssertionError("jax or the JAX package was imported")
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
