#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check every kernel.

    python3 chip_smoke.py            # one card; no arguments

Run from the root of a checkout. The kernels are built from
``src/repro_torch/kernels/csrc`` at first use. Every phase prints one JSON
line; a failing check raises, and the script exits non-zero with no
result line. Phases:

1. ``env``: the card (``nvidia-smi``), torch and CUDA versions, build time.
2. ``kernel``: each of the five kernels against its plain PyTorch version
   on the card, for every operand type and rounding variant, at the
   shapes of tests/test_kernels.py and at the main path's shapes
   (leaf b = 256, the first diagonal tile of the n = 16384 matrix, panel
   heights m = 256 .. n - 256, the residual at n = 16384 with 16
   columns); times of the kernel, the plain version and the one PyTorch
   call computing the same function (where there is one), beside the
   card's least time for that work. ``residual_fused`` is also checked
   for column independence, bitwise.
3. ``path``: the port's main path, ``cholesky_solve`` with 16 right-hand
   sides and with one vector, at n = 16384 on the paper's §IV-A matrix,
   for the ladders pure_f32, bf16_f32, f16x3_f32 and int8_f32; factor
   and solve times, peak memory, the residual ||b - A x|| / ||b|| in f64
   and each kernel's launch count, which must match the schedule. Then
   bf16_f32 at n = 32768 and f32x3_f64 at n = 4096.
4. ``refine``: ``refine_solve`` with 16 right-hand sides at n = 16384,
   at most 10 sweeps: classic IR with f64 residuals to 1e-10 for the four
   ladders (every column must converge, >= 10 digits in f64), GMRES-IR
   once and IR with the default f32 residual once (bf16_f32; never worse
   than the unrefined solve); sweeps, digits before and after, wall and
   sweep ms, and launch counts checked against the sweep schedule.
5. ``serve``: ``SolverEngine("bf16_f32", residual_dtype="f64")`` at
   n = 16384 answers 48 single-column requests (targets 6, 8, 10, 12
   digits) through a continuous ``BatchScheduler`` (16 slots) and through
   a windowed drain; requests/s of each with the factor excluded, sweeps,
   convergence, cache hits, the card's busy share, and the two modes
   compared request for request.
6. ``breakdown``: device time by kernel inside one factor and one
   16-column solve of f16x3_f32 at n = 16384 (torch.profiler), and the
   card's busy share of the wall time.
7. ``cpu_agreement``: each ladder's factor on the card against the same
   port run on the CPU at n = 2048.

Then the ``{"kernels": [...]}`` line, the card's name and power limit as
nvidia-smi prints them, and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

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
}
#: the kernels each driven path must launch
PATH_KERNELS = ("potrf_leaf", "tri_inv_leaf", "qgemm", "panel_update")
#: factor-agreement tolerance by the ladder's coarsest level
#: (tests/test_blocked.py:_TOL)
TOL = {"f16": 5e-3, "bf16": 4e-2, "int8": 4e-2, "f32": 5e-6, "f64": 1e-12}
#: digits floor of ||b - Ax|| / ||b|| per ladder without refinement: the
#: digits this script measured on an H100 SXM (identical in every run:
#: pure_f32 6.01, bf16_f32 5.31 at n = 16384 and 5.41 at 32768, f16x3_f32
#: 5.57, int8_f32 4.85, f32x3_f64 9.50 at n = 4096) less 0.3 digits
DIGITS_FLOOR = {"pure_f32": 5.7, "bf16_f32": 5.0, "f16x3_f32": 5.3,
                "int8_f32": 4.5, "f32x3_f64": 9.2}
#: main-path size: the order of A and the n of the main-path kernel shapes
N_MAIN = 16384
#: one unit of a level's grid, relative to the tile's scale
GRID = {"int8": 1 / 127, "f16": 2.0 ** -10, "bf16": 2.0 ** -7, "f32": 1e-5,
        "f64": 1e-12}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_rates(name: str) -> dict:
    """Data-sheet peaks of the card (dense, CUDA cores for f32/f64)."""
    if "PCIe" in name:
        return {"f32": 51e12, "f64": 25.5e12, "bytes": 2.0e12}
    return {"f32": 67e12, "f64": 33.5e12, "bytes": 3.35e12}


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
    entries, +n on the diagonal; built on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    m = torch.rand((n, n), generator=g, device="cuda", dtype=dtype)
    m.mul_(2).sub_(1)
    a = m.add_(m.T.clone()).mul_(0.5)
    a.diagonal().add_(n)
    return a


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


def kernel_potrf(rates, gen):
    from repro_torch.kernels import potrf, ref
    checks = []
    for n in (128, 256, 384, 512):
        a = spd_tile(n, gen)
        want = ref.potrf_ref(a)
        err, atol = check_scaled(f"potrf n={n}", potrf.potrf_leaf(a), want,
                                 3e-4, 1e-6)
        checks.append({"n": n, "dtype": "f32", "max_abs_err": err,
                       "tol": f"rtol 3e-4 atol 1e-6 max|L| = {atol:g}"})
    a64 = spd_tile(256, gen, torch.float64)
    err, atol = check_scaled("potrf f64", potrf.potrf_leaf(a64),
                             ref.potrf_ref(a64), 1e-10, 1e-12)
    checks.append({"n": 256, "dtype": "f64", "max_abs_err": err,
                   "tol": f"rtol 1e-10 atol 1e-12 max|L| = {atol:g}"})
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
    bound, by = bound_ms(b ** 3 / 3, 2 * 4 * b * b, "f32", rates)
    return checks, {
        "max_abs_err": err, "tol": f"rtol 3e-4 atol 1e-6 max|L| = {atol:g}",
        "ms": cuda_ms(lambda: potrf.potrf_leaf(tile)),
        "plain_ms": cuda_ms(lambda: ref.potrf_ref(tile)),
        "library_ms": cuda_ms(lambda: torch.linalg.cholesky(tile)),
        "bound_ms": bound, "bound_by": by, "shape": [b, b]}


def kernel_tri_inv(rates, gen):
    from repro_torch.kernels import potrf, ref
    checks = []
    for n in (128, 256, 512):
        r = torch.randn((n, n), generator=gen, device="cuda")
        l = r.tril() + math.sqrt(n) * 4 * torch.eye(n, device="cuda")
        err, atol = check_scaled(f"tri_inv n={n}", potrf.tri_inv_leaf(l),
                                 ref.tri_inv_ref(l), 1e-4, 1e-6)
        checks.append({"n": n, "dtype": "f32", "max_abs_err": err,
                       "tol": f"rtol 1e-4 atol 1e-6 max|X| = {atol:g}"})
    l64 = potrf.potrf_leaf(spd_tile(256, gen, torch.float64))
    err, atol = check_scaled("tri_inv f64", potrf.tri_inv_leaf(l64),
                             ref.tri_inv_ref(l64), 1e-10, 1e-12)
    checks.append({"n": 256, "dtype": "f64", "max_abs_err": err,
                   "tol": f"rtol 1e-10 atol 1e-12 max|X| = {atol:g}"})
    # main path: the inverse of the first diagonal tile's factor; its
    # diagonal is about 1/128 and its off-diagonal about 5e-7
    b = 256
    l = potrf.potrf_leaf(main_tile(b, N_MAIN, 2))
    err, atol = check_scaled("tri_inv main", potrf.tri_inv_leaf(l),
                             ref.tri_inv_ref(l), 1e-4, 1e-6)
    eye = torch.eye(b, device="cuda")
    bound, by = bound_ms(b ** 3 / 3, 2 * 4 * b * b, "f32", rates)
    return checks, {
        "max_abs_err": err, "tol": f"rtol 1e-4 atol 1e-6 max|X| = {atol:g}",
        "ms": cuda_ms(lambda: potrf.tri_inv_leaf(l)),
        "plain_ms": cuda_ms(lambda: ref.tri_inv_ref(l)),
        "library_ms": cuda_ms(
            lambda: torch.linalg.solve_triangular(l, eye, upper=False)),
        "bound_ms": bound, "bound_by": by, "shape": [b, b]}


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
    out = torch.empty_like(c)
    bound, by = bound_ms(2.0 * m * b * k, 4 * (m * b + b * k + 2 * m * k),
                         "f32", rates)
    return checks, {
        "max_abs_err": err, "tol": "rtol 2e-4 atol 1e-4",
        "ms": cuda_ms(lambda: qgemm.qgemm(lblk, xp, -1.0, c=c, beta=1.0,
                                          out=out)),
        "plain_ms": cuda_ms(lambda: ref.qgemm_ref(lblk, xp, scale=-1.0, c=c,
                                                  beta=1.0)),
        "library_ms": cuda_ms(lambda: torch.addmm(c, lblk, xp, beta=1.0,
                                                  alpha=-1.0, out=out)),
        "bound_ms": bound, "bound_by": by, "shape": [m, b, k]}


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


def kernel_panel(rates, gen, n):
    from repro_torch.core.plan import build_plan
    from repro_torch.core.precision import PAPER_CONFIGS, PrecisionConfig
    from repro_torch.kernels import panel, ref
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
    # time the paper's ladder at the first panel of the main path
    cfg = PAPER_CONFIGS["f16x3_f32"]
    b, m = cfg.leaf, n - cfg.leaf
    meta = build_plan(n, cfg).panel_meta(0)
    kw = dict(store_names=meta.store_names, store_quants=meta.store_quants,
              pair_names=meta.pair_names, pair_quants=meta.pair_quants)
    linv, a21, c = _panel_inputs(gen, m, b, damp=1 / 32)
    err = max(ch["max_abs_err"] for ch in checks
              if ch["case"] == "main f16-quant" and ch["m"] == heights[-1])
    nt = m // b
    ntri = nt * (nt + 1) // 2
    flops = 2.0 * m * b * b + 2.0 * b ** 3 * ntri
    nbytes = 4 * (b * b + 2 * m * b + 2 * ntri * b * b)
    bound, by = bound_ms(flops, nbytes, "f32", rates)
    return checks, {
        "max_abs_err": err, "tol": f"{GRID['f16']:g} x max|ref|",
        "ms": cuda_ms(lambda: panel.panel_update(linv, a21, c, **kw),
                      reps=3, warmup=1),
        "plain_ms": cuda_ms(lambda: ref.panel_update_ref(linv, a21, c, **kw),
                            reps=3, warmup=1),
        "library_ms": None,
        "bound_ms": bound, "bound_by": by, "shape": [m, b],
        "ladder": "f16x3_f32", "panel": 0}


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
    # main path: n = 16384 with the 16-column slot block, f64 residuals
    # (the serve and refine phases) and the f32 default
    k = 16
    timing = {}
    for tn in ("f64", "f32"):
        dt = dtypes[tn]
        a = torch.randn((n, n), generator=gen, device="cuda", dtype=dt) / 128
        x = torch.randn((n, k), generator=gen, device="cuda", dtype=dt)
        b = torch.randn((n, k), generator=gen, device="cuda", dtype=dt)
        out = torch.empty_like(b)
        rtol, atol = tols[tn](n)
        err = check_close(f"residual main {tn}",
                          residual.residual_fused(a, x, b),
                          ref.residual_ref(a, x, b), rtol, atol)
        esz = a.element_size()
        bound, by = bound_ms(2.0 * n * n * k, esz * (n * n + 3 * n * k), tn,
                             rates)
        timing[tn] = {
            "max_abs_err": err, "tol": f"rtol {rtol:g} atol {atol:g}",
            "ms": cuda_ms(lambda: residual.residual_fused(a, x, b, out=out)),
            "plain_ms": cuda_ms(lambda: ref.residual_ref(a, x, b), reps=5),
            "library_ms": cuda_ms(lambda: torch.addmm(b, a, x, beta=1.0,
                                                      alpha=-1.0, out=out)),
            "bound_ms": bound, "bound_by": by, "shape": [n, n, k],
            "dtype": tn}
        del a
    torch.cuda.empty_cache()
    return checks, {**timing["f64"], "f32": timing["f32"]}


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
    schedule = {"potrf_leaf": T, "tri_inv_leaf": 2 * T - 1,
                "panel_update": T - 1, "qgemm": 2 * (2 * T - 1),
                "residual_fused": 0}
    line = {"phase": "path", "ladder": name, "n": n, "leaf": cfg.leaf,
            "dtype": str(high).replace("torch.", "")}
    counts = {}
    for label, rhs in (("k16", b16), ("k1", b1)):
        before = dict(ops.LAUNCHES)
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
        if not bool(torch.isfinite(x).all()) or x.shape != rhs.shape:
            raise AssertionError(f"{name} n={n} {label}: bad result")
        res = residual(a, x, rhs)
        line[f"cholesky_solve_{label}_wall_s"] = wall
        line[f"residual_{label}"] = res
        line[f"digits_{label}"] = -math.log10(max(res, 1e-300))
        line[f"peak_mem_gib_{label}"] = (torch.cuda.max_memory_allocated()
                                         / 2 ** 30)
    line["launches_per_cholesky_solve"] = counts["k16"]
    line["schedule"] = schedule
    # factor and solves timed apart by CUDA events (after the warm-up
    # above); these launches count too
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    lp = rt.cholesky_padded(a, cfg)
    stop.record()
    torch.cuda.synchronize()
    line["factor_ms"] = start.elapsed_time(stop)
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
# phase 4: refinement
# ---------------------------------------------------------------------------
def refine_run(name, n, seed, *, method="ir", residual_dtype="f64"):
    """refine_solve with 16 right-hand sides against a cached factor and
    its diagonal inverses, at most 10 sweeps to 1e-10; the launches of
    the call are checked against the sweep schedule: per loop iteration
    one residual and one correction solve (254 qgemm at T = 64), GMRES-IR
    adding gmres_restart solves per restart."""
    import repro_torch as rt
    from repro_torch.core import scaled_solve
    from repro_torch.kernels import ops
    cfg = rt.PAPER_CONFIGS[name]
    a = paper_matrix(n, seed, cfg.high_dtype)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    b = torch.randn((n, 16), generator=g, device="cuda", dtype=cfg.high_dtype)
    lp = rt.cholesky_padded(a, cfg)
    linvs = rt.diag_tri_inv(lp, cfg)
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
    schedule = {"potrf_leaf": 0, "tri_inv_leaf": 0, "panel_update": 0,
                "qgemm": 2 * (2 * T - 1) * solves,
                "residual_fused": loops + 1}
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
    line = {"phase": "refine", "ladder": name, "n": n, "k": 16,
            "method": method, "residual_dtype": residual_dtype,
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
_SPANS = (("potrf_kernel", "potrf_leaf"), ("tri_inv_kernel", "tri_inv_leaf"),
          ("qgemm_kernel", "qgemm"), ("round_rows", "panel_update"),
          ("gemm_plain", "panel_update"), ("trail_gemm", "panel_update"),
          ("commit", "panel_update"), ("residual_kernel", "residual_fused"))


def _profiled(fn):
    """fn() under torch.profiler: wall ms, device ms by port kernel (the
    rest as torch ops) and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        key = next((k for frag, k in _SPANS if frag in ev.key),
                   "other (torch ops)")
        by[key] = by.get(key, 0.0) + ev.self_device_time_total / 1e3
    busy = sum(by.values())
    return {"wall_ms": wall_ms, "device_ms_by_kernel": by,
            "device_busy_share": busy / wall_ms if by else None}


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


def breakdown(name, n, seed):
    """Device time by kernel inside one factor and one 16-column solve
    (torch.profiler), and the device's busy share of the wall time."""
    import repro_torch as rt
    cfg = rt.PAPER_CONFIGS[name]
    a = paper_matrix(n, seed)
    b16 = torch.ones((n, 16), device="cuda")
    lp = rt.cholesky_padded(a, cfg)
    line = {"phase": "breakdown", "ladder": name, "n": n}
    for label, fn in (("factor", lambda: rt.cholesky_padded(a, cfg)),
                      ("solve_k16", lambda: rt.solve_factored(lp, b16, cfg))):
        line[label] = _profiled(fn)
    return line


def cpu_agreement(name, n, seed):
    """The card's factor against the same port run on the CPU."""
    import repro_torch as rt
    cfg = rt.PAPER_CONFIGS[name]
    a = paper_matrix(n, seed, cfg.high_dtype)
    lg = rt.cholesky(a, cfg).cpu()
    lc = rt.cholesky(a.cpu(), cfg)
    rel = float((lg.double() - lc.double()).abs().max()
                / lc.double().abs().max())
    tol = TOL[cfg.levels[0]]
    if not rel < tol:
        raise AssertionError(f"{name} n={n}: card vs CPU {rel:g} >= {tol:g}")
    return {"ladder": name, "n": n, "rel_err": rel, "tol": tol}


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

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for name, fn in (("potrf_leaf", lambda: kernel_potrf(rates, gen)),
                     ("tri_inv_leaf", lambda: kernel_tri_inv(rates, gen)),
                     ("qgemm", lambda: kernel_qgemm(rates, gen, N_MAIN)),
                     ("panel_update", lambda: kernel_panel(rates, gen,
                                                           N_MAIN)),
                     ("residual_fused", lambda: kernel_residual(rates, gen,
                                                                N_MAIN))):
        t0 = time.perf_counter()
        checks, timing = fn()
        torch.cuda.synchronize()
        results[name] = timing
        emit({"phase": "kernel", "name": name, **timing,
              "checks": checks, "phase_s": time.perf_counter() - t0})

    # each driven path runs with fresh counts and must launch its kernels;
    # the kernels line sums the three paths' counts
    launches = {k: 0 for k in KERNELS}

    def drive(label, kernels, runs):
        ops.reset_launches()
        for run in runs:
            emit(run())
        got = dict(ops.LAUNCHES)
        for k in kernels:
            if got[k] == 0:
                raise AssertionError(f"{k} was not launched on the {label} "
                                     "path")
            launches[k] += got[k]
        emit({"phase": f"{label}_launches", **got})

    # warm-up of the whole path, then the main path
    path_run("pure_f32", 2048, 11)
    ladders = ("pure_f32", "bf16_f32", "f16x3_f32", "int8_f32")
    drive("path", PATH_KERNELS,
          [lambda i=i, name=name: path_run(name, N_MAIN, 100 + i)
           for i, name in enumerate(ladders)])
    drive("refine", KERNELS,
          [lambda i=i, name=name: refine_run(name, N_MAIN, 600 + i)
           for i, name in enumerate(ladders)]
          + [lambda: refine_run("bf16_f32", N_MAIN, 610, method="gmres"),
             lambda: refine_run("bf16_f32", N_MAIN, 611,
                                residual_dtype="f32")])
    drive("serve", KERNELS, [lambda: serve_phase(N_MAIN, 700)])

    elapsed = time.perf_counter() - t_start
    if elapsed < 500:
        emit(path_run("bf16_f32", 32768, 200))
    else:
        emit({"phase": "path", "ladder": "bf16_f32", "n": 32768,
              "skipped": f"{elapsed:.0f} s spent before it"})
    emit(path_run("f32x3_f64", 4096, 300))
    emit(breakdown("f16x3_f32", N_MAIN, 500))
    agree = [cpu_agreement(name, 2048, 400 + i)
             for i, name in enumerate(ladders + ("f32x3_f64",))]
    emit({"phase": "cpu_agreement", "runs": agree})

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
