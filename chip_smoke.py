#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check every kernel.

    python3 chip_smoke.py            # one card; no arguments

Run from the root of a checkout. The kernels are built from
``src/repro_torch/kernels/csrc`` at first use. Every phase prints one JSON
line; a failing check raises, and the script exits non-zero with no
result line. Phases:

1. ``env``: the card (``nvidia-smi``), torch and CUDA versions, build time.
2. ``kernel``: each of the four kernels against its plain PyTorch version
   on the card, for every operand type and rounding variant, at the
   shapes of tests/test_kernels.py and at the main path's shapes
   (leaf b = 256, the first diagonal tile of the n = 16384 matrix, panel
   heights m = 256 .. n - 256); times of the kernel,
   the plain version and the one PyTorch call computing the same function
   (where there is one), beside the card's least time for that work.
3. ``path``: the port's main path, ``cholesky_solve`` with 16 right-hand
   sides and with one vector, at n = 16384 on the paper's §IV-A matrix,
   for the ladders pure_f32, bf16_f32, f16x3_f32 and int8_f32; factor
   and solve times, peak memory, the residual ||b - A x|| / ||b|| in f64
   and each kernel's launch count, which must match the schedule. Then
   bf16_f32 at n = 32768 and f32x3_f64 at n = 4096.
4. ``breakdown``: device time by kernel inside one factor and one
   16-column solve of f16x3_f32 at n = 16384 (torch.profiler), and the
   card's busy share of the wall time.
5. ``cpu_agreement``: each ladder's factor on the card against the same
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
}
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
                "panel_update": T - 1, "qgemm": 2 * (2 * T - 1)}
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


#: kernel-name fragments of the profiler's device events, by port kernel
_SPANS = (("potrf_kernel", "potrf_leaf"), ("tri_inv_kernel", "tri_inv_leaf"),
          ("qgemm_kernel", "qgemm"), ("round_rows", "panel_update"),
          ("gemm_plain", "panel_update"), ("trail_gemm", "panel_update"),
          ("commit", "panel_update"))


def breakdown(name, n, seed):
    """Device time by kernel inside one factor and one 16-column solve
    (torch.profiler), and the device's busy share of the wall time."""
    import repro_torch as rt
    from torch.profiler import ProfilerActivity, profile
    cfg = rt.PAPER_CONFIGS[name]
    a = paper_matrix(n, seed)
    b16 = torch.ones((n, 16), device="cuda")
    lp = rt.cholesky_padded(a, cfg)
    line = {"phase": "breakdown", "ladder": name, "n": n}
    for label, fn in (("factor", lambda: rt.cholesky_padded(a, cfg)),
                      ("solve_k16", lambda: rt.solve_factored(lp, b16, cfg))):
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
        line[label] = {"wall_ms": wall_ms, "device_ms_by_kernel": by,
                       "device_busy_share": busy / wall_ms if by else None}
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
                                                           N_MAIN))):
        t0 = time.perf_counter()
        checks, timing = fn()
        torch.cuda.synchronize()
        results[name] = timing
        emit({"phase": "kernel", "name": name, **timing,
              "checks": checks, "phase_s": time.perf_counter() - t0})

    # warm-up of the whole path, then the main path with fresh counts
    path_run("pure_f32", 2048, 11)
    ladders = ("pure_f32", "bf16_f32", "f16x3_f32", "int8_f32")
    ops.reset_launches()
    for i, name in enumerate(ladders):
        emit(path_run(name, N_MAIN, 100 + i))
    launches = dict(ops.LAUNCHES)
    for k, v in launches.items():
        if v == 0:
            raise AssertionError(f"{k} was not launched on the main path")

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
