"""The port's precision-conformance auditor (repro_torch.audit) on the CPU.

The traced flows of the port's blocked factor are held against the plan
and against the reference's walker (repro.audit.dtypeflow) on the same
sizes and ladders; the launch audits, which need the card, are checked
here for their verdict on the CPU (untestable, never clean) and for their
reconciliation logic on launch records of a CPU run. Traces are shared
through module-scoped fixtures.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.audit import conformance, dtypeflow, kernelaudit, lint
from repro_torch.audit import launchaudit, selftest
from repro_torch.audit.report import (CheckResult, Violation, build_report,
                                      load_report, validate_report)
from repro_torch.core.plan import build_plan
from repro_torch.core.precision import PAPER_CONFIGS
from repro_torch.launch.drive import spd_matrix

ROOT = Path(__file__).resolve().parents[1]

#: (ladder, n, leaf): the smoke ladders where every tile is narrow (512)
#: and where the plan mixes narrow and f32 tiles (1024: 8 leaf tiles), and
#: two one-narrow-level ladders that mix at 512
CASES = [("f16x3_f32", 512, 128), ("int8x3_f32", 512, 128),
         ("f16x3_f32", 1024, 128), ("int8x3_f32", 1024, 128),
         ("f16_f32", 512, 128), ("int8_f32", 512, 128)]
#: the cases where the reference walker's storage tags reach the trailing
#: pairs (ROADMAP C): its narrow FLOPs = the plan's narrow + f32 FLOPs
REFERENCE_MISSES = {("f16x3_f32", 1024, 128), ("int8x3_f32", 1024, 128)}


def _cfg(key, leaf):
    return dataclasses.replace(PAPER_CONFIGS[key], leaf=leaf)


@pytest.fixture(scope="module")
def port_audits():
    """audit_blocked of each case, with its traced flow."""
    out = {}
    for key, n, leaf in CASES:
        flow = []
        res = conformance.audit_blocked(n, _cfg(key, leaf), flow=flow)
        out[(key, n, leaf)] = (res, flow[0])
    return out


@pytest.fixture(scope="module")
def reference_flows():
    """The reference walker's flow of its own blocked_potrf per case."""
    import jax
    import jax.numpy as jnp
    from repro.audit import dtypeflow as ref_flow
    from repro.core.blocked import blocked_potrf
    from repro.core.precision import PAPER_CONFIGS as REF_CONFIGS
    out = {}
    for key, n, leaf in CASES:
        cfg = dataclasses.replace(REF_CONFIGS[key], leaf=leaf)
        out[(key, n, leaf)] = ref_flow.trace(
            blocked_potrf, jax.ShapeDtypeStruct((n, n), jnp.float32),
            cfg=cfg)
    return out


# -- report schema ------------------------------------------------------

def test_report_validates_under_reference(tmp_path):
    from repro.audit.report import validate_report as ref_validate
    res = CheckResult("demo", "t", [
        Violation("some-rule", "t", "boom", panel=1, tile=(2, 1)),
        Violation("other", "t", "meh", severity="warn")])
    assert not res.ok
    rep = build_report("smoke", [res], device="cpu")
    p = tmp_path / "r.json"
    p.write_text(json.dumps(rep))
    back = load_report(p)
    assert ref_validate(back) == [] and validate_report(back) == []
    assert back["summary"] == {"checks": 1, "violations": 2, "errors": 1,
                               "warns": 1}
    assert back["device"] == "cpu"
    assert back["violations"][0]["tile"] == [2, 1]


def test_report_rejects_malformed():
    rep = build_report("smoke", [])
    del rep["summary"]
    assert validate_report(rep)
    assert validate_report({"schema": 999}) != []


# -- dtype-flow analysis ------------------------------------------------

def test_dtypeflow_tags_rounded_operands():
    def f(x):
        x16 = x.to(torch.float16).to(torch.float32)
        return x16 @ x16

    res = dtypeflow.trace(f, torch.empty(64, 64))
    assert [d.eff_name for d in res.dots] == ["f16"]
    assert res.round_elems_by_name() == {"f16": 64 * 64}
    assert res.double_rounds() == []


def test_dtypeflow_flags_f16_bf16_double_round():
    def f(x):
        return x.to(torch.bfloat16).to(torch.float32).to(
            torch.float16).to(torch.float32)

    assert dtypeflow.trace(f, torch.empty(8, 8)).double_rounds()


def test_dtypeflow_stored_rounding_is_storage():
    """A rounding written into the result is storage: a product that
    reads the stored value unrounded runs at the container's precision;
    one whose operand was rounded for it (and not stored) at the
    rounding's."""
    def f(x, y):
        s = x.to(torch.float16).to(torch.float32)        # stored below
        r = y.to(torch.bfloat16).to(torch.float32)       # product only
        return s, s @ y, r @ y

    res = dtypeflow.trace(f, torch.empty(16, 16), torch.empty(16, 16))
    assert [d.eff_name for d in res.dots] == ["f32", "bf16"]
    assert res.round_elems_by_name() == {"f16": 256, "bf16": 256}
    assert [r.stored for r in res.rounds] == [True, False]


def test_dtypeflow_int8_round_and_scale_keep_tag():
    from repro_torch.core.quantize import quant_block

    def f(x, y):
        q, alpha = quant_block(x, "int8")
        return (q.to(torch.float32) * alpha) @ y

    res = dtypeflow.trace(f, torch.empty(32, 32), torch.empty(32, 32))
    assert [d.eff_name for d in res.dots] == ["int8"]
    assert res.round_elems_by_name() == {"int8": 32 * 32}


# -- plan conformance of the blocked factor ------------------------------

@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_audit_blocked_matches_plan(port_audits, case):
    key, n, leaf = case
    res, flow = port_audits[case]
    assert res.ok and res.violations == [], [str(v) for v in res.violations]
    plan = build_plan(n, _cfg(key, leaf))
    assert flow.dot_flops_by_name() == plan.expected_dot_flops()
    assert flow.round_elems_by_name() == plan.expected_round_elems()


def test_audit_blocked_mixed_sizes_mix_levels():
    """The 1024 cases are the ones whose plans mix narrow and f32 tiles."""
    for key in ("f16x3_f32", "int8x3_f32"):
        assert set(build_plan(1024, _cfg(key, 128)).expected_dot_flops()) \
            == {PAPER_CONFIGS[key].levels[0], "f32"}


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_audit_blocked_against_reference_walker(port_audits, reference_flows,
                                                case):
    """Equal to the reference walker's FLOPs and round elements, except
    where that walker lets L21's storage tags reach f32 trailing pairs
    (ROADMAP C), where the miss is exactly those pairs' FLOPs."""
    _, flow = port_audits[case]
    ref = reference_flows[case]
    assert flow.round_elems_by_name() == ref.round_elems_by_name()
    got, want = flow.dot_flops_by_name(), ref.dot_flops_by_name()
    if case not in REFERENCE_MISSES:
        assert got == want
    else:
        narrow = PAPER_CONFIGS[case[0]].levels[0]
        assert want == {narrow: got[narrow] + got["f32"]}
        assert got["f32"] == 117440512.0


def test_audit_blocked_names_flipped_tile():
    cfg = _cfg("f16x3_f32", 256)
    from repro_torch.core.plan import PrecisionPlan
    mut = PrecisionPlan(512, cfg)
    mut.levels = mut.levels.copy()
    i, j = mut.ntiles - 1, mut.ntiles - 2
    mut.levels[i, j] = mut.levels[j, i] = (
        0 if mut.levels[i, j] else len(cfg.levels) - 1)
    res = conformance.audit_blocked(512, cfg, plan=mut)
    hits = [v for v in res.violations
            if v.rule in ("plan-table-mismatch", "plan-dot-precision")]
    assert hits and any(f"({i}, {j})" in str(v) for v in hits)


def test_audit_blocked_names_dropped_round():
    cfg = _cfg("f16x3_f32", 128)
    ti, tp = 3, 0
    plan = selftest._no_round_plan(512, cfg, ti, tp)
    res = conformance.audit_blocked(512, cfg, plan=plan)
    rules = {v.rule for v in res.violations}
    assert {"plan-meta-mismatch", "plan-missing-round"} <= rules
    assert any(v.tile == (ti, tp) for v in res.violations)


def test_audit_solve_clean():
    res = conformance.audit_solve(512, _cfg("f16x3_f32", 128))
    assert res.ok and res.violations == [], [str(v) for v in res.violations]


def test_audit_refine_clean():
    res = conformance.audit_refine(256, _cfg("f16x3_f32", 128))
    assert res.ok and res.violations == [], [str(v) for v in res.violations]


# -- the distributed wire -------------------------------------------------

def test_wire_expectation_by_panel():
    """f16x3_f32 at n = 1024 on 4 ranks (w = 256): three panel gathers at
    the sharded plan's comm names, one f32 scale each where quantized."""
    cfg = PAPER_CONFIGS["f16x3_f32"]
    sp = conformance.ShardedPlan(build_plan(1024, cfg), 4)
    want = conformance.wire_expectation(cfg, 1024, 4)
    names = [sp.comm_name(j) for j in range(3)]
    f16 = names.count("f16") * 256 * 256 * 2
    f32 = (4 + names.count("f32")) * 256 * 256 * 4 + sum(
        sp.comm_quant(j) for j in range(3) if names[j] == "f16") * 4
    assert want == {"all_gather": {k: v for k, v in (("f16", f16),
                                                     ("f32", f32)) if v},
                    "broadcast": {}, "scatter": {}} or want["broadcast"]
    assert want["broadcast"] == {"f32": 4 * 256 * 256 * 4}
    raw = conformance.wire_expectation(cfg, 1024, 4, compress=False,
                                       broadcast_diag_only=False)
    assert raw == {"all_gather": {"f32": 7 * 256 * 256 * 4},
                   "broadcast": {}, "scatter": {}}


def test_audit_dist_clean_on_two_ranks():
    res = conformance.audit_dist(1024, PAPER_CONFIGS["f16x3_f32"], 2)
    assert res.ok and res.violations == [], [str(v) for v in res.violations]


# -- seeded mutations -----------------------------------------------------

@pytest.mark.parametrize("mutation", ["flip-compute-level",
                                      "drop-storage-round", "lossy-wire"])
def test_selftest_catches_cpu_mutation(mutation):
    """Each CPU mutation is caught and names its tile or panel (the
    lossy wire: panel 0)."""
    fn = {"flip-compute-level": selftest._mut_flip_level,
          "drop-storage-round": selftest._mut_drop_round,
          "lossy-wire": selftest._mut_lossy_wire}[mutation]
    assert fn() == []


def test_selftest_card_route_skips_on_cpu():
    (v,) = selftest.mut_card_route("cpu")
    assert v.rule == "selftest-skip" and v.severity == "warn"


# -- launch audits --------------------------------------------------------

@pytest.mark.parametrize("which", ["blocked", "solve", "refine"])
def test_launch_audits_untestable_on_cpu(which):
    cfg = PAPER_CONFIGS["f16x3_f32"]
    fn = {"blocked": launchaudit.audit_launch_blocked,
          "solve": launchaudit.audit_launch_solve,
          "refine": launchaudit.audit_launch_refine}[which]
    res = fn(1024, cfg, device="cpu")
    assert res.ok and [v.rule for v in res.violations] == [
        "launch-untestable"]
    assert res.violations[0].severity == "warn"


def _as_card_launches(calls, b, container="f32"):
    """CPU launch records filled in as the card would count them: one
    launch a call, and each panel's pairs by the route of the name they
    were given."""
    out = []
    for c in calls:
        kernel = {"potrf": "potrf_leaf", "tri_inv": "tri_inv_leaf",
                  "panel_update": "panel_update"}[c.entry]
        routes = {}
        if c.entry == "panel_update":
            names = c.meta["pair_names"]
            tc = sum(launchaudit.tc_route(nm, container, b)
                     for i, row in enumerate(names) for nm in row[:i + 1])
            total = sum(i + 1 for i in range(len(names)))
            routes = {"panel": {"tc": tc, "simt": total - tc}}
        out.append(dataclasses.replace(c, on_card=True,
                                       launches={kernel: 1}, routes=routes))
    return out


def test_launch_recorder_reconciles_and_names_card_route():
    """The recorder changes nothing ops computes; the blocked launch
    reconciliation is clean on the pristine plan's records and names the
    tile of the card-route mutant."""
    from repro_torch.core.blocked import blocked_potrf
    cfg = PAPER_CONFIGS["f16x3_f32"]
    n = 1536
    a = spd_matrix(n, 3, torch.float32, "cpu")
    want = blocked_potrf(a, cfg)
    calls = []
    with launchaudit.record(calls):
        got = blocked_potrf(a, cfg)
    assert torch.equal(got, want)
    assert [c.entry for c in calls].count("panel_update") == 5
    assert not any(c.on_card or c.launches for c in calls)
    assert launchaudit.blocked_violations(
        _as_card_launches(calls, cfg.leaf), n, cfg, "t") == []
    plan, tile = selftest.card_route_plan(n, cfg)
    calls = []
    with launchaudit.record(calls):
        blocked_potrf(a, cfg, plan=plan)
    viols = launchaudit.blocked_violations(
        _as_card_launches(calls, cfg.leaf), n, cfg, "t")
    rules = {v.rule for v in viols}
    assert {"launch-pair-name", "launch-route",
            "launch-dot-precision"} <= rules
    assert any(v.tile == tile for v in viols if v.rule == "launch-route")


def test_launch_route_counts_alone_name_the_panel():
    """The dispatch mutant's records: pristine names, one pair of panel 0
    counted on the CUDA cores. Only launch-route fires, naming panel 0;
    the self-test's verdict accepts exactly that shift of the counts."""
    from repro_torch.core.blocked import blocked_potrf
    cfg = PAPER_CONFIGS["f16x3_f32"]
    n = 1536
    calls = []
    with launchaudit.record(calls):
        blocked_potrf(spd_matrix(n, 3, torch.float32, "cpu"), cfg)
    calls = _as_card_launches(calls, cfg.leaf)
    want = launchaudit.planned_routes(n, cfg)
    assert want == {
        k: sum(c.routes.get("panel", {}).get(k, 0) for c in calls)
        for k in ("tc", "simt")}
    p0 = next(i for i, c in enumerate(calls) if c.entry == "panel_update")
    r = calls[p0].routes["panel"]
    calls[p0] = dataclasses.replace(calls[p0], routes={"panel": {
        "tc": r["tc"] - 1, "simt": r["simt"] + 1}})
    res = CheckResult("launch-blocked", "t", launchaudit.blocked_violations(
        calls, n, cfg, "t"))
    assert [(v.rule, v.panel, v.tile) for v in res.violations] == [
        ("launch-route", 0, None)]
    moved = {"tc": want["tc"] - 1, "simt": want["simt"] + 1}
    quiet = ("launch-pair-name", "launch-dot-precision")
    assert selftest.route_shift_misses("m", res, moved, want, "panel=0",
                                       quiet) == []
    # counts that did not move, or a rule that reads names firing, miss
    assert selftest.route_shift_misses("m", res, want, want, "panel=0",
                                       quiet)
    loud = CheckResult("launch-blocked", "t", res.violations + [Violation(
        "launch-pair-name", "t", "x", panel=0)])
    assert selftest.route_shift_misses("m", loud, moved, want, "panel=0",
                                       quiet)


def test_off_route_dispatch_moves_one_pair_in_bounds():
    """The dispatch mutant's patched panel.plan moves the one pair of
    panel 0 from the tensor cores to the CUDA cores, counts it so, and
    keeps the plan inside its bounds; other panels are untouched."""
    from repro_torch.kernels import panel
    cfg = PAPER_CONFIGS["f16x3_f32"]
    n = 1536
    plan, tile = selftest.card_route_plan(n, cfg)
    nt, (i, j) = plan.ntiles - 1, (tile[0] - 1, tile[1] - 1)
    pristine = build_plan(n, cfg)
    metas = [pristine.panel_meta(p) for p in (0, 1)]
    real = [panel.plan(m.pair_names, m.pair_quants, torch.float32, cfg.leaf)
            for m in metas]
    with selftest.off_route_dispatch(nt, i, j):
        got = [panel.plan(m.pair_names, m.pair_quants, torch.float32,
                          cfg.leaf) for m in metas]
    assert got[1] == real[1] and panel.plan(
        metas[0].pair_names, metas[0].pair_quants, torch.float32,
        cfg.leaf) == real[0]
    assert got[0].routes == {"tc": real[0].routes["tc"] - 1,
                             "simt": real[0].routes["simt"] + 1}
    assert not any((i, j) in pairs for pairs in got[0].tc_pairs)
    assert {it[:2] for it in got[0].simt_items} - {
        it[:2] for it in real[0].simt_items} == {(i, j)}
    assert got[0].slots[-1][3] == panel.KIND["simt"]
    assert kernelaudit.panel_violations(got[0], nt, cfg.leaf, torch.float32,
                                        "t") == []


# -- kernel static checks -------------------------------------------------

def test_kernel_checks_clean():
    res = kernelaudit.audit_kernels()
    assert res.ok and res.violations == [], [str(v) for v in res.violations]


def test_kernel_accumulator_flags_planted_narrow(tmp_path):
    csrc = tmp_path / "csrc"
    import shutil
    shutil.copytree(kernelaudit.CSRC, csrc)
    p = csrc / "tc_gemm.cuh"
    text = p.read_text()
    assert "m64n256k16.f32." in text
    p.write_text(text.replace("m64n256k16.f32.", "m64n256k16.f16.", 1))
    q = csrc / "trsm.cu"
    text = q.read_text()
    q.write_text(text.replace("T acc[TM][TN];", "__half acc[TM][TN];", 1))
    viols = kernelaudit.accumulator_violations(csrc)
    assert {(v.path, v.severity) for v in viols} == {
        ("tc_gemm.cuh", "error"), ("trsm.cu", "error")}


def test_kernel_index_bounds_flag_planted_items(monkeypatch):
    from repro_torch.kernels import panel, trsm
    assert kernelaudit.trsm_violations(256, 256, torch.float32, "t") == []
    real = trsm.work_items
    monkeypatch.setattr(trsm, "work_items", lambda n, bn, kc: real(
        n, bn, kc) + [(n - 64, n + 64, 0, n)])
    assert any(v.rule == "kernel-index-bounds"
               for v in kernelaudit.trsm_violations(256, 256,
                                                    torch.float32, "t"))
    cfg = PAPER_CONFIGS["f16x3_f32"]
    meta = build_plan(2048, cfg).panel_meta(0)
    good = panel.plan(meta.pair_names, meta.pair_quants, torch.float32, 256)
    assert kernelaudit.panel_violations(good, 7, 256, torch.float32,
                                        "t") == []
    bad = dataclasses.replace(good, tc_pairs=(good.tc_pairs[0] + ((7, 0),),)
                              + good.tc_pairs[1:])
    assert any("outside" in v.message for v in kernelaudit.panel_violations(
        bad, 7, 256, torch.float32, "t"))


#: cuobjdump --dump-resource-usage of two panel kernels (sm_90a), and the
#: names CUPTI gives their launches
_RESOURCE_USAGE = """
Resource usage:
 Common:
  GLOBAL:0
 Function _Z8panel_tcI6__halfLi256EEv14CUtensorMap_stPKfPfxxPKiiiiii:
  REG:254 STACK:0 SHARED:1088 LOCAL:0 CONSTANT[0]:896 TEXTURE:0 SURFACE:0
 Function _Z12panel_copiesIdEvPKT_xxPhxPfPKiS6_ii:
  REG:64 STACK:88 SHARED:1280 LOCAL:16 CONSTANT[0]:600 TEXTURE:0 SURFACE:0
"""


def test_resource_table_reads_cuobjdump_and_cupti():
    """cuobjdump's rows joined with the launchers' list of dynamic shared
    memory and CUPTI's launches; every compiled kernel is held to the
    limit, launched or not, and a row the list or the join misses is an
    error."""
    rows = kernelaudit.parse_resource_usage(_RESOURCE_USAGE)
    assert [(r["regs"], r["static_smem"], r["local_bytes"]) for r in rows] \
        == [(254, 64, 0), (64, 256, 16)]
    rows[0]["kernel"] = kernelaudit.kernel_key("panel_tc<__half, (int)256>")
    rows[1]["kernel"] = kernelaudit.kernel_key("panel_copies<double>")
    rows = [dict(r, lib="panel") for r in rows]
    listed = [{"lib": "panel", "kernel": rows[0]["kernel"],
               "dynamic_smem": 230400, "bound": False},
              {"lib": "panel", "kernel": rows[1]["kernel"],
               "dynamic_smem": 0, "bound": False}]
    launched = {kernelaudit.kernel_key(
        "void panel_tc<__half, 256>(CUtensorMap_st, float const*)"): {
            "launches": 3, "regs": 254, "smem": 230464}}

    def audit(listed, launched):
        table = kernelaudit.resource_table(rows, listed, launched)
        return table, kernelaudit.audit_resources(table, listed, launched)
    table, res = audit(listed, launched)
    assert [(r["dynamic_smem"], r["launches"], r["launch_smem"])
            for r in table] == [(230400, 3, 230464), (0, 0, None)]
    assert res.ok and [v.severity for v in res.violations] == ["warn"]
    # a kernel that did not launch is held to the limit all the same
    _, over = audit([listed[0], dict(listed[1], dynamic_smem=232448)],
                    launched)
    assert not over.ok and "exceeds 232448" in str(over.violations[0])
    # PyTorch's own kernels are not the table's business
    torch_kernel = {"at::native::vectorized_elementwise_kernel<4,float>": {
        "launches": 9, "regs": 30, "smem": 0}}
    assert audit(listed, {**launched, **torch_kernel})[1].ok
    # a compiled kernel no launcher lists; a launch of a port template the
    # table cannot name; work none of whose launches joins; a launch
    # whose shared memory is not the listed size
    _, res = audit(listed[:1], {**launched, "panel_tc<__half,128>": {
        "launches": 1, "regs": 200, "smem": 1}})
    msgs = [str(v) for v in res.violations if v.severity == "error"]
    assert len(msgs) == 2 and "no launcher lists" in msgs[0] \
        and "no compiled kernel" in msgs[1]
    _, res = audit(listed, torch_kernel)
    assert not res.ok and "joins a compiled kernel" in str(res.violations[-1])
    _, res = audit([dict(listed[0], dynamic_smem=230000), listed[1]],
                   launched)
    assert not res.ok and "a launch took 230464 B" in str(res.violations[0])


def test_tri_decode_model_is_the_row_order():
    got = [kernelaudit.tri_decode(t) for t in range(5050)]
    assert got == [(i, j) for i in range(100) for j in range(i + 1)]


# -- lint pack ------------------------------------------------------------

def test_lint_repo_clean():
    res = lint.lint_repo()
    assert res.ok and res.violations == [], [str(v) for v in res.violations]


def test_lint_flags_planted_violations(tmp_path):
    src = tmp_path / "src" / "repro_torch"
    for d in ("core", "tune", "kernels", "serve"):
        (src / d).mkdir(parents=True)
    (src / "core" / "plan.py").write_text("import torch\n")
    (src / "tune" / "db.py").write_text(
        "def f():\n    from jax import devices\n    return devices\n")
    (src / "kernels" / "k.py").write_text(
        "import torch\n"
        "A = torch.float16\n"
        "B = torch.float32\n"          # wide: allowed
        "C = 65504.0\n")
    (src / "tune" / "search.py").write_text(
        "import time\n"
        "import numpy as np\n"
        "def timeit(fn):\n    return time.perf_counter()\n"
        "def bad():\n    return time.time(), np.random.default_rng()\n")
    (src / "core" / "x.py").write_text(
        "import jax.numpy as jnp\nfrom repro.core import plan\n"
        "from repro_torch.serve.engine import SolverEngine\n")
    (src / "serve" / "engine.py").write_text(
        "from repro_torch.serve.options import SolveOptions\n")
    (tmp_path / "chip_smoke.py").write_text("import repro\n")
    viols = lint.lint_repo(tmp_path).violations
    rules = sorted({v.rule for v in viols})
    assert rules == ["db-stdlib-only", "kernel-dtype-literal",
                     "plan-trace-free", "port-imports",
                     "search-injected-timer", "serve-public-surface"]
    by_rule = {}
    for v in viols:
        by_rule.setdefault(v.rule, []).append(v)
    assert len(by_rule["kernel-dtype-literal"]) == 2
    assert len(by_rule["search-injected-timer"]) == 2
    # jax in x.py and db.py, repro in x.py and chip_smoke.py
    assert sorted((v.path, v.line) for v in by_rule["port-imports"]) == [
        ("chip_smoke.py", 1), ("src/repro_torch/core/x.py", 1),
        ("src/repro_torch/core/x.py", 2), ("src/repro_torch/tune/db.py", 2)]
    # the serve package's own modules may import each other
    assert [v.path for v in by_rule["serve-public-surface"]] == [
        "src/repro_torch/core/x.py"]


def test_lint_pragma_suppresses(tmp_path):
    src = tmp_path / "src" / "repro_torch"
    for d in ("core", "tune", "kernels"):
        (src / d).mkdir(parents=True)
    (src / "core" / "plan.py").write_text(
        "import torch  # audit: allow(plan-trace-free)\n")
    (src / "kernels" / "k.py").write_text(
        "import torch\nA = torch.int8  # audit: allow(kernel-dtype-literal)\n")
    (src / "tune" / "db.py").write_text("")
    (src / "tune" / "search.py").write_text("")
    (tmp_path / "chip_smoke.py").write_text("")
    assert lint.lint_repo(tmp_path).violations == []


# -- the CLI --------------------------------------------------------------

def test_cli_cpu_smoke(tmp_path):
    out = tmp_path / "audit.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.audit", "--device", "cpu",
         "--smoke", "--json", str(out)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    rep = load_report(out)
    from repro.audit.report import validate_report as ref_validate
    assert ref_validate(rep) == []
    assert rep["summary"]["errors"] == 0 and rep["device"] == "cpu"
    assert {v["rule"] for v in rep["violations"]} == {"launch-untestable"}
    gate = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "perf_gate.py"), "audit",
         "--json", str(out)], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120)
    assert gate.returncode == 0, gate.stdout + gate.stderr
