"""CLI: ``python -m repro_torch.audit [--smoke|--full] [--selftest]
[--json OUT] [--device {cuda,cpu}]``.

``--smoke`` (the default) audits the reference's two smoke ladders'
traced flows, the distributed wire on 4 CPU ranks, the kernel sources and
the lint pack, and on the card the same ladders' launches and the
kernels' resources. ``--full`` takes every f32-high paper ladder, the
solve and refinement consumers, the uncompressed wire and the mutation
self-test. ``--device cpu`` runs the traced, static, lint and CPU-mutation
checks and lists the launch checks as ``launch-untestable``; the default,
``cuda``, needs a CUDA device.

Exit status is the audit verdict: 0 clean (warnings allowed), 1 any
error-severity violation; the JSON report carries the details.
"""
from __future__ import annotations

import argparse
import json
import sys

#: smoke ladders: one quantized-f16, one int8 (covers both round shapes)
_SMOKE_CFGS = ("f16x3_f32", "int8x3_f32")
#: every paper ladder with an f32 container (pure_f16 has no wide carrier
#: to round from)
_FULL_CFGS = ("pure_f32", "f16_f32", "f16x3_f32", "f16x5_f32",
              "bf16_f32", "bf16x3_f32", "int8_f32", "int8x3_f32")
#: traced size: 8 leaf tiles, where the f16x3 and int8x3 plans mix levels
_N_TRACE = 2048
_N_DIST, _P_DIST = 1024, 4
#: launch audits on the card
_N_LAUNCH = 4096


def _run(mode: str, selftest: bool, device: str) -> list:
    from repro_torch.audit import conformance, kernelaudit, launchaudit
    from repro_torch.audit.lint import lint_repo
    from repro_torch.core.precision import PAPER_CONFIGS
    cfgs = _SMOKE_CFGS if mode == "smoke" else _FULL_CFGS
    rep = PAPER_CONFIGS[_SMOKE_CFGS[0]]
    results = [lint_repo(), kernelaudit.audit_kernels()]
    for key in cfgs:
        results.append(conformance.audit_blocked(_N_TRACE,
                                                 PAPER_CONFIGS[key]))
    results.append(conformance.audit_dist(_N_DIST, rep, _P_DIST))

    def launches():
        for key in cfgs:
            results.append(launchaudit.audit_launch_blocked(
                _N_LAUNCH, PAPER_CONFIGS[key], device=device))
        results.append(launchaudit.audit_launch_solve(_N_LAUNCH, rep,
                                                      device=device))
        results.append(launchaudit.audit_launch_refine(_N_LAUNCH, rep,
                                                       device=device))
    if device == "cuda":
        results.append(kernelaudit.card_resources(launches)[0])
    else:
        launches()
    if mode == "full":
        results.append(conformance.audit_solve(_N_TRACE, rep))
        results.append(conformance.audit_refine(_N_TRACE // 2, rep))
        for key in ("int8x3_f32", "bf16_f32"):
            results.append(conformance.audit_dist(
                _N_DIST, PAPER_CONFIGS[key], _P_DIST))
        results.append(conformance.audit_dist(_N_DIST, rep, _P_DIST,
                                              compress=False))
    if selftest or mode == "full":
        from repro_torch.audit.selftest import run_selftest
        results.append(run_selftest(device))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.audit",
        description="Precision-conformance audit of the port against its "
                    "PrecisionPlan.")
    g = ap.add_mutually_exclusive_group()
    g.add_argument("--smoke", action="store_true",
                   help="2 ladders, one size (default)")
    g.add_argument("--full", action="store_true",
                   help="all f32-high ladders + solve/refine/uncompressed "
                        "+ mutation self-test")
    ap.add_argument("--selftest", action="store_true",
                    help="also run the seeded-mutation self-test")
    ap.add_argument("--json", metavar="OUT",
                    help="write the schema'd violation report here")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the launch audits run (default: cuda)")
    args = ap.parse_args(argv)
    mode = "full" if args.full else "smoke"

    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("torch sees no CUDA device: run on the card, or "
                           "pass --device cpu")
    from repro_torch.audit.report import build_report
    results = _run(mode, args.selftest, args.device)
    report = build_report(mode, results, device=args.device)

    for res in results:
        mark = "ok " if res.ok else "FAIL"
        print(f"[{mark}] {res.name:18s} {res.target}")
        for v in res.violations:
            print(f"       {v}")
    s = report["summary"]
    print(f"-- {s['checks']} checks, {s['errors']} errors, "
          f"{s['warns']} warnings ({mode}, {args.device})")

    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
        print(f"-- report written to {args.json}")
    return 1 if s["errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
