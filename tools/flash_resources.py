"""Registers, shared memory and spills of each compiled flash_attention
kernel instance, from one or two source trees, on a machine with nvcc.

Builds ``flash.cu``, ``flash_tc_bf16.cu`` and ``flash_tc_f16.cu`` of each
``csrc`` directory with the flags of ``repro_torch.kernels._build`` into a
scratch directory, reads ``cuobjdump --dump-resource-usage`` through
``repro_torch.audit.kernelaudit.resource_usage`` and prints one JSON
object: each tree's rows by kernel and, with two trees, the instances
whose resources differ and those found in one tree only. Exits 1 where an
instance present in both differs.

    PYTHONPATH=src python tools/flash_resources.py \\
        src/repro_torch/kernels/csrc [PARENT/src/repro_torch/kernels/csrc]
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

from repro_torch.audit import kernelaudit
from repro_torch.kernels import _build

SOURCES = ("flash.cu", "flash_tc_bf16.cu", "flash_tc_f16.cu")
KEYS = ("regs", "static_smem", "local_bytes", "stack_bytes")


def tree_rows(csrc: Path, out: Path) -> dict:
    """{kernel: {regs, static_smem, local_bytes, stack_bytes}} of csrc's
    flash sources, built into out."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        lib = out / f"lib{Path(name).stem}.so"
        procs[Path(name).stem] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.FLAGS, "-I", str(csrc), "-o", str(lib),
             str(csrc / name)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    libs = {}
    for stem, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {stem}: {log.decode(errors='replace')}")
        libs[stem] = lib
    return {r["kernel"]: {k: r[k] for k in KEYS}
            for r in kernelaudit.resource_usage(libs)}


def main(argv) -> int:
    trees = [Path(a).resolve() for a in argv[1:3]]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        rows = [tree_rows(t, Path(tmp) / str(i)) for i, t in enumerate(trees)]
    report = {"trees": [str(t) for t in trees], "rows": rows}
    if len(rows) == 2:
        new, old = rows
        report["differ"] = {k: {"new": new[k], "old": old[k]}
                            for k in sorted(set(new) & set(old))
                            if new[k] != old[k]}
        report["new_only"] = sorted(set(new) - set(old))
        report["old_only"] = sorted(set(old) - set(new))
        report["same"] = len(set(new) & set(old)) - len(report["differ"])
    print(json.dumps(report))
    return 1 if report.get("differ") else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
