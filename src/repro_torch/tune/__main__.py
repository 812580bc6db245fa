"""CLI for the autotuner: regenerate or verify a tuning database.

Regenerate the card's packaged database (on a machine with the card;
``--out`` elsewhere keeps the packaged file as it is):

    PYTHONPATH=src python -m repro_torch.tune \\
        --ladders pure_f32,bf16_f32,f16x3_f32,int8_f32

``--nshards P`` (P >= 2) also races the distributed grid: the command
starts P ranks on this machine (gloo; on the card's machine they share
its cards) and rank 0 writes the database.
``--ladders`` takes ``PAPER_CONFIGS`` names or canonical keys; the
database is keyed by the canonical key (``ladder_key``: ``pure_f32`` is
``f32``, ``f16x3_f32`` is ``f16_f16_f16_f32``), which is what
``engine="auto"`` looks up. ``--smoke`` races the tiny sizes (256, 512);
``--backend cpu`` runs the search on the CPU's plain kernels. ``--verify PATH`` checks the schema
and that lookups follow the database's engine crossovers (tree below,
blocked above), with no tuning run. Exit status is non-zero on any
violation.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.tune",
                                 description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny candidate sizes (256, 512)")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="database path to write (default: the packaged "
                         "per-backend file under repro_torch/tune/data/)")
    ap.add_argument("--backend", default="cuda", choices=("cuda", "cpu"),
                    help="device to race on, and the database's key")
    ap.add_argument("--ladders", default="bf16_f32",
                    help="comma-separated ladders to tune: PAPER_CONFIGS "
                         "names (f16x3_f32) or canonical keys, the levels "
                         "joined by '_' (f16_f16_f16_f32), which the "
                         "database is keyed by")
    ap.add_argument("--nshards", type=int, default=0,
                    help="ranks of the distributed grid (>= 2 to race it)")
    ap.add_argument("--verify", default=None, metavar="PATH",
                    help="validate an existing database and check the "
                         "lookup follows its crossovers; no tuning run")
    args = ap.parse_args(argv)

    from repro_torch.tune import db as tdb

    if args.verify:
        loaded = tdb.load_db(args.verify)
        if loaded is None:
            print(f"FAIL: could not load tuning DB at {args.verify}")
            return 1
        errs = tdb.verify_consultation(loaded)
        for e in errs:
            print(f"FAIL: {e}")
        print(f"verify {args.verify}: "
              f"{'FAIL' if errs else 'OK'} ({len(loaded.entries)} entries, "
              f"{len(loaded.crossovers)} crossovers)")
        return 1 if errs else 0

    from repro_torch.core.precision import PAPER_CONFIGS
    from repro_torch.tune.search import autotune
    ladders = tuple(tdb.ladder_key(PAPER_CONFIGS[x]) if x in PAPER_CONFIGS
                    else x for x in args.ladders.split(","))
    print("name,us_per_call,derived", flush=True)
    kwargs = dict(smoke=args.smoke, ladders=ladders, device=args.backend,
                  nshards=args.nshards)
    if args.nshards >= 2:
        from repro_torch.launch.mesh import launch
        payload = launch(autotune, args.nshards, (args.backend,), kwargs,
                         device=args.backend, timeout=6 * 3600.0)[0]
    else:
        payload = autotune(args.backend, **kwargs)
    out = args.out or os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "data", f"{payload['backend']}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"# wrote {len(payload['entries'])} entries / "
          f"{len(payload['crossovers'])} crossovers to {out}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
