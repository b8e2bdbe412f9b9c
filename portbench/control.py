"""Readings behind the limits of ``correct``: the compared numbers of a cell
over many seeds, for the program as it runs, for the control (the reference
in the precision below the configuration's, in the program's place) and
for the program with a fault planted, each as one JSON line.

    python3 portbench/control.py --workload <cell> --seed <first> \\
        --runs program:12 control:3 half_batch:3 altered:3 [--seconds S]

Seeds count up from ``--seed``; every mode uses the same seeds from the
start. The benchmark's own runs never run this. Training needs no measured
window (``--seconds 0`` runs one step after the three checked ones); a
serving cell needs one long enough for as many requests as a run checks.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--runs", nargs="+", required=True, help="mode:count, mode one of program, control, "
                   "unchanged, half_batch, altered")
    p.add_argument("--seconds", type=float, default=0.0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench import harness

    cell = harness.cell(args.workload)
    drive = harness.driver(cell["mix"]["driver"]).run
    for spec in args.runs:
        mode, count = spec.split(":")
        for seed in range(args.seed, args.seed + int(count)):
            t0 = time.perf_counter()
            out = drive(cell, seed, args.seconds, False, t0,
                        fault=None if mode in ("program", "control") else mode, control=mode == "control")
            print(json.dumps({"cell": args.workload, "mode": mode, "seed": seed, "attempted": out["attempted"],
                              "seconds": time.perf_counter() - t0, "numbers": out["numbers"],
                              "detail": out.get("detail")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
