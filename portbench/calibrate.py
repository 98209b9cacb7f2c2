"""Readings that the limits of ``limits/<cell>.json`` are set from, taken in
one process over many seeds: what the program's timed path gives against
the plain reference (the lower reading), what the control gives (the
reference in fp8 in the program's place: the upper reading), and what a
planted fault gives (``faults.py``).

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 \\
        [--control 1,2] [--fault half] [--seconds 3] [--out FILE]

Each run is a whole run of the cell with a short window.  One JSON line a
run goes to standard output and to ``--out`` (appended), then a summary:
each number's largest program reading and smallest control and fault
reading.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from portbench import run
from portbench.core import ROOT


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--control", default="", help="seeds that also read the control")
    p.add_argument("--fault", default=None, help="a fault of faults.py, planted in every run")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    p.add_argument("--overrides", default=None,
                   help='JSON {"config": {...}, "traffic": {...}}: keys of the data replaced')
    args = p.parse_args(argv)
    run.keep_caches_in_checkout(ROOT)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control.split(",") if s}
    lows, ups = {}, {}
    for seed in seeds:
        t0 = time.perf_counter()
        r = run.execute(args.workload, seed, args.seconds, False, control=seed in control,
                        fault=args.fault, started=t0, device=args.device,
                        overrides=json.loads(args.overrides) if args.overrides else None)
        line = {"workload": args.workload, "seed": seed, "fault": args.fault,
                "checks": r.checks, "control_checks": r.control_checks, "e2e": r.e2e,
                "setup_s": r.setup_s, "attempted": r.attempted, "failed": r.failed,
                "values": {k: v for k, v in r.values.items() if isinstance(v, (int, float))},
                "leaves": r.leaves, "notes": r.notes, "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        into = ups if args.fault else lows
        pick = min if args.fault else max
        for k, v in r.checks.items():
            into[k] = pick(into.get(k, v), v)
        for k, v in r.control_checks.items():
            ups[k] = min(ups.get(k, v), v)
    print(json.dumps({"summary": args.workload, "fault": args.fault, "program_max": lows,
                      "control_or_fault_min": ups}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
