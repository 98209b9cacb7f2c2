"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run loads the cell, makes its weights and inputs from ``--seed``, warms up
the cell's own shapes (all of that is ``setup_s``), measures for
``--seconds``, and, with ``--trace 1``, profiles a slice of the same traffic
after the window.  Once the window has closed and the program's state is
freed, it holds what the timed path produced to the plain reference
(``portbench/reference``) and prints, as its last line on standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with its limit, which also end standard error.

Without a card, or with fewer cards than the cell asks for, it prints no
result and exits 2; it exits 3 when ``jax``, ``jaxlib``, ``flax`` or the
JAX package ``dffx`` has been loaded.  Caches of the program's builds stay
inside the checkout (``build/``).
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from typing import Optional  # noqa: E402

#: top-level modules that no process of the benchmark may load
FORBIDDEN = ("jax", "jaxlib", "flax", "dffx")


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m portbench.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a rank of a cell on several cards, started by rank 0's process
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    p.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    p.add_argument("--overrides", default=None, help=argparse.SUPPRESS)
    p.add_argument("--fault", default=None, help=argparse.SUPPRESS)  # faults.py, on every rank
    return p.parse_args(argv)


def keep_caches_in_checkout(root) -> None:
    """Every build and kernel cache of the run at a fixed path in the checkout
    (the program's own ``build/kernels`` and ``build/host`` already are)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(root / "build" / "portbench" / sub)
    os.environ["USE_FLAX"] = "0"


def execute(workload: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
            overrides: Optional[dict] = None, rank: int = 0, world: int = 1,
            coordinator: Optional[str] = None, started: Optional[float] = None,
            control: bool = False, fault: Optional[str] = None):
    """Run the cell; returns the ``Run`` (rank 0 holds the result's numbers).
    ``control``: also read the control; ``fault``: plant a fault of
    ``faults.py`` under the timed path for this run."""
    from portbench import core, faults, networks

    cell = core.load_cell(workload, overrides)
    r = core.Run(cell, seed, seconds, trace, device, rank=rank, world=world,
                 coordinator=coordinator, started=started)
    r.overrides, r.control, r.fault = overrides, control, fault
    undo = None
    if fault:
        undo = faults.plant(fault, cell.traffic["driver"].startswith("train"),
                            networks.load(cell.config["network"]).DEPTH)
    try:
        core.driver(cell).run(r)
    finally:
        if undo is not None:
            undo()
    return r


def result(r) -> dict:
    """The last line's object for rank 0's ``Run``."""
    import torch

    from portbench import core

    cell = r.cell
    if r.trace:
        metrics = {}
        for m in cell.per_layer:
            value = core.metric_reader(m["name"])(r)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {**r.e2e, "setup_s": r.setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    cuda = r.device.type == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(r.device) if cuda else "cpu",
              "count": cell.chips, "memory_peak_bytes": int(r.memory_peak)}
    out = {"correct": False, "attempted": r.attempted, "failed": r.failed, "metrics": metrics,
           "device": device}
    if r.trace and r.slice is not None:
        device["busy_s"] = statistics.fmean(r.busy_s or [r.slice.busy_s])
        device["window_s"] = r.slice.window_s
        out["breakdown"] = core.breakdown(r.slice)
    checks = {name: {"value": value, "limit": cell.limits.get(name)}
              for name, value in r.checks.items() if name in cell.limits}
    out["correct"] = (bool(cell.limits) and set(cell.limits) <= set(checks) and r.failed == 0
                      and all(c["value"] <= c["limit"] for c in checks.values()))
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    args = parse(argv)
    from portbench import core

    keep_caches_in_checkout(core.ROOT)
    import torch

    cell = core.load_cell(args.workload)
    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            found = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
                  f"found {found}", file=sys.stderr)
            return 2
    overrides = json.loads(args.overrides) if args.overrides else None
    r = execute(args.workload, args.seed, args.seconds, bool(args.trace), device=args.device,
                overrides=overrides, rank=args.rank, world=args.world,
                coordinator=args.coordinator, started=STARTED, fault=args.fault)
    if args.rank != 0:
        return 0
    out = result(r)
    loaded = forbidden_loaded()
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    for line in r.notes:
        print(line, file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
