"""What every run shares: the cell read from ``BENCHMARK.json`` and its data
files, the run's state that the traffic drivers fill in, the traced slice,
and the comparison's bookkeeping.

A cell names a configuration (``configs/<config>.json``, the file
``BENCHMARK.json`` gives it) and a traffic mix (``traffic/<traffic>.json``),
whose ``driver`` names the module of ``drivers/`` that runs it.  Its limits
are ``limits/<cell>.json``; each per-layer metric is ``metrics/<name>.py``.
Nothing here lists them: a new cell, mix, driver, limit or metric is a new
file and a new entry of ``BENCHMARK.json``.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from portbench.reference import weights

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]  # the per-layer metrics this cell reports
    limits: Dict[str, float]


def _reported_in(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, overrides: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files; ``overrides``
    (``{"config": {...}, "traffic": {...}}``) replace keys of the data, for
    the CPU tests' small sizes."""
    bench = read_json(BENCHMARK)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {BENCHMARK.name}; it has {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(ROOT / configs[w["config"]]["file"])
    traffic = read_json(PACKAGE / "traffic" / f"{w['traffic']}.json")
    overrides = overrides or {}
    config.update(overrides.get("config", {}))
    traffic.update(overrides.get("traffic", {}))
    limits_file = PACKAGE / "limits" / f"{name}.json"
    limits = read_json(limits_file)["limits"] if limits_file.is_file() else {}
    return Cell(name, config, traffic, int(w["chips"]),
                [m for m in bench["end_to_end"] if _reported_in(m, name)],
                [m for m in bench["per_layer"] if _reported_in(m, name)], limits)


def driver(cell: Cell):
    return importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")


def metric_reader(name: str) -> Callable:
    """``read`` of ``metrics/<name>.py``, loaded by its path (names hold dots)."""
    path = PACKAGE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclasses.dataclass
class Slice:
    """The traced slice: its kernels (name, start us, duration us), the
    longest idle gaps by what the host was doing, its length and how much
    work it did."""

    kernels: List[tuple]
    busy_s: float
    window_s: float
    gaps: List[tuple]
    items: int  # stacks the slice completed (all ranks)
    calls: int  # forwards or steps on this rank


class Run:
    """One run of one cell: its arguments and what the driver measured."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device,
                 *, rank: int = 0, world: int = 1, coordinator: Optional[str] = None,
                 started: Optional[float] = None):
        self.cell, self.seed, self.seconds, self.trace = cell, int(seed), float(seconds), trace
        self.device = torch.device(device)
        self.rank, self.world, self.coordinator = rank, world, coordinator
        self.started = time.perf_counter() if started is None else started
        self.setup_s: Optional[float] = None
        self.e2e: Dict[str, float] = {}
        self.values: Dict[str, float] = {}  # spans and counters for the per-layer readers
        self.attempted = 0
        self.failed = 0
        self.checks: Dict[str, float] = {}
        self.slice: Optional[Slice] = None
        self.busy_s: List[float] = []  # every rank's, on rank 0
        self.memory_peak = 0
        self.notes: List[str] = []  # stderr lines before the checks
        self.control = False  # also read the control: the reference in fp8 in the program's place
        self.control_checks: Dict[str, float] = {}
        self.fault: Optional[str] = None  # a fault planted under the timed path (faults.py)
        self.leaves: Dict[str, str] = {}  # the worst leaf of each training number
        self.overrides: Optional[dict] = None  # the CPU tests' small sizes, passed to every rank

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def generator(self, stream: str, device=None) -> torch.Generator:
        return weights.generator(self.seed, stream, device or self.device)

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def end_setup(self) -> float:
        """Set-up ends here: everything before the window."""
        self.mark("set-up")
        self.setup_s = time.perf_counter() - self.started
        return time.perf_counter()

    def read_memory(self) -> None:
        if self.cuda:
            self.memory_peak = max(self.memory_peak, torch.cuda.max_memory_allocated(self.device))

    def note(self, line: str) -> None:
        self.notes.append(line)

    def mark(self, phase: str) -> None:
        """A note of the set-up's seconds so far, at the end of ``phase``."""
        self.sync()
        self.note(f"set-up: {phase} done at {time.perf_counter() - self.started:.3f} s")

    def profile(self, body: Callable[[], int], calls: int) -> None:
        """Run ``body`` (which does ``calls`` forwards or steps and returns
        the stacks they completed over all ranks) under ``torch.profiler``,
        ending in a synchronise, and keep the slice."""
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        with profile(activities=activities) as prof:
            self.sync()
            with record_function("portbench.slice"):
                items = body()
                self.sync()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            events = read_json(Path(path)).get("traceEvents", [])
        finally:
            os.unlink(path)
        del prof
        self.slice = summarize(events, items, calls)


#: trace categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def summarize(events: List[dict], items: int, calls: int) -> Slice:
    """The slice between the ``portbench.slice`` annotation's start and end:
    device kernels, the union of device work (busy), and the idle gaps,
    each named by the innermost host op running when it began."""
    span = next(e for e in events if e.get("name") == "portbench.slice" and e.get("ph") == "X"
                and e.get("cat") in ("user_annotation", "cpu_op"))
    t0, t1 = float(span["ts"]), float(span["ts"]) + float(span["dur"])
    device = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e)
                     for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS),
                    key=lambda d: d[0])
    device = [(max(a, t0), min(b, t1), e) for a, b, e in device if b > t0 and a < t1]
    kernels = [(e["name"], a, b - a) for a, b, e in device if e.get("cat") == "kernel"]
    busy, gaps, cursor = 0.0, [], t0
    for a, b, _ in device:
        if a > cursor:
            gaps.append((cursor, a))
        if b > cursor:
            busy += b - max(a, cursor)
            cursor = b
    if cursor < t1:
        gaps.append((cursor, t1))
    host = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
            for e in events if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "user_annotation")
            and e.get("name") != "portbench.slice"]
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        inner = [h for h in host if h[0] <= a < h[1]]
        label = min(inner, key=lambda h: h[1] - h[0])[2] if inner else "host: no op"
        named.append((label, (b - a) / 1e6))
    return Slice(kernels, busy / 1e6, (t1 - t0) / 1e6, named, items, calls)


def breakdown(s: Slice) -> dict:
    """The ten device ops that took most time and the ten longest idle gaps."""
    by_name: Dict[str, float] = {}
    for name, _, dur in s.kernels:
        by_name[name] = by_name.get(name, 0.0) + dur / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:120], v] for n, v in ops],
            "idle_gaps": [[n[:120], v] for n, v in s.gaps]}


def release() -> None:
    """Give freed device memory back once nothing holds it."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|, in fp32."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))
