"""The readers of the program's spans and counters on the CPU at the small
sizes of ``test_portbench_run.py``: a traced run of each cell prints every
metric of the cell that reads them, and none is None; an untraced run and a
program without spans read None."""

from __future__ import annotations

import json

import pytest
import torch

from portbench import core, program_spans, run

torch.set_num_threads(2)
BENCH = json.loads(core.BENCHMARK.read_text())
CELLS = ["dffnet-ddff12.batch-b32", "e2e-wild.single-b1", "dffnet-ddff12.train-b32-fp32"]
SMALL = {"config": {"stack": [10, 64, 96], "train_stack": [10, 32, 32]},
         "traffic": {"pool": 3, "trace_calls": 2, "sample_calls": 2, "dtype": "float32"}}
SEED = 2**31 + 977


def small(cell: str) -> dict:
    batch = 4 if "train" in cell else (1 if "single" in cell else 2)
    return {"config": SMALL["config"], "traffic": {**SMALL["traffic"], "batch": batch}}


def reads_spans(cell: str) -> list:
    """The cell's per-layer metrics whose readers read the program's spans
    and counters."""
    return [m["name"] for m in core.load_cell(cell).per_layer
            if "program_spans" in (core.PACKAGE / "metrics" / f"{m['name']}.py").read_text()]


@pytest.fixture(autouse=True)
def fresh():
    from dffx_torch.utils import profiling

    profiling.reset()
    yield
    profiling.reset()


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_prints_every_span_metric(cell):
    names = reads_spans(cell)
    assert len(names) == {"dffnet-ddff12.batch-b32": 4, "e2e-wild.single-b1": 5,
                          "dffnet-ddff12.train-b32-fp32": 4}[cell]
    out = run.result(run.execute(cell, SEED, 0.5, True, device="cpu", overrides=small(cell)))
    missing = [n for n in names if out["metrics"].get(n, {}).get("value") is None]
    assert not missing, (missing, out["metrics"])
    spans = [n for n in names if n != "stage_in_mb.latency"]
    assert all(out["metrics"][n]["value"] > 0 for n in spans)
    if cell == "e2e-wild.single-b1":  # host inputs on a model on the host: nothing crosses
        assert out["metrics"]["stage_in_mb.latency"]["value"] == 0


def test_untraced_run_and_older_program_read_none(monkeypatch):
    cell = "dffnet-ddff12.batch-b32"
    r = run.execute(cell, SEED, 0.3, False, device="cpu", overrides=small(cell))
    assert all(core.metric_reader(n)(r) is None for n in reads_spans(cell))
    r.slice = core.Slice([], 1.0, 1.0, [], 2, 1)
    monkeypatch.setattr(program_spans, "_recorded", lambda: None)
    assert all(core.metric_reader(n)(r) is None for n in reads_spans(cell))


def test_each_traced_run_reads_its_own_slice():
    """Two traced runs in one process: the first reading of each takes the
    program's totals and clears them, so the second run reads only its own
    slice, and a run read again reads the same."""
    from dffx_torch.utils import profiling

    cell = "dffnet-ddff12.batch-b32"
    loaded = core.load_cell(cell, small(cell))
    readings = []
    for forwards in (3, 1):
        r = core.Run(loaded, SEED, 0.1, True, "cpu")
        with profiling.collect():
            for _ in range(forwards):
                with profiling.span("serve.forward", "cpu"):
                    profiling.count("serve.staged_bytes", 10)
        r.slice = core.Slice([], 1.0, 1.0, [], 2 * forwards, forwards)
        first = program_spans.counter_per_call(r, "serve.staged_bytes")
        assert profiling.spans() == {} and profiling.counters() == {}
        assert program_spans.counter_per_call(r, "serve.staged_bytes") == first
        assert program_spans.span_ms(r, "serve.forward", "host", "call") > 0
        readings.append(first)
    assert readings == [10, 10]
