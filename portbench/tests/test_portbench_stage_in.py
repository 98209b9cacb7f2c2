"""The reader of ``stage_in_pinned_pct.latency``: the program's counters
``serve.staged_pinned`` over ``serve.staged_bytes`` in the traced slice,
None where nothing was staged or the program lacks the pinned counter; and
a traced run of the cell on the CPU, where nothing crosses to a card."""

from __future__ import annotations

import pytest
import torch

from portbench import core, run

torch.set_num_threads(2)
NAME, CELL = "stage_in_pinned_pct.latency", "e2e-wild.single-b1"
SMALL = {"config": {"stack": [10, 64, 96]},
         "traffic": {"pool": 2, "trace_calls": 1, "sample_calls": 1, "sample_rows": 1}}
SEED = 2**31 + 2411
MB = 39_690_000


@pytest.fixture(autouse=True)
def fresh():
    from dffx_torch.utils import profiling

    profiling.reset()
    yield
    profiling.reset()


@pytest.mark.parametrize("counts,want", [
    ({"serve.staged_bytes": MB, "serve.staged_pinned": MB}, 100.0),
    ({"serve.staged_bytes": MB, "serve.staged_pinned": MB // 4}, 25.0),
    ({"serve.staged_bytes": MB, "serve.staged_pinned": 0}, 0.0),
    ({"serve.staged_bytes": 0, "serve.staged_pinned": 0}, None),
    ({"serve.staged_bytes": MB}, None),
    ({}, None),
], ids=["all_pinned", "a_quarter", "none_pinned", "nothing_staged", "no_pinned_counter",
        "neither"])
def test_share_of_the_staged_bytes(counts, want):
    from dffx_torch.utils import profiling

    r = core.Run(core.load_cell(CELL, SMALL), SEED, 0.1, True, "cpu")
    with profiling.collect():
        for counter, n in counts.items():
            profiling.count(counter, n)
    r.slice = core.Slice([], 1.0, 1.0, [], 2, 2)
    got = core.metric_reader(NAME)(r)
    assert got == pytest.approx(want) if want is not None else got is None


def test_untraced_run_reads_none():
    r = core.Run(core.load_cell(CELL, SMALL), SEED, 0.1, False, "cpu")
    assert core.metric_reader(NAME)(r) is None


def test_traced_cpu_run_leaves_the_metric_out():
    """On the CPU the model and its inputs share a device: nothing is staged,
    so the line leaves the share out, as it does on a program without the
    pinned counter."""
    out = run.result(run.execute(CELL, SEED, 0.3, True, device="cpu", overrides=SMALL))
    assert NAME not in out["metrics"] and "stage_in_mb.latency" in out["metrics"]
