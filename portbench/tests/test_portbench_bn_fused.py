"""The reader of ``bn_fused_pct.*``: the program's counters
``stock.bn_fused`` and ``stock.bn_aten`` as a share over the traced slice,
None where neither fired; and a traced bf16 run of each cell on the CPU at a
small size, where every eval BN takes the program's one pass."""

from __future__ import annotations

import pytest
import torch

from portbench import core, run

torch.set_num_threads(2)
CELLS = {"bn_fused_pct.serve": "dffnet-ddff12.batch-b32",
         "bn_fused_pct.latency": "e2e-wild.single-b1"}
SMALL = {"config": {"stack": [10, 64, 96]},
         "traffic": {"pool": 2, "trace_calls": 1, "sample_calls": 1, "sample_rows": 1,
                     "batch": 1, "dtype": "bfloat16"}}
SEED = 2**31 + 2207


@pytest.fixture(autouse=True)
def fresh():
    from dffx_torch.utils import profiling

    profiling.reset()
    yield
    profiling.reset()


@pytest.mark.parametrize("name", list(CELLS))
@pytest.mark.parametrize("counts,want", [
    ({"stock.bn_fused": 110}, 100.0),
    ({"stock.bn_fused": 110, "stock.bn_aten": 20}, 100.0 * 110 / 130),
    ({"stock.bn_aten": 20}, 0.0),
    ({}, None),
], ids=["all_fused", "some_aten", "no_fused", "neither"])
def test_share_of_the_slices_bns(name, counts, want):
    from dffx_torch.utils import profiling

    r = core.Run(core.load_cell(CELLS[name], SMALL), SEED, 0.1, True, "cpu")
    with profiling.collect():
        for counter, n in counts.items():
            profiling.count(counter, n)
    r.slice = core.Slice([], 1.0, 1.0, [], 2, 2)
    got = core.metric_reader(name)(r)
    assert got == pytest.approx(want) if want is not None else got is None


@pytest.mark.parametrize("name", list(CELLS))
def test_untraced_run_reads_none(name):
    r = core.Run(core.load_cell(CELLS[name], SMALL), SEED, 0.1, False, "cpu")
    assert core.metric_reader(name)(r) is None


@pytest.mark.parametrize("name", list(CELLS))
def test_traced_bf16_run_reads_every_bn_fused(name):
    out = run.result(run.execute(CELLS[name], SEED, 0.3, True, device="cpu", overrides=SMALL))
    assert out["metrics"][name]["value"] == pytest.approx(100.0)
