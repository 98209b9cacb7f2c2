"""The reader of ``pool_fused_pct.serve``: the program's counters
``stock.pool_fused`` and ``stock.pool_aten`` as a share over the traced
slice, None where neither fired; and a traced bf16 run of DDFFNet's cell on
the CPU at a small size, where every max-pool is applied by the BN-ReLU
pass."""

from __future__ import annotations

import pytest
import torch

from portbench import core, run

torch.set_num_threads(2)
NAME, CELL = "pool_fused_pct.serve", "ddffnet-ddff12.batch-b32"
SMALL = {"config": {"stack": [10, 32, 64]},
         "traffic": {"batch": 2, "pool": 2, "trace_calls": 1, "sample_calls": 1,
                     "sample_rows": 1, "dtype": "bfloat16"}}
SEED = 2**31 + 2609


@pytest.fixture(autouse=True)
def fresh():
    from dffx_torch.utils import profiling

    profiling.reset()
    yield
    profiling.reset()


@pytest.mark.parametrize("counts,want", [
    ({"stock.pool_fused": 5}, 100.0),
    ({"stock.pool_fused": 3, "stock.pool_aten": 2}, 60.0),
    ({"stock.pool_aten": 5}, 0.0),
    ({"stock.bn_fused": 25}, None),
], ids=["all_fused", "some_aten", "no_fused", "neither"])
def test_share_of_the_slices_pools(counts, want):
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


def test_traced_bf16_run_reads_every_pool_fused():
    out = run.result(run.execute(CELL, SEED, 0.3, True, device="cpu", overrides=SMALL))
    assert out["correct"] is True, out["checks"]
    assert out["metrics"][NAME]["value"] == pytest.approx(100.0)
