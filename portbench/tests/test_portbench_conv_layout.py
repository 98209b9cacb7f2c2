"""The reader of ``conv_ndhwc_pct.*``: the program's counters
``stock.conv_ndhwc`` and ``stock.conv_ncdhw`` as a share over the traced
slice, None where neither fired; and a traced bf16 run of each cell on the
CPU at a small size, where DFFNet's stock convs run NDHWC and FlowNetwork's
NCDHW."""

from __future__ import annotations

import pytest
import torch

from portbench import core, run

torch.set_num_threads(2)
CELLS = {"conv_ndhwc_pct.serve": "dffnet-ddff12.batch-b32",
         "conv_ndhwc_pct.latency": "e2e-wild.single-b1"}
SMALL = {"config": {"stack": [10, 64, 96]},
         "traffic": {"pool": 2, "trace_calls": 1, "sample_calls": 1, "sample_rows": 1,
                     "batch": 1, "dtype": "bfloat16"}}
SEED = 2**31 + 1913


@pytest.fixture(autouse=True)
def fresh():
    from dffx_torch.utils import profiling

    profiling.reset()
    yield
    profiling.reset()


@pytest.mark.parametrize("name", list(CELLS))
@pytest.mark.parametrize("counts,want", [
    ({"stock.conv_ndhwc": 130}, 100.0),
    ({"stock.conv_ndhwc": 130, "stock.conv_ncdhw": 28}, 100.0 * 130 / 158),
    ({"stock.conv_ncdhw": 28}, 0.0),
    ({}, None),
], ids=["all_ndhwc", "some_ncdhw", "no_ndhwc", "neither"])
def test_share_of_the_slices_convs(name, counts, want):
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


@pytest.mark.parametrize("name,want", [("conv_ndhwc_pct.serve", 100.0),
                                       ("conv_ndhwc_pct.latency", 100.0 * 65 / 79)])
def test_traced_bf16_run_reads_the_share(name, want):
    """DFFNet's 65 stock convs and deconvs a forward NDHWC; E2E adds
    FlowNetwork's 14, NCDHW."""
    out = run.result(run.execute(CELLS[name], SEED, 0.3, True, device="cpu", overrides=SMALL))
    assert out["metrics"][name]["value"] == pytest.approx(want)
