"""DFV in the benchmark on the CPU at small sizes: the benchmark's reference
(``reference/dfv.py``, five-dimensional, read through ``nets.Ref``) equals
the repository's (``tests/dfv_reference.py``, DFV's own form) on the same
weights; its specs are the program's state dict; the program agrees with it
in fp32; and the cell's traced run reads every metric it reports, every
16-bit conv NDHWC."""

from __future__ import annotations

import sys

import pytest
import torch

from portbench import core, networks, run
from portbench.drivers import common
from portbench.reference import weights

torch.set_num_threads(2)
CELL = "dfv-ddff12.batch-b32"
STACK = (10, 64, 96)
SEED = 2**31 + 613


@pytest.fixture(scope="module")
def dfv():
    return networks.load("dfv")


@pytest.fixture(scope="module")
def case(dfv):
    params = weights.draw(dfv.specs(), SEED, "cpu")
    x = dfv.serving_inputs({"stack": STACK, "focus": [0.2, 7.0]}, 2, torch.float32, "cpu",
                           torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = dfv.reference(params, x)
    return params, x, want


def test_the_two_references_agree(case):
    sys.path.insert(0, str(core.ROOT / "tests"))
    try:
        from dfv_reference import DFVReference, reference_state_dict
    finally:
        sys.path.remove(str(core.ROOT / "tests"))
    params, x, want = case
    ref = DFVReference().eval()
    ref.load_state_dict(reference_state_dict(params))
    with torch.no_grad():
        got = ref(*x)
    for g, w in zip(got, want):
        assert common.rms_gap(g, w) < 1e-6


def test_specs_are_the_programs_state_dict(dfv):
    from dffx_torch.models import DFV

    sd = DFV().state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: s for k, (s, _) in
                                                          dfv.specs().items()}
    specs = dfv.specs()
    assert {kind[0] for _, kind in specs.values()} == {
        "msra", "default", "bias", "bn_weight", "bn_bias", "bn_mean", "bn_var", "count"}
    assert [k for k, (_, kind) in specs.items() if kind[0] == "default"] == [dfv.HEAD]
    assert specs[dfv.HEAD] == ((1, 32, 3, 3, 3), ("default", 16 * 32 * 27))


def test_the_program_matches_the_reference(dfv, case):
    params, x, want = case
    net = common.program_network({"network": "dfv"}, params, "cpu")
    with torch.no_grad():
        got = net(*x)
    assert len(got) == len(want) == len(dfv.SERVED)
    for g, w in zip(got, want):
        assert common.rms_gap(g, w) < 1e-4


def test_the_traced_cell_reads_its_metrics():
    """bf16 on the CPU at 10 x 64 x 96, b2: correct, every metric of the
    cell read (the device's shares excepted: no device ran), every conv
    NDHWC, the volumes' bytes a forward as computed."""
    small = {"config": {"stack": list(STACK)},
             "traffic": {"batch": 2, "pool": 2, "trace_calls": 2, "sample_calls": 2}}
    out = run.result(run.execute(CELL, SEED, 0.3, True, device="cpu", overrides=small))
    assert out["correct"] is True, out["checks"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert m["conv_ndhwc_pct.serve"] == 100.0
    assert {"dfv_features_ms.serve", "dfv_volume_ms.serve", "dfv_decode_ms.serve",
            "dfv_regress_ms.serve", "enqueue_ms.serve"} <= set(m)
    n, h, w = STACK
    assert m["dfv_volume_mb.serve"] == pytest.approx(
        2 * 2 * n * h * w * (16 / 16 + 32 / 64 + 64 / 256 + 128 / 1024) / 1e6)
