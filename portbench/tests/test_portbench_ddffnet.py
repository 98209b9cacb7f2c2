"""DDFFNet in the benchmark on the CPU at small sizes: the benchmark's
reference (``reference/ddffnet.py``, five-dimensional, read through
``nets.Ref``) equals the repository's (``tests/ddffnet_reference.py``,
DDFFNet's own 2-D form) on the same weights; its specs are the program's
state dict; the program agrees with it in fp32; the yardstick counts
DDFFNet's 3.17 TFLOP a stack; and the cell's traced run reads every metric it
reports, every 16-bit conv NDHWC."""

from __future__ import annotations

import sys

import pytest
import torch

from portbench import core, networks, run, yardstick
from portbench.drivers import common
from portbench.reference import weights

torch.set_num_threads(2)
CELL = "ddffnet-ddff12.batch-b32"
STACK = (10, 32, 64)
SEED = 2**31 + 613


@pytest.fixture(scope="module")
def ddffnet():
    return networks.load("ddffnet")


@pytest.fixture(scope="module")
def case(ddffnet):
    params = weights.draw(ddffnet.specs(), SEED, "cpu")
    x = ddffnet.serving_inputs({"stack": STACK, "focus": [0.2, 7.0]}, 2, torch.float32, "cpu",
                               torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = ddffnet.reference(params, x)
    return params, x, want


def test_the_two_references_agree(case):
    sys.path.insert(0, str(core.ROOT / "tests"))
    try:
        from ddffnet_reference import DDFFNetReference, reference_state_dict
    finally:
        sys.path.remove(str(core.ROOT / "tests"))
    params, x, want = case
    ref = DDFFNetReference(STACK[0]).eval()
    ref.load_state_dict(reference_state_dict(params, STACK[0]))
    with torch.no_grad():
        got = ref(*x)
    for g, w in zip(got, want):
        assert g.shape == w.shape and common.rms_gap(g, w) < 1e-6


def test_specs_are_the_programs_state_dict(ddffnet):
    from dffx_torch.models import DDFFNet

    sd = DDFFNet().state_dict()
    specs = ddffnet.specs()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: s for k, (s, _) in specs.items()}
    assert {kind[0] for _, kind in specs.values()} == {
        "msra", "default", "bn_weight", "bn_bias", "bn_mean", "bn_var", "count"}
    assert specs[ddffnet.HEAD] == ((1, 64, 1, 3, 3), ("default", 576))
    assert specs["upconv5.weight"] == ((512, 512, 1, 4, 4), ("msra",))
    assert specs[ddffnet.SCORING] == ((1, 10, 1, 1, 1), ("bn_weight",))


def test_the_program_matches_the_reference(ddffnet, case):
    params, x, want = case
    net = common.program_network({"network": "ddffnet", "stack": list(STACK)}, params, "cpu")
    with torch.no_grad():
        got = net(*x)
    assert len(got) == len(want) == len(ddffnet.SERVED)
    for g, w in zip(got, want):
        assert common.rms_gap(g, w) < 1e-5


def test_the_yardstick_counts_the_published_work():
    """3.17 TFLOP a 10 x 384 x 576 stack: 158.6 GMAC a slice, each 3x3 conv
    9 MACs a value, each 4x4 stride-2 upconv 4."""
    assert yardstick.conv_flops_per_stack("ddffnet", (10, 384, 576)) == pytest.approx(
        3.17e12, rel=0.01)
    assert yardstick.forward_bound_s("ddffnet", 32, (10, 384, 576), True) == 0


def test_the_traced_cell_reads_its_metrics():
    """bf16 on the CPU at 10 x 32 x 64, b2: correct, every metric of the
    cell read (the device's shares excepted: no device ran), every conv
    NDHWC and every BN one pass, the concat's bytes a forward as computed."""
    small = {"config": {"stack": list(STACK)},
             "traffic": {"batch": 2, "pool": 2, "trace_calls": 2, "sample_calls": 2}}
    out = run.result(run.execute(CELL, SEED, 0.3, True, device="cpu", overrides=small))
    assert out["correct"] is True, out["checks"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert m["conv_ndhwc_pct.serve"] == 100.0 and m["bn_fused_pct.serve"] == 100.0
    assert {"ddffnet_encode_ms.serve", "ddffnet_decode_ms.serve", "ddffnet_score_ms.serve",
            "enqueue_ms.serve"} <= set(m)
    n, h, w = STACK
    assert m["ddffnet_concat_mb.serve"] == pytest.approx(2 * 512 * n * h * w / 16 * 2 / 1e6)
