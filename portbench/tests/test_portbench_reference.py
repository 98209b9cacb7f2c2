"""The plain reference against the program on the CPU at small sizes: each
network's forward on the benchmark's weights, and the first train steps
(losses, the first gradient, the parameters after three steps)."""

from __future__ import annotations

import pytest
import torch

from portbench import networks
from portbench.drivers import common
from portbench.drivers.train import readings, reference_steps
from portbench.reference import weights

torch.set_num_threads(2)
STACK = (10, 64, 96)


def inputs(network: str, b: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    n, h, w = STACK
    out = [torch.rand((b, n, h, w, 3), generator=g) * 2 - 1,
           torch.linspace(0.2, 7.0, n).expand(b, n).contiguous()]
    if network == "e2e":
        out.append(torch.linspace(1.0, 1.02, n).expand(b, n).contiguous())
    return out


@pytest.mark.parametrize("network", ["dffnet", "e2e"])
def test_specs_are_the_programs_state_dict(network):
    from dffx_torch.models import E2ENetwork, Network

    sd = (E2ENetwork if network == "e2e" else Network)().state_dict()
    specs = networks.load(network).specs()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: s for k, (s, _) in specs.items()}


@pytest.mark.parametrize("network", ["dffnet", "e2e"])
def test_forward_matches_the_program(network):
    net_ref = networks.load(network)
    params = weights.draw(net_ref.specs(), 11, "cpu")
    net = common.program_network({"network": network, "packed": True}, params, "cpu")
    x = inputs(network, 2, 3)
    with torch.no_grad():
        got = net(*x)
        want = net_ref.reference(params, x)
    assert len(got) == len(want) == len(net_ref.SERVED)
    for g, w in zip(got, want):
        assert common.rms_gap(g, w) < 1e-5
        assert float((g - w).abs().max()) < 1e-4 * float(w.abs().max())


def test_weights_follow_the_seed():
    specs = networks.load("dffnet").specs()
    a, b = weights.draw(specs, 2**31 + 5, "cpu"), weights.draw(specs, 2**31 + 5, "cpu")
    c = weights.draw(specs, 2**31 + 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["DFF_net.classif3.0.weight"], c["DFF_net.classif3.0.weight"])


def test_train_steps_match_the_program():
    from dffx_torch.train import LossConfig, create_train_state, make_train_step

    from portbench.drivers.train import followed_steps
    from portbench.inputs import train_batches

    cfg = {"network": "dffnet", "train_stack": [10, 32, 32], "train_focus": [0.0, 1.0]}
    dffnet = networks.load("dffnet")
    start = weights.draw(dffnet.specs(), 21, "cpu")
    batches = train_batches(cfg, 4, 3, "cpu", torch.Generator().manual_seed(4))
    net = common.program_network({"network": "dffnet", "packed": True}, start, "cpu")
    state = create_train_state(net, 1e-4)
    step = make_train_step(1e-4, LossConfig())
    feed = iter([(b, {k: torch.as_tensor(v) for k, v in b.items()}) for b in batches])
    got = followed_steps(state, step, feed, len(dffnet.TRAIN_HEADS))
    want = reference_steps(dffnet, start, batches, 1e-4, "cpu")
    r = readings(start, got, want, {}, slice(0, 4), dffnet.TRAIN_HEADS)
    assert r["loss1"] < 1e-5 and r["loss"] < 1e-3
    assert r["pred3_rms"] < 1e-5
    assert r["grad1"] < 0.05 and r["change"] < 0.05
