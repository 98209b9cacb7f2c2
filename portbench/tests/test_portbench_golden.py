"""What the harness reads for DFFNet and E2E, held bit-equal to a golden
that the harness computed before its networks became modules of
``portbench/networks`` (``golden_networks.json``, on the CPU at one
thread): the weights' specs and their draw, the serving inputs and train
batches of seeds 0 and 1 at a small size, the reference's outputs at
10x32x32 and one reference train step of DFFNet, the convolution FLOPs of
each configuration's stacks, and each serving cell's kernel launches and
their least time.  E2E's train batches now also carry the fields of view,
which its forward reads; the keys the golden holds are compared."""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import pytest
import torch

from portbench import core, networks, yardstick
from portbench.inputs import serving_inputs, train_batches
from portbench.reference import train as rtrain
from portbench.reference import weights

GOLDEN = json.loads((Path(__file__).parent / "golden_networks.json").read_text())
SMALL = [10, 32, 32]
SEEDS = (0, 1)
CONFIGS = {"dffnet": "dffnet-ddff12", "e2e": "e2e-wild"}


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        t = torch.as_tensor(t).detach().cpu().contiguous()
        h.update(f"{t.dtype}{tuple(t.shape)}".encode())
        h.update((t.float() if t.dtype == torch.bfloat16 else t).numpy().tobytes())
    return h.hexdigest()


def specs_digest(specs) -> str:
    rows = [[k, list(shape), list(kind)] for k, (shape, kind) in specs.items()]
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()


@pytest.fixture(autouse=True)
def one_thread():
    """The golden's sums were taken on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def config(network: str) -> dict:
    return core.read_json(core.PACKAGE / "configs" / f"{CONFIGS[network]}.json")


def small(network: str) -> dict:
    return {**config(network), "stack": SMALL, "train_stack": SMALL}


@pytest.mark.parametrize("network", list(CONFIGS))
def test_specs_and_weights(network):
    specs = networks.load(network).specs()
    want = GOLDEN[network]
    assert {"count": len(specs), "sha256": specs_digest(specs)} == want["specs"]
    assert digest(weights.draw(specs, 0, "cpu").values()) == want["weights"]


@pytest.mark.parametrize("network", list(CONFIGS))
@pytest.mark.parametrize("seed", SEEDS)
def test_inputs(network, seed):
    want = GOLDEN[network]
    for dtype in (torch.float32, torch.bfloat16):
        gen = weights.generator(seed, "inputs", "cpu")
        got = digest(serving_inputs(small(network), 2, dtype, "cpu", gen))
        assert got == want[f"serving_inputs.{seed}.{dtype}"], dtype
    batches = train_batches(small(network), 4, 2, "cpu", weights.generator(seed, "inputs", "cpu"))
    keys = want[f"train_batches.{seed}.keys"]
    assert list(batches[0])[:len(keys)] == keys
    assert digest(b[k] for b in batches for k in keys) == want[f"train_batches.{seed}"]


@pytest.mark.parametrize("network", list(CONFIGS))
def test_reference(network):
    net = networks.load(network)
    params = weights.draw(net.specs(), 0, "cpu")
    x = serving_inputs(small(network), 1, torch.float32, "cpu",
                       weights.generator(0, "inputs", "cpu"))
    with torch.no_grad():
        assert digest(net.reference(params, x)) == GOLDEN[network]["reference"]


def test_reference_train_step():
    net = networks.load("dffnet")
    params = weights.draw(net.specs(), 0, "cpu")
    batch = train_batches(small("dffnet"), 2, 1, "cpu", weights.generator(0, "inputs", "cpu"))[0]
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss, grads, heads = rtrain.step(net, params, batch, rtrain.Adam(1e-4))
    got = {"loss": loss, "grads": digest(grads.values()), "heads": digest(heads),
           "after": digest(params.values())}
    assert got == GOLDEN["dffnet"]["reference_train_step"]


@pytest.mark.parametrize("network", list(CONFIGS))
def test_yardstick(network):
    want = GOLDEN[network]
    got = {k: yardstick.conv_flops_per_stack(network, tuple(config(network)[k]))
           for k in ("stack", "train_stack")}
    assert got == want["conv_flops"]
    bounds, launches = {}, {}
    for w in json.loads(core.BENCHMARK.read_text())["workloads"]:
        cell = core.load_cell(w["name"])
        if cell.config["network"] != network or cell.traffic["driver"].startswith("train"):
            continue
        b, stack = int(cell.traffic["batch"]), tuple(cell.config["stack"])
        bounds[w["name"]] = yardstick.forward_bound_s(network, b, stack,
                                                      cell.traffic["dtype"] == "bfloat16")
        launches[w["name"]] = json.loads(json.dumps(networks.load(network).launches(b, stack)))
    assert bounds == want["forward_bound_s"] and launches == want["launches"]
    # the kernels a cell counts as the program's own, and their work: the five
    assert yardstick.port_kernels(network) == yardstick.PORT_KERNELS
    assert yardstick.work(network) == yardstick.WORK
