"""What the traffic drivers share: the program's network built on the
benchmark's weights, a seeded sample of the window's answers, and the
comparison of served outputs with the plain reference.  The network is the
module of ``portbench/networks`` that the configuration names."""

from __future__ import annotations

import random
from typing import Dict, List, Sequence

import torch

from portbench import networks
from portbench.core import Run, rel_gap
from portbench.reference import lowp, weights

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def network(r: Run):
    """The module of the cell's network (``portbench/networks``)."""
    return networks.load(r.cell.config["network"])


def draw_weights(r: Run) -> Dict[str, torch.Tensor]:
    """The benchmark's weights for the cell's network, on the run's device."""
    return weights.draw(network(r).specs(), r.seed, r.device)


def program_network(config: dict, params: Dict[str, torch.Tensor], device):
    """The program's module of the configuration's network with the
    benchmark's weights, on ``device``, in eval mode."""
    return networks.load(config["network"]).program(config, params, device)


def program_device(r: Run) -> None:
    """The program's command lines turn TF32 off on the card."""
    if r.cuda:
        from dffx_torch.eval.common import cli_device

        cli_device(str(r.device))


def nonfinite(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """1 on the device when any element of ``tensors`` is not finite (no sync)."""
    return torch.stack([~torch.isfinite(t).all() for t in tensors]).any().int()


class Sample:
    """A uniform sample, drawn from the seed, of ``size`` of the window's
    answers (reservoir sampling): ``offer`` each answer as it is produced."""

    def __init__(self, seed: int, size: int):
        self.rng = random.Random(weights.stream_seed(seed, "sample"))
        self.size, self.seen = size, 0
        self.kept: List = []

    def offer(self, item) -> None:
        if len(self.kept) < self.size:
            self.kept.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.size:
                self.kept[j] = item
        self.seen += 1


def serving_checks(r: Run, rows: List[tuple]) -> None:
    """Hold each served output of ``rows`` ((inputs, outputs), one stack
    each, on the device) to the plain reference in fp32 on the same inputs,
    one stack at a time: each output's largest gap over the reference's
    largest value (``<out>_max``) and its root-mean-square gap over the
    reference's (``<out>_rms``), the worst over the rows.  With
    ``r.control`` the reference one precision below the cell's
(``lowp.control``) is read the same way."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    net = network(r)
    params = draw_weights(r)
    with torch.inference_mode():
        for inputs, outputs in rows:
            inputs = [t.float() for t in inputs]
            want = net.reference(params, inputs)
            _worst(r.checks, net.SERVED, outputs, want)
            if r.control:
                with lowp.control(r.cell.traffic["dtype"]):
                    low = net.reference(params, inputs)
                _worst(r.control_checks, net.SERVED, low, want)


def rms_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The root mean square of got - want over the root mean square of want."""
    got, want = got.float(), want.float()
    return float((got - want).square().mean().sqrt() / want.square().mean().sqrt().clamp(min=1e-30))


def _worst(into: Dict[str, float], served: Sequence[str], got, want) -> None:
    for name, g, w in zip(served, got, want):
        for key, value in ((f"{name}_max", rel_gap(g, w)), (f"{name}_rms", rms_gap(g, w))):
            into[key] = max(into.get(key, 0.0), value)
