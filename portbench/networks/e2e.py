"""The end-to-end network: the program's ``E2ENetwork`` (FlowNetwork aligns
the slices, DFFNet runs on the aligned stack) on hand-held stacks (fs,
focus_dists, fovs); its reference is ``reference/nets.py::e2e``."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench.inputs import focus_dists
from portbench.networks import dffnet
from portbench.reference import nets
from portbench.reference import train as rtrain

SERVED = dffnet.SERVED + ("warped",)
DEPTH = dffnet.DEPTH
WORK: Dict = {}  # its kernels are yardstick.py's
KERNELS: Tuple[str, ...] = ()

INPUT_KEYS = dffnet.INPUT_KEYS + ("fovs",)
TRAIN_HEADS = dffnet.SERVED
reference_loss = rtrain.loss


def probe_inputs(stack: tuple, device) -> List[torch.Tensor]:
    return dffnet.probe_inputs(stack, device) + [torch.ones((1, stack[0]), device=device)]


def specs() -> Dict[str, tuple]:
    return nets.record_specs(nets.e2e, probe_inputs(nets.PROBE_STACK, "cpu"))


def reference(params, inputs, *, train: bool = False):
    return nets.e2e(nets.Ref(params, train=train), *inputs)


def program(config: dict, params: Dict[str, torch.Tensor], device) -> torch.nn.Module:
    """The program's ``E2ENetwork``, its graph as the configuration says."""
    from dffx_torch.models import E2ENetwork

    return dffnet.on_weights(E2ENetwork(bool(config["packed"])), params, device)


def serving_inputs(config: dict, b: int, dtype, dev, gen) -> List[torch.Tensor]:
    """DFFNet's (fs, focus_dists) and the fields of view, fp32, evenly
    spaced over the configuration's range."""
    n = config["stack"][0]
    return dffnet.serving_inputs(config, b, dtype, dev, gen) + [
        focus_dists(b, n, dev, *config["fovs"])]


def train_step_args() -> dict:
    """The program's ``make_train_step`` arguments beside ``lr``,
    ``compute_dtype`` and ``mesh``: the DDFF loss, with the fields of view."""
    from dffx_torch.train import LossConfig

    return {"loss_cfg": LossConfig(), "e2e": True}


def train_extras(config: dict, b: int, dev) -> Dict[str, torch.Tensor]:
    return {"fovs": focus_dists(b, config["train_stack"][0], dev, *config["fovs"])}


def launches(b: int, stack: tuple) -> List[Tuple[str, tuple, tuple]]:
    """DFFNet's three kernels, then FlowNetwork's: one ``rb_of_chain`` a
    feature level and the motion head at full resolution."""
    n, h, w = stack

    def block(cin, cout):
        return ((cout, cin, 1, 3, 3), (cout, cin, 1, 1, 1), (cout, cout, 1, 3, 3))

    return dffnet.launches(b, stack) + [
        ("rb_of_chain", (b, 3, n, h, w), ([block(3, 8), block(8, 8)],)),
        ("rb_of_chain", (b, 16, n, h // 2, w // 2), ([block(16, 16)],)),
        ("rb_of_chain", (b, 32, n, h // 4, w // 4), ([block(32, 32)],)),
        ("motion_head_conv_chain", (b, 18, n, h, w),
         ((16, 18, 1, 3, 3), (16, 16, 1, 3, 3), (16, 16, 1, 3, 3), (3, 16, 1, 3, 3)))]
