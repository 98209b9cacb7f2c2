"""DFFNet: the program's ``Network`` on DDFF-style stacks (fs, focus_dists);
its reference is ``reference/nets.py::dffnet``."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench.inputs import focus_dists, uniform
from portbench.reference import nets
from portbench.reference import train as rtrain

SERVED = ("mid", "pred1", "pred2", "pred3")
DEPTH = 3
WORK: Dict = {}  # its kernels are yardstick.py's
KERNELS: Tuple[str, ...] = ()

INPUT_KEYS = ("fs", "focus_dists")
TRAIN_HEADS = SERVED
reference_loss = rtrain.loss


def probe_inputs(stack: tuple, device) -> List[torch.Tensor]:
    n, h, w = stack
    return [torch.zeros((1, n, h, w, 3), device=device), torch.ones((1, n), device=device)]


def specs() -> Dict[str, tuple]:
    return nets.record_specs(nets.dffnet, probe_inputs(nets.PROBE_STACK, "cpu"))


def reference(params, inputs, *, train: bool = False):
    return nets.dffnet(nets.Ref(params, train=train), *inputs)


def on_weights(net: torch.nn.Module, params: Dict[str, torch.Tensor], device) -> torch.nn.Module:
    """``net`` on ``device`` with the benchmark's weights, in eval mode."""
    net = net.to(device)
    net.load_state_dict(params)
    return net.eval()


def program(config: dict, params: Dict[str, torch.Tensor], device) -> torch.nn.Module:
    """The program's ``Network``, its graph as the configuration says."""
    from dffx_torch.models import Network

    return on_weights(Network(bool(config["packed"])), params, device)


def serving_inputs(config: dict, b: int, dtype, dev, gen) -> List[torch.Tensor]:
    """(fs, focus_dists): fs ``(B, N, H, W, 3)`` in ``dtype``, focus
    distances fp32."""
    n, h, w = config["stack"]
    return [uniform((b, n, h, w, 3), dtype, dev, gen), focus_dists(b, n, dev, *config["focus"])]


def train_step_args() -> dict:
    """The program's ``make_train_step`` arguments beside ``lr``,
    ``compute_dtype`` and ``mesh``: the DDFF loss."""
    from dffx_torch.train import LossConfig

    return {"loss_cfg": LossConfig(), "e2e": False}


def train_extras(config: dict, b: int, dev) -> Dict[str, torch.Tensor]:
    return {}


def launches(b: int, stack: tuple) -> List[Tuple[str, tuple, tuple]]:
    """The focus-measure chain's three kernels."""
    n, h, w = stack
    return [("fm_conv_bn_relu", (b, 3, n, h, w), ((8, 3, 1, 9, 9),)),
            ("rb2d_residual", (b, 8, n, h, w), ((8, 8, 1, 3, 3), (8, 8, 1, 3, 3))),
            ("srd_attention_residual", (b, 8, n, h, w), ((8, 8, 3, 1, 1), (8, 8, 1, 1, 1)))]
