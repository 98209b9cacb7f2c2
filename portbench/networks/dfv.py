"""DFV: the program's ``DFV`` (Yang et al., CVPR 2022) on DDFF-style stacks
(fs, focus_dists), serving the depth, its standard deviation and the 1/4
cost they come from; its reference is ``reference/dfv.py``.  It launches
none of the program's hand kernels (cuDNN and ATen run all of it) and has no
training cell.

The weights stand in for trained ones.  Every conv is drawn as DFV's init
draws it, N(0, sqrt(2 / (prod(k) * Cout))), but the last conv of the head
(``HEAD``), whose Cout is 1.  Drawn so, its 864 products give a cost about
eight times the features' scale, the softmax over N becomes an argmax, and
bf16 rounding moves a pixel's depth by a whole slice, as far as a wrong
answer would.  A trained head gives a spread-out softmax (the spread is
DFV's uncertainty).  Here the head is drawn U(+-1 / (4 sqrt(fan_in))), a
quarter of torch's default bound: at the default bound itself some seeds'
costs still spread by a few logits, and rounding moved their depth maps
five times as far as other seeds' (PERF.md); at a quarter the
softmax stays near its linear range on every seed.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from portbench.networks import dffnet
from portbench.reference import dfv as rdfv
from portbench.reference import nets

SERVED = ("pred3", "std3", "cost3")
DEPTH = 0
WORK: Dict = {}
KERNELS: Tuple[str, ...] = ()
#: the head's last conv, drawn at a quarter of torch's default bound
HEAD = "decoder3.classify.2.0.weight"
HEAD_SCALE = 0.25

probe_inputs = dffnet.probe_inputs
serving_inputs = dffnet.serving_inputs


def specs() -> Dict[str, tuple]:
    out = nets.record_specs(rdfv.dfv, probe_inputs(rdfv.PROBE_STACK, "cpu"))
    shape, _ = out[HEAD]
    # ("default", fan) draws U(+-1 / sqrt(fan)): the fan scaled to shrink the bound
    out[HEAD] = (shape, ("default", math.prod(shape[1:]) / HEAD_SCALE ** 2))
    return out


def reference(params, inputs, *, train: bool = False):
    return rdfv.dfv(nets.Ref(params, train=train), *inputs)


def program(config: dict, params: Dict[str, torch.Tensor], device) -> torch.nn.Module:
    """The program's ``DFV`` on the benchmark's weights, in eval mode."""
    from dffx_torch.models import DFV

    return dffnet.on_weights(DFV(), params, device)


def launches(b: int, stack: tuple) -> List[Tuple[str, tuple, tuple]]:
    return []
