"""DDFFNet: the program's ``DDFFNet`` (Hazirbas et al., ACCV 2018) on
DDFF-style stacks (fs, focus_dists), serving the depth and the N per-slice
maps it fuses; its reference is ``reference/ddffnet.py``.  It launches none
of the program's hand kernels (cuDNN and ATen run all of it, with the BN
pass after each conv) and has no training cell.

The weights stand in for trained ones, which the repository does not hold
(the published encoder starts from ImageNet's VGG-16): every conv and upconv
is drawn MSRA, N(0, sqrt(2 / (prod(k) * Cout))), BatchNorm away from the
identity (``reference/weights.py``), but two keys:

* the last conv (``HEAD``, 64 -> 1), drawn at torch's default bound
  U(+-1 / sqrt(576)), about 20 times under MSRA's N(0, sqrt(2 / 9)): the
  maps and the depth then lie in the range of the focus distances, as a
  trained DDFFNet's depth does, and a depth map moved by a twentieth of
  that range (``faults.py``'s ``answer``) stands well above bf16's rounding
  (0.19 and 0.22 against a limit of 0.033, on an H100); drawn MSRA, the
  depth's rms is 25 to 40 and such a move, 1 % of it, passed as correct;
* the fusion (``SCORING``), drawn U[0.8, 1.2), the range ``weights.py``
  draws a BatchNorm weight from, as a trained fusion averages the slices'
  maps.  Drawn MSRA, its N weights take both signs and cancel the part the
  maps share, so that bf16 rounding moved the depth by 0.0099 to 0.0793 of
  its rms from seed to seed on an H100, against 0.199 and more for the fp8
  control: no fixed limit sat between the two with room (PERF.md §4).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from portbench.networks import dffnet
from portbench.reference import ddffnet as rddffnet
from portbench.reference import nets

SERVED = ("pred", "maps")
DEPTH = 0
WORK: Dict = {}
KERNELS: Tuple[str, ...] = ()
#: the last conv's weight, drawn at torch's default bound
HEAD = "conv1_1_D.weight"
#: the fusion's weight, drawn U[0.8, 1.2) (``weights.BN_RANGES["bn_weight"]``)
SCORING = "scoring.weight"

probe_inputs = dffnet.probe_inputs
serving_inputs = dffnet.serving_inputs


def specs() -> Dict[str, tuple]:
    out = nets.record_specs(rddffnet.ddffnet, probe_inputs(rddffnet.PROBE_STACK, "cpu"))
    shape, _ = out[HEAD]
    out[HEAD] = (shape, ("default", math.prod(shape[1:])))
    out[SCORING] = (out[SCORING][0], ("bn_weight",))
    return out


def reference(params, inputs, *, train: bool = False):
    return rddffnet.ddffnet(nets.Ref(params, train=train), *inputs)


def program(config: dict, params: Dict[str, torch.Tensor], device) -> torch.nn.Module:
    """The program's ``DDFFNet`` on the benchmark's weights, in eval mode,
    its fusion as wide as the configuration's stack is deep."""
    from dffx_torch.models import DDFFNet

    return dffnet.on_weights(DDFFNet(int(config["stack"][0])), params, device)


def launches(b: int, stack: tuple) -> List[Tuple[str, tuple, tuple]]:
    return []
