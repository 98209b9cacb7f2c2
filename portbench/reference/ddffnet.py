"""The plain reference of DDFFNet: Hazirbas, Soyer, Staab, Leal-Taixé,
Cremers, "Deep Depth From Focus", ACCV 2018 (arXiv:1704.01085;
github.com/soyers/ddff-pytorch), the CC3 variant, its eval forward in plain
fp32 PyTorch: a VGG-16-BN encoder run on each slice alone, its mirrored
decoder with 4x4 stride-2 upconvs, one skip connection at 1/4 (CC3), and a
1x1 conv fusing the N per-slice maps into the depth.  It reads the
benchmark's weights through ``nets.Ref`` (``record_specs``,
``weights.draw``: every conv and upconv MSRA, N(0, sqrt(2 / (prod(k) *
Cout))); each upconv has as many input channels as output ones, so
``weights.py``'s reading of a weight's first axis as Cout holds), imports
nothing of the program, and runs with TF32 off (``drivers/common.py::
serving_checks`` turns it off before any reference forward).

Departures from the published code:

* form only: the per-slice 2-D network runs as ``(1, k, k)`` 3-D convs,
  deconvs and pools on ``(B, C, N, H, W)``, not as 2-D ops over the B * N
  slices, and the scoring conv as a 1x1x1 conv over the maps with N as its
  channels: the same sums, kept five-dimensional so that the fp8 control
  (``lowp.fp8``) rounds every activation; its 2-D weights are therefore
  ``(Cout, Cin, 1, kh, kw)`` and ``(Cin, Cout, 1, 4, 4)``;
* the items the configuration lists under ``assumed``, none checked against
  github.com/soyers/ddff-pytorch: the layer names, every conv bias-free, no
  BN and no ReLU after an upconv, the upsampled tensor first in the CC3
  concat, BN's eps 1e-5, CC3 the only skip;
* dropout, the identity in eval, is left out.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from portbench.reference.nets import Ref

#: (conv, Cout) of each encoder stage; a 2x2 max-pool ends each
ENCODER = (
    (("conv1_1", 64), ("conv1_2", 64)),
    (("conv2_1", 128), ("conv2_2", 128)),
    (("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256)),
    (("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512)),
    (("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512)),
)
#: (upconv, its convs as (conv, Cout)) of each decoder stage from 1/32 up
DECODER = (
    ("upconv5", (("conv5_3_D", 512), ("conv5_2_D", 512), ("conv5_1_D", 512))),
    ("upconv4", (("conv4_3_D", 512), ("conv4_2_D", 512), ("conv4_1_D", 256))),
    ("upconv3", (("conv3_3_D", 256), ("conv3_2_D", 256), ("conv3_1_D", 128))),
    ("upconv2", (("conv2_2_D", 128), ("conv2_1_D", 64))),
    ("upconv1", (("conv1_2_D", 64),)),
)
#: a stack whose forward reaches every layer: H and W multiples of 32
PROBE_STACK = (10, 32, 32)


def _c3(r: Ref, x, name, cout):
    """A 3x3 conv (no bias) of each slice, its BN ``<name>_bn``, ReLU."""
    return torch.relu(r.bn(r.conv(x, name, cout, (1, 3, 3), padding=(0, 1, 1)), f"{name}_bn"))


def _upconv(r: Ref, x, name):
    """A 4x4 stride-2 deconv of each slice, pad 1, no bias: H and W doubled."""
    c = x.shape[1]
    w = r.w(f"{name}.weight", (c, c, 1, 4, 4), ("msra",))
    return F.conv_transpose3d(x, w, stride=(1, 2, 2), padding=(0, 1, 1))


def ddffnet(r: Ref, fs, focus_dists) -> Tuple[torch.Tensor, torch.Tensor]:
    """fs ``(B, N, H, W, 3)`` -> (pred ``(B, H, W)``, maps ``(B, N, H,
    W)``); the focus distances are not read."""
    r.msra = True
    x = fs.permute(0, 4, 1, 2, 3)
    for i, stage in enumerate(ENCODER):
        for name, cout in stage:
            x = _c3(r, x, name, cout)
        if i == 2:
            e3 = x
        x = F.max_pool3d(x, (1, 2, 2))
    for up, stage in DECODER:
        x = _upconv(r, x, up)
        if up == "upconv3":
            x = torch.cat([x, e3], dim=1)
        for name, cout in stage:
            x = _c3(r, x, name, cout)
    maps = r.conv(x, "conv1_1_D", 1, (1, 3, 3), padding=(0, 1, 1))  # (B, 1, N, H, W)
    pred = r.conv(maps.transpose(1, 2), "scoring", 1, 1)  # N as the channels
    return pred[:, 0, 0], maps[:, 0]
