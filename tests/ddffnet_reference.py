"""DDFFNet's eval forward in plain fp32 PyTorch, the reference the port's
``dffx_torch/models/ddffnet.py`` is held to: Hazirbas, Soyer, Staab,
Leal-Taixé, Cremers, "Deep Depth From Focus", ACCV 2018 (arXiv:1704.01085;
github.com/soyers/ddff-pytorch), the CC3 variant: a VGG-16-BN encoder, its
mirrored decoder with 4x4 stride-2 upconvs, one skip connection at 1/4, and
a 1x1 conv fusing the N per-slice maps into the depth.

It imports nothing of the port and nothing of JAX, keeps no derived weight,
and turns TF32 off for its forward.  As DDFFNet, it runs each slice alone on
``(B * N, 3, H, W)`` with ``F.conv2d``, ``F.batch_norm`` (eval),
``F.relu``, ``F.max_pool2d``, ``F.conv_transpose2d`` and ``torch.cat``,
then the scoring conv over the N maps, so its state_dict has DDFFNet's
names and 2-D shapes.

Departures from the published code, none checked against
github.com/soyers/ddff-pytorch (the configuration's ``assumed``): the layer
names; every conv bias-free; no BN and no ReLU after an upconv; the concat
of CC3 puts the upsampled tensor first; BN's eps 1e-5; CC3 the only skip.
Dropout, the identity in eval, is left out.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

#: (conv, Cin, Cout) of each encoder stage; a 2x2 max-pool ends each
ENCODER = (
    (("conv1_1", 3, 64), ("conv1_2", 64, 64)),
    (("conv2_1", 64, 128), ("conv2_2", 128, 128)),
    (("conv3_1", 128, 256), ("conv3_2", 256, 256), ("conv3_3", 256, 256)),
    (("conv4_1", 256, 512), ("conv4_2", 512, 512), ("conv4_3", 512, 512)),
    (("conv5_1", 512, 512), ("conv5_2", 512, 512), ("conv5_3", 512, 512)),
)
#: (upconv, its channels, its convs) of each decoder stage from 1/32 up
DECODER = (
    ("upconv5", 512, (("conv5_3_D", 512, 512), ("conv5_2_D", 512, 512),
                      ("conv5_1_D", 512, 512))),
    ("upconv4", 512, (("conv4_3_D", 512, 512), ("conv4_2_D", 512, 512),
                      ("conv4_1_D", 512, 256))),
    ("upconv3", 256, (("conv3_3_D", 512, 256), ("conv3_2_D", 256, 256),
                      ("conv3_1_D", 256, 128))),
    ("upconv2", 128, (("conv2_2_D", 128, 128), ("conv2_1_D", 128, 64))),
    ("upconv1", 64, (("conv1_2_D", 64, 64),)),
)


@contextlib.contextmanager
def tf32_off():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class DDFFNetReference(nn.Module):
    """``(fs (B, N, H, W, 3), focus_dists (B, N))`` -> (pred ``(B, H, W)``,
    maps ``(B, N, H, W)``); the focus distances are not read."""

    def __init__(self, focal_stack_size: int = 10):
        super().__init__()
        convs = [c for stage in ENCODER for c in stage]
        convs += [c for _, _, stage in DECODER for c in stage]
        for name, cin, cout in convs:
            setattr(self, name, nn.Conv2d(cin, cout, 3, padding=1, bias=False))
            setattr(self, f"{name}_bn", nn.BatchNorm2d(cout))
        for up, c, _ in DECODER:
            setattr(self, up, nn.ConvTranspose2d(c, c, 4, stride=2, padding=1, bias=False))
        self.conv1_1_D = nn.Conv2d(64, 1, 3, padding=1, bias=False)
        self.scoring = nn.Conv2d(focal_stack_size, 1, 1, bias=False)

    def _c3(self, x, name):
        conv, bn = getattr(self, name), getattr(self, f"{name}_bn")
        x = F.conv2d(x, conv.weight, padding=1)
        x = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                         training=False, eps=bn.eps)
        return F.relu(x)

    def forward(self, fs, focus_dists):
        with tf32_off():
            b, n, h, w, c = fs.shape
            x = fs.permute(0, 1, 4, 2, 3).reshape(b * n, c, h, w)
            for i, stage in enumerate(ENCODER):
                for name, _, _ in stage:
                    x = self._c3(x, name)
                if i == 2:
                    e3 = x
                x = F.max_pool2d(x, 2, stride=2)
            for up, _, stage in DECODER:
                x = F.conv_transpose2d(x, getattr(self, up).weight, stride=2, padding=1)
                if up == "upconv3":
                    x = torch.cat([x, e3], dim=1)
                for name, _, _ in stage:
                    x = self._c3(x, name)
            maps = F.conv2d(x, self.conv1_1_D.weight, padding=1).reshape(b, n, h, w)
            pred = F.conv2d(maps, self.scoring.weight)[:, 0]
            return pred, maps


def port_state_dict(reference: nn.Module) -> dict:
    """The reference's weights in the port's shapes: each 2-D conv or deconv
    weight gets a depth axis of 1 at dim 2, as the conv3d that computes it
    holds it."""
    return {k: (v.unsqueeze(2) if v.dim() == 4 else v) for k, v in reference.state_dict().items()}


def reference_state_dict(port_sd: dict, focal_stack_size: int = 10) -> dict:
    """The inverse of ``port_state_dict``, read against the reference's own
    shapes."""
    shapes = {k: v.shape for k, v in DDFFNetReference(focal_stack_size).state_dict().items()}
    return {k: v.reshape(shapes[k]) for k, v in port_sd.items()}
