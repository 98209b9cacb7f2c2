"""DDFFNet — "Deep Depth From Focus" (Hazirbas, Soyer, Staab, Leal-Taixé,
Cremers, ACCV 2018, arXiv:1704.01085; github.com/soyers/ddff-pytorch), the
network published with the DDFF-12 dataset, in its CC3 variant: a VGG-16-BN
encoder and its mirrored decoder run on each slice of the focal stack alone,
one skip connection at 1/4, and a learned 1x1 fusion of the N per-slice
maps into the depth.  There is no cost volume and no soft-argmax.

Flow ("2-D" convs are ``(1, k, k)`` conv3ds, which act on each slice alone;
the focus axis N is never strided):

  encoder: five stages of 3x3 conv-BN-ReLUs (64, 128, 256, 512, 512
  channels; 2, 2, 3, 3, 3 convs), each ended by a 2x2 max-pool, down to
  1/32; the last conv of the 1/4 stage (``conv3_3``) is kept as ``e3`` ->
  decoder: five 4x4 stride-2 upconvs back to full resolution, each followed
  by the mirrored conv-BN-ReLUs; after ``upconv3`` the CC3 concat
  (the upsampled tensor, then ``e3``) -> ``conv1_1_D``, a plain 3x3 conv to
  one channel: the per-slice map ``m`` -> ``scoring``, a 1x1 conv over the N
  maps to the depth.

Module names are ddff-pytorch's as the layer list reads them; that list, the
bias-free convs, no BN or ReLU after an upconv, the order of the concat and
BN's eps of 1e-5 are not checked against the published code (the
configuration ``portbench/configs/ddffnet-ddff12.json`` lists them under
``assumed``).  A checkpoint under those names loads as it is, its 2-D conv
and deconv weights given a depth axis of 1 (``layers.unit_depth_weights``).
Dropout (p 0.5 after pool3, pool4, pool5, conv5_1_D, conv4_1_D and
conv3_1_D) is the identity in eval and is left out: the training graph runs
the same forward with batch statistics, and no loss or train step of
DDFFNet is part of the port.

Every activation is laid out as ``ops/conv.py::activation_format`` says from
the stack's dtype and the mode: NDHWC for a 16-bit eval forward, where the
stack's transpose in is a view and every conv, upconv and pool reads and
writes cuDNN's own layout; NCDHW otherwise.  On NDHWC the convs and upconvs
run as 2-D ops over the B * N slices (``layers.SliceConv2d``,
``ops/conv.py::deconv3d``), which cuDNN's 2-D heuristics serve better than
its 3-D ones the ``(1, k, k)`` conv3ds they compute.  Each eval BN runs with
its ReLU as one pass (``ops/norm.py::affine_act``); the last of each encoder
stage with the stage's max-pool too (``ops/norm.py::affine_act_pool``), so
that the BN-ReLU's output is written only where the CC3 concat keeps it.

The forward is three spans (``utils/profiling.py``) over contiguous code:
``ddffnet.encode`` (the transpose in, the 13 convs and the 5 pools),
``ddffnet.decode`` (the 5 upconvs, the 13 convs and the concat, whose bytes
the counter ``ddffnet.concat_bytes`` adds up) and ``ddffnet.score`` (the
fusion).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from dffx_torch.models.layers import (BatchNorm3d, Conv3d, ConvTranspose3d, SliceConv2d,
                                      init_module_params, unit_depth_weights)
from dffx_torch.ops import max_pool3d
from dffx_torch.ops.conv import activation_format
from dffx_torch.ops.norm import affine_act_pool
from dffx_torch.utils import profiling

#: the encoder's stages, each a list of (conv, Cin, Cout) ended by a 2x2 pool
ENCODER = (
    (("conv1_1", 3, 64), ("conv1_2", 64, 64)),
    (("conv2_1", 64, 128), ("conv2_2", 128, 128)),
    (("conv3_1", 128, 256), ("conv3_2", 256, 256), ("conv3_3", 256, 256)),
    (("conv4_1", 256, 512), ("conv4_2", 512, 512), ("conv4_3", 512, 512)),
    (("conv5_1", 512, 512), ("conv5_2", 512, 512), ("conv5_3", 512, 512)),
)
#: the decoder's stages from 1/32 up: (upconv, its channels, its (conv, Cin,
#: Cout)s); the CC3 concat doubles conv3_3_D's input
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
#: the encoder stage whose last conv the CC3 concat joins (1/4)
CC3_STAGE = 2


class DDFFNet(nn.Module):
    """Focal stack -> (pred, maps): the depth ``(B, H, W)`` and the N
    per-slice maps ``(B, N, H, W)`` it fuses.  ``focal_stack_size`` is N,
    the width of the fusion (10 on DDFF-12)."""

    #: ddff-pytorch draws every conv N(0, sqrt(2 / (prod(k) * Cout)))
    msra_init = True

    def __init__(self, focal_stack_size: int = 10):
        super().__init__()
        self.focal_stack_size = focal_stack_size
        for stage in ENCODER:
            for name, cin, cout in stage:
                self._c3(name, cin, cout)
        for up, c, convs in DECODER:
            setattr(self, up, ConvTranspose3d(c, c, (1, 4, 4), stride=(1, 2, 2),
                                              padding=(0, 1, 1), output_padding=0))
            for name, cin, cout in convs:
                self._c3(name, cin, cout)
        self.conv1_1_D = SliceConv2d(64, 1)
        self.scoring = Conv3d(focal_stack_size, 1, 1)
        self.register_load_state_dict_pre_hook(unit_depth_weights)

    def _c3(self, name: str, cin: int, cout: int) -> None:
        """A 3x3 conv (no bias) of each slice and its BN ``<name>_bn``."""
        setattr(self, name, SliceConv2d(cin, cout))
        setattr(self, f"{name}_bn", BatchNorm3d(cout))

    def _run(self, x, convs) -> torch.Tensor:
        for name, _, _ in convs:
            x = getattr(self, f"{name}_bn")(getattr(self, name)(x), relu=True)
        return x

    def _run_pooled(self, x, convs, keep: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """An encoder stage: its conv-BN-ReLUs, then the 2x2 max-pool;
        returns (the last BN-ReLU's output where ``keep``, else None; the
        pool's).  In eval the last BN, its ReLU and the pool are one call of
        ``affine_act_pool``."""
        x = self._run(x, convs[:-1])
        name = convs[-1][0]
        x, bn = getattr(self, name)(x), getattr(self, f"{name}_bn")
        if bn.training:
            y = bn(x, relu=True)
            return y, max_pool3d(y, (1, 2, 2))
        return affine_act_pool(x, *bn.fused_affine(x.dtype), keep=keep)

    def forward(self, fs: torch.Tensor, focus_dists: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """fs ``(B, N, H, W, 3)`` in [-1, 1], N the network's
        ``focal_stack_size``, H and W multiples of 32; ``focus_dists`` is
        taken, as every served network takes it, and not read."""
        if fs.dim() != 5 or fs.shape[-1] != 3:
            raise ValueError(f"fs must be (B, N, H, W, 3), got {tuple(fs.shape)}")
        n, height, width = fs.shape[1:4]
        if n != self.focal_stack_size or height % 32 or width % 32:
            raise ValueError(f"DDFFNet({self.focal_stack_size}) needs N = "
                             f"{self.focal_stack_size} and H, W multiples of 32 (its encoder "
                             f"pools to 1/32), got {n}x{height}x{width}")

        with profiling.span("ddffnet.encode", fs.device):
            x = fs.permute(0, 4, 1, 2, 3)  # (B, 3, N, H, W): a view, laid out NDHWC
            x = x.contiguous(memory_format=activation_format(x, self.training))
            for i, stage in enumerate(ENCODER):
                y, x = self._run_pooled(x, stage, keep=i == CC3_STAGE)
                if i == CC3_STAGE:
                    e3 = y

        with profiling.span("ddffnet.decode", fs.device):
            for up, _, convs in DECODER:
                x = getattr(self, up)(x)
                if up == "upconv3":
                    x = torch.cat([x, e3], dim=1)
                    profiling.count("ddffnet.concat_bytes", x.nbytes)
                x = self._run(x, convs)
            maps = self.conv1_1_D(x)[:, 0]  # (B, N, H, W)

        with profiling.span("ddffnet.score", fs.device):
            pred = score(maps, self.scoring.weight)
        return pred, maps


def score(maps: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The fusion ``pred = sum_n w_n * maps[:, n]`` of ``maps (B, N, H, W)``
    with the 1x1 conv weight ``w (1, N, 1, 1, 1)``: one fp32 contraction
    over N (``torch.einsum``), rounded once to the maps' dtype."""
    pred = torch.einsum("bnhw,n->bhw", maps.float(), w.reshape(-1).float())
    return pred.to(maps.dtype)


def ddffnet_init_params(seed: int = 0, focal_stack_size: int = 10) -> Dict[str, np.ndarray]:
    """``DDFFNet``'s parameters drawn from ``seed`` (``init_module_params``:
    DHWIO layout, numpy; load with ``checkpoint.load_jax_params``)."""
    return init_module_params(DDFFNet(focal_stack_size), seed)
