"""FlowNetwork alignment and the end-to-end (alignment + depth) network, eval mode.

The ``nn.Module`` counterpart of ``dffx/models/alignnet.py`` (reference
`End_to_End/End_to_End.py:8-145`): a per-slice feature pyramid, a
coarse-to-fine regression of per-slice motion ``(alpha, beta, gamma)`` (FOV
correction, x and y shift) with residual accumulation, and a final warp of the
raw stack, which ``E2ENetwork`` hands to DFFNet.

Two CUDA kernels carry the full- and low-resolution work on the card: every
stride-1 ``resnet_block_2d_OF`` runs through ``rb_of_chain`` (three launches
per forward: the full-resolution pair and the second block of each strided
level), and the full-resolution conv3 motion head through
``motion_head_conv_chain``.  The strided first blocks of the lower levels and
the two lower-resolution heads run on stock ops, as the JAX package leaves
them to XLA.  Activations are ``(B, C, N, H, W)`` inside; the public forward
keeps the JAX layout.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from dffx_torch.models.dffnet import DFFNet
from dffx_torch.models.layers import Conv3d, ConvBN3d, init_module_params
from dffx_torch.models.packed import PACKED_DEFAULT
from dffx_torch.ops.kernels import (ParamCache, motion_head_conv_chain, motion_head_params,
                                    rb_of_chain, rb_of_chain_params)
from dffx_torch.ops.pool import adaptive_avg_pool_focus
from dffx_torch.ops.warp import flow_cf, warp_cf

ALPHA_DAMPING = 0.001  # `End_to_End.py:79,:88,:99`
N_MOTION = 10  # AdaptiveAvgPool3d((10,1,1)): motion vectors per stack (`:40`)
INPLANES = 8  # the reference's one width (`alignnet.py::flownet_specs`)


class ResnetBlock2dOF(nn.Module):
    """resnet_block_2d_OF (`End_to_End.py:135-145`): two (1,3,3) convbn and a
    1x1 projection shortcut, all bias-free; ``stride`` strides H and W in the
    first conv and the shortcut."""

    def __init__(self, cin, cout, stride=1):
        super().__init__()
        s = (1, stride, stride)
        self.stride = stride
        self.conv = nn.Sequential(
            ConvBN3d(cin, cout, (1, 3, 3), stride=s, padding=(0, 1, 1)), nn.ReLU(),
            ConvBN3d(cout, cout, (1, 3, 3), padding=(0, 1, 1)))
        self.feature = Conv3d(cin, cout, 1, stride=s)

    def forward(self, x):
        return torch.relu(self.feature(x) + self.conv(x))

    def chain_args(self):
        """(w1, aff1, w2, aff2, w_shortcut), as ``rb_of_chain`` takes a block."""
        c = self.conv
        return (c[0][0].weight, c[0][1].fused_affine(), c[2][0].weight,
                c[2][1].fused_affine(), self.feature.weight)


class OFLevel(nn.Sequential):
    """One pyramid level (``OF_feature``, ``OF_feature1``, ``OF_feature2``): two blocks.
    Its stride-1 blocks run as one ``rb_of_chain``; a strided first block
    runs on stock ops before it."""

    def __init__(self, cin, cout, stride):
        super().__init__(ResnetBlock2dOF(cin, cout, stride), ResnetBlock2dOF(cout, cout))
        self._chain_params = ParamCache(rb_of_chain_params)

    def forward(self, x):
        first, second = self
        if first.stride == 1:
            blocks = [first.chain_args(), second.chain_args()]
        else:
            x, blocks = first(x), [second.chain_args()]
        return rb_of_chain(x, blocks, params=self._chain_params(x, blocks))


class MotionHead(nn.Sequential):
    """Motion-regression head convN (`End_to_End.py:33-61`): three (1,3,3)
    convbn + ReLU and a biased (1,3,3) conv to 3 channels, then
    ``AdaptiveAvgPool3d((10, 1, 1))``.  ``fused`` runs the chain before the
    pooling as ``motion_head_conv_chain`` (the full-resolution conv3 head);
    the others run on stock ops, as in the JAX package."""

    def __init__(self, c, *, fused=False):
        super().__init__(
            ConvBN3d(c + 2, c, (1, 3, 3), padding=(0, 1, 1)), nn.ReLU(),
            ConvBN3d(c, c, (1, 3, 3), padding=(0, 1, 1)), nn.ReLU(),
            ConvBN3d(c, c, (1, 3, 3), padding=(0, 1, 1)), nn.ReLU(),
            Conv3d(c, 3, (1, 3, 3), padding=(0, 1, 1), bias=True))
        self.fused = fused
        self._chain_params = ParamCache(motion_head_params)

    def forward(self, volume):
        """volume ``(B, c + 2, N, H, W)`` -> motion ``(B, N_MOTION, 3)``."""
        if self.fused:
            args = (self[0][0].weight, self[0][1].fused_affine(),
                    self[2][0].weight, self[2][1].fused_affine(),
                    self[4][0].weight, self[4][1].fused_affine(), self[6].weight, self[6].bias)
            y = motion_head_conv_chain(volume, *args, params=self._chain_params(volume, *args))
        else:
            y = super().forward(volume)
        return adaptive_avg_pool_focus(y, N_MOTION)[:, :, :, 0, 0].transpose(1, 2)


def _motion_volume(feat: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """(last-slice features || per-slice features || flow) along the channels
    (`End_to_End.py:71-76`)."""
    return torch.cat([feat[:, :, -1:].expand_as(feat), feat, flow], dim=1)


class FlowNetwork(nn.Module):
    """Per-slice global-motion estimation and warping (`End_to_End.py:63-104`)."""

    def __init__(self):
        super().__init__()
        c = INPLANES
        self.OF_feature = OFLevel(3, c, 1)
        self.OF_feature1 = OFLevel(c, 2 * c, 2)
        self.OF_feature2 = OFLevel(2 * c, 4 * c, 2)
        self.conv1 = MotionHead(8 * c)
        self.conv2 = MotionHead(4 * c)
        self.conv3 = MotionHead(2 * c, fused=True)

    @staticmethod
    def _warp_head(head, feat, alpha, beta, gamma) -> torch.Tensor:
        """Warp ``feat`` by the motion so far, regress the residual motion;
        alpha damped.  fp32 ``(B, N, 3)``."""
        feat_w, fx, fy = warp_cf(feat, alpha, beta, gamma)
        d = head(_motion_volume(feat_w, flow_cf(fx, fy, feat.dtype))).float()
        return d * d.new_tensor([ALPHA_DAMPING, 1.0, 1.0])

    def forward(self, fs: torch.Tensor, fovs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """fs ``(B, N, H, W, 3)`` with N = 10, fovs ``(B, N)`` relative
        field-of-view factors.  Returns ``(warped, motion)``: the aligned
        stack ``(B, N, H, W, 3)`` in fs.dtype and the accumulated fp32
        ``(B, N, 3)`` motion (alpha, beta, gamma)."""
        if fs.dim() != 5 or fs.shape[-1] != 3:
            raise ValueError(f"fs must be (B, N, H, W, 3), got {tuple(fs.shape)}")
        b, n = fs.shape[:2]
        if n != N_MOTION:
            raise ValueError(f"the motion heads pool the stack to {N_MOTION} slices: "
                             f"N must be {N_MOTION}, got {n}")
        if tuple(fovs.shape) != (b, n):
            raise ValueError(f"fovs must be (B, N) = {(b, n)}, got {tuple(fovs.shape)}")
        x = fs.permute(0, 4, 1, 2, 3).contiguous()  # (B, 3, N, H, W)
        fe1 = self.OF_feature(x)      # 8ch @ 1/1
        fe2 = self.OF_feature1(fe1)   # 16ch @ 1/2
        fe3 = self.OF_feature2(fe2)   # 32ch @ 1/4

        fovs = fovs.float()
        zeros = torch.zeros_like(fovs)
        motion = self._warp_head(self.conv1, fe3, fovs, zeros, zeros)
        for head, feat in ((self.conv2, fe2), (self.conv3, fe1)):
            motion = motion + self._warp_head(head, feat, motion[..., 0] + fovs,
                                              motion[..., 1], motion[..., 2])
        warped, _, _ = warp_cf(x, motion[..., 0] + fovs, motion[..., 1], motion[..., 2])
        return warped.permute(0, 2, 3, 4, 1), motion


class E2ENetwork(nn.Module):
    """The end-to-end network (`End_to_End.py:14-17`): FlowNetwork alignment,
    then DFFNet on the aligned stack.  Keys under ``DFF_net.`` and
    ``optical_flow_aggregation.``, as the reference state_dict.  ``packed``:
    DFFNet's (``models/packed.py``)."""

    def __init__(self, packed: bool = PACKED_DEFAULT):
        super().__init__()
        self.DFF_net = DFFNet(packed)
        self.optical_flow_aggregation = FlowNetwork()

    def forward(self, fs: torch.Tensor, focus_dists: torch.Tensor, fovs: torch.Tensor):
        """fs ``(B, 10, H, W, 3)`` with H, W multiples of 32; focus_dists and
        fovs ``(B, 10)``.  Returns ``(mid_out, pred1, pred2, pred3, warped)``:
        four ``(B, H, W)`` depth maps and the aligned stack."""
        warped, _ = self.optical_flow_aggregation(fs, fovs)
        return (*self.DFF_net(warped, focus_dists), warped)


def e2e_init_params(seed: int = 0) -> Dict[str, np.ndarray]:
    """``E2ENetwork``'s parameters as ``dffx.models.init_params(
    e2e_network_specs(), seed)`` draws them, bit for bit."""
    return init_module_params(E2ENetwork(), seed)
