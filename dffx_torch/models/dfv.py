"""DFV — "Deep Depth from Focus with Differential Focus Volume" (Yang, Huang,
Zhou, CVPR 2022; github.com/fuy34/DFV, ``models/DFFNet.py``): its
differential focus volume (``use_diff=1``), its four decoder levels
(``level=4``) and its softmax regression, on an HSM-style 2-D feature
extractor that stands in for DFV's own (see below).  The state_dict keys are
DFV's.

Flow (the focus axis N is never strided; "2-D" convs are ``(1, k, k)``
conv3ds, which act on each slice alone):

  per slice, a 2-D feature pyramid (HSM's ``feature_extraction`` moved one
  level finer): f1 16ch@1/4, f2 32ch@1/8, f3 64ch@1/16, f4 128ch@1/32 ->
  at each scale the differences of adjacent slices' features (``diff_volume``)
  -> four 3-D decoders (HSM's ``decoderBlock``) from 1/32 up to 1/4, the two
  coarsest with 3-D pyramid pooling -> a 1-channel cost at 1/4, resized to
  full resolution -> softmax over N: the depth as the expected focus distance
  and its standard deviation as the uncertainty; the 1/4 cost is returned
  beside them.

The layer list of the 2-D feature pyramid is a reading of HSM's pattern at
the four widths DFV's decoders fix, not checked against DFV's own
``models/featExactor2.py``: the stem, five ``BasicBlock`` levels, sum-fused
pyramid pooling with a 1x1 conv-BN-ReLU a path, and a top-down path of
nearest x2 upsampling and 3x3 convs.  HSM's ``projfeat3d`` (a 1x1 Conv2d over
``(N, H * W)`` with BatchNorm2d) is the 1x1x1 conv-BN it computes; a
checkpoint under DFV's keys loads as it is, its 2-D conv weights given a
depth axis of 1 (``layers.unit_depth_weights``).

Every activation is laid out as ``ops/conv.py::activation_format`` says from
the stack's dtype and the mode: NDHWC for a 16-bit eval forward, where the
stack's transpose in is a view and every conv reads and writes cuDNN's own
layout, pooled branches included; NCDHW otherwise.

The forward is four spans (``utils/profiling.py``) over contiguous code:
``dfv.features`` (the transpose in and the 2-D pyramid), ``dfv.volume`` (the
four differential volumes, whose bytes the counter ``dfv.volume_bytes``
adds up), ``dfv.decode`` (``decoder6`` to ``decoder3`` with their concats)
and ``dfv.regress`` (the cost's resize and the softmax regression).  The
training graph runs the same forward with batch statistics; no loss or
train step of DFV is part of the port.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from dffx_torch.models.layers import (BatchNorm3d, Conv3d, ConvBN3d, Seq, init_module_params,
                                      unit_depth_weights)
from dffx_torch.ops import (avg_pool3d, resize_trilinear, softmax_argmax, upsample_bilinear,
                            upsample_nearest2x)
from dffx_torch.ops.conv import activation_format, layout_of
from dffx_torch.utils import profiling

def convbn_2d(cin: int, cout: int, k: int, stride: int = 1) -> ConvBN3d:
    """HSM's ``convbn``: a 2-D k x k conv (no bias) and BN, on each slice."""
    return ConvBN3d(cin, cout, (1, k, k), stride=(1, stride, stride), padding=(0, k // 2, k // 2))


def cbr_2d(cin: int, cout: int, k: int, stride: int = 1) -> Seq:
    return Seq(convbn_2d(cin, cout, k, stride), nn.ReLU())


class NearestUp2x(nn.Module):
    """``nn.Upsample(scale_factor=2)`` on each slice."""

    def forward(self, x):
        return upsample_nearest2x(x)


class TrilinearUp(nn.Module):
    """``nn.Upsample(scale_factor=(1, 2, 2), mode='trilinear')``: H and W
    doubled, N kept."""

    def forward(self, x):
        n, h, w = x.shape[2:]
        return resize_trilinear(x, (n, 2 * h, 2 * w))


class BasicBlock(nn.Module):
    """y = ReLU(CB 3x3(ReLU(CB 3x3 s(x))) + proj(x)); proj a 1x1 s CB where
    the width or the size changes (HSM's ``BasicBlock``, keys
    ``conv1.0.*``, ``conv2.*``, ``downsample.*``)."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.conv1 = cbr_2d(cin, cout, 3, stride)
        self.conv2 = convbn_2d(cout, cout, 3)
        self.downsample = (convbn_2d(cin, cout, 1, stride) if cin != cout or stride != 1
                           else None)

    def forward(self, x):
        return self.conv2(self.conv1(x), relu=True,
                          z=x if self.downsample is None else self.downsample(x))


def pool_sizes(dims: Sequence[int]) -> list:
    """HSM's pyramid: ``np.linspace(1, min(dims) // 2, 4, dtype=int)``; each
    window (and stride) is ``int(dim / s)`` along each pooled axis."""
    return [[int(v / s) for v in dims] for s in np.linspace(1, min(dims) // 2, 4, dtype=int)]


def pyramid_pool(x: torch.Tensor, paths: Sequence[nn.Module], *, over_n: bool) -> torch.Tensor:
    """HSM's sum-fused pyramid pooling of ``x (B, C, N, H, W)``: for each
    window (``pool_sizes`` over (H, W), or over (N, H, W) with ``over_n``),
    average-pool with stride = window, the path's conv, and a trilinear
    resize back to x's size; then ReLU((x + 0.25 * sum of the paths) / 2).
    Every path's output is laid out as x is."""
    size = tuple(x.shape[2:])
    fmt = layout_of(x)
    out = x
    for path, window in zip(paths, pool_sizes(size if over_n else size[1:])):
        y = path(avg_pool3d(x, window if over_n else [1, *window]))
        out = out + 0.25 * resize_trilinear(y, size, memory_format=fmt)
    return torch.relu(out / 2.0)


class CBRUnit(nn.Module):
    """HSM's ``conv2DBatchNormRelu`` at 1x1 (key ``cbr_unit``)."""

    def __init__(self, c: int):
        super().__init__()
        self.cbr_unit = Seq(Conv3d(c, c, 1), BatchNorm3d(c), nn.ReLU())

    def forward(self, x):
        return self.cbr_unit(x)


class PyramidPooling(nn.Module):
    """HSM's ``pyramidPooling(128, None, fusion_mode='sum')`` over each
    slice, a 1x1 conv-BN-ReLU a path."""

    def __init__(self, c: int):
        super().__init__()
        self.path_module_list = nn.ModuleList(CBRUnit(c) for _ in range(4))

    def forward(self, x):
        return pyramid_pool(x, self.path_module_list, over_n=False)


class FeatureExtraction(nn.Module):
    """The per-slice 2-D pyramid: ``(B, 3, N, H, W)`` -> (f4 128ch@1/32, f3
    64ch@1/16, f2 32ch@1/8, f1 16ch@1/4)."""

    def __init__(self):
        super().__init__()
        self.firstconv = Seq(convbn_2d(3, 16, 3, 2), nn.ReLU(),
                             convbn_2d(16, 16, 3), nn.ReLU(),
                             convbn_2d(16, 32, 3), nn.ReLU())
        widths = ((32, 32, 1), (32, 64, 2), (64, 128, 2), (128, 128, 2), (128, 128, 2))
        for i, (cin, cout, s) in enumerate(widths, start=1):
            setattr(self, f"layer{i}", nn.Sequential(BasicBlock(cin, cout, s)))
        self.pyramid_pooling = PyramidPooling(128)
        self.proj5 = cbr_2d(128, 128, 1)
        self.upconv5 = Seq(NearestUp2x(), *cbr_2d(128, 64, 3))
        self.iconv4 = cbr_2d(192, 128, 3)
        self.proj4 = cbr_2d(128, 64, 1)
        self.upconv4 = Seq(NearestUp2x(), *cbr_2d(128, 64, 3))
        self.iconv3 = cbr_2d(192, 128, 3)
        self.proj3 = cbr_2d(128, 32, 1)
        self.upconv3 = Seq(NearestUp2x(), *cbr_2d(128, 32, 3))
        self.iconv2 = cbr_2d(96, 64, 3)
        self.proj2 = cbr_2d(64, 16, 1)

    def forward(self, x):
        c2 = self.layer2(self.layer1(self.firstconv(x)))
        c3 = self.layer3(c2)
        c4 = self.layer4(c3)
        p = self.pyramid_pooling(self.layer5(c4))
        i4 = self.iconv4(torch.cat([self.upconv5(p), c4], dim=1))
        i3 = self.iconv3(torch.cat([self.upconv4(i4), c3], dim=1))
        i2 = self.iconv2(torch.cat([self.upconv3(i3), c2], dim=1))
        return self.proj5(p), self.proj4(i4), self.proj3(i3), self.proj2(i2)


def diff_volume(f: torch.Tensor) -> torch.Tensor:
    """DFV's ``diff_feat_volume1`` of ``f (B, C, N, H, W)``: v[:, :, i] =
    f[:, :, i] - f[:, :, i + 1] for i < N - 1 and v[:, :, N - 1] = f[:, :,
    N - 1], in f's layout; the counter ``dfv.volume_bytes`` adds v's bytes."""
    v = torch.cat([f[:, :, :-1] - f[:, :, 1:], f[:, :, -1:]], dim=2)
    profiling.count("dfv.volume_bytes", v.nbytes)
    return v


class ProjFeat3d(nn.Module):
    """HSM's ``projfeat3d`` at stride 1: a 1x1x1 conv (no bias) and BN
    (keys ``conv1``, ``bn``); its eval BN is one pass of its own."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = Conv3d(cin, cout, 1)
        self.bn = BatchNorm3d(cout)

    def forward(self, x):
        return self.bn(self.conv1(x))


class SepConv3dBlock(nn.Module):
    """HSM's ``sepConv3dBlock`` at stride 1: y = ReLU(CB 3^3(ReLU(CB 3^3(x)))
    + proj(x)), proj a ``ProjFeat3d`` where the width changes."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.downsample = ProjFeat3d(cin, cout) if cin != cout else None
        self.conv1 = ConvBN3d(cin, cout, 3, padding=1)
        self.conv2 = ConvBN3d(cout, cout, 3, padding=1)

    def forward(self, x):
        return self.conv2(self.conv1(x, relu=True), relu=True,
                          z=x if self.downsample is None else self.downsample(x))


class DecoderBlock(nn.Module):
    """HSM's ``decoderBlock(2, cin, c)`` with every stride 1: two
    ``SepConv3dBlock``s, then, with ``pool``, pyramid pooling over (N, H, W)
    with a 1x1x1 conv-BN a path.  With ``up`` it returns ReLU(CB 3^3 c->c/2
    (trilinear x(1, 2, 2)(x))); without, the cost ``(B, N, H, W)`` of its
    ``classify`` head.  ``classify`` exists in every block, so that the keys
    are DFV's, and runs only in the last."""

    def __init__(self, cin: int, c: int, *, up: bool, pool: bool = False):
        super().__init__()
        self.convs = nn.Sequential(SepConv3dBlock(cin, c), SepConv3dBlock(c, c))
        self.classify = Seq(ConvBN3d(c, c, 3, padding=1), nn.ReLU(),
                            nn.Sequential(Conv3d(c, 1, 3, padding=1, bias=True)))
        self.up = (Seq(TrilinearUp(), ConvBN3d(c, c // 2, 3, padding=1), nn.ReLU())
                   if up else None)
        self.pool_convs = (nn.ModuleList(ConvBN3d(c, c, 1) for _ in range(4)) if pool
                           else None)

    def forward(self, x):
        x = self.convs(x)
        if self.pool_convs is not None:
            x = pyramid_pool(x, self.pool_convs, over_n=True)
        if self.up is not None:
            return self.up(x)
        return self.classify(x)[:, 0]


class DFV(nn.Module):
    """Focal stack -> (pred3, std3, cost3): the depth and its standard
    deviation, each ``(B, H, W)``, and the cost ``(B, N, H/4, W/4)`` they
    are regressed from (DFV's eval forward returns the first two; the cost
    is served too, so that a comparison can read the network before its
    softmax)."""

    #: DFV's init loop draws every conv N(0, sqrt(2 / (prod(k) * Cout)))
    msra_init = True

    def __init__(self):
        super().__init__()
        self.feature_extraction = FeatureExtraction()
        self.decoder3 = DecoderBlock(32, 32, up=False)
        self.decoder4 = DecoderBlock(64, 32, up=True)
        self.decoder5 = DecoderBlock(128, 64, up=True, pool=True)
        self.decoder6 = DecoderBlock(128, 128, up=True, pool=True)
        self.register_load_state_dict_pre_hook(unit_depth_weights)

    def forward(self, fs: torch.Tensor, focus_dists: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """fs ``(B, N, H, W, 3)`` in [-1, 1], N >= 2, H and W multiples of 32
        and at least 64; focus_dists ``(B, N)``."""
        if fs.dim() != 5 or fs.shape[-1] != 3:
            raise ValueError(f"fs must be (B, N, H, W, 3), got {tuple(fs.shape)}")
        n, height, width = fs.shape[1:4]
        if height % 32 or width % 32 or min(height, width) < 64 or n < 2:
            raise ValueError("DFV needs N >= 2 and H, W multiples of 32 of at least 64 (its "
                             f"pyramids pool at 1/32), got {n}x{height}x{width}")

        with profiling.span("dfv.features", fs.device):
            x = fs.permute(0, 4, 1, 2, 3)  # (B, 3, N, H, W): a view, laid out NDHWC
            x = x.contiguous(memory_format=activation_format(x, self.training))
            feats = self.feature_extraction(x)

        with profiling.span("dfv.volume", fs.device):
            v4, v3, v2, v1 = (diff_volume(f) for f in feats)

        with profiling.span("dfv.decode", fs.device):
            up = self.decoder6(v4)
            up = self.decoder5(torch.cat([up, v3], dim=1))
            up = self.decoder4(torch.cat([up, v2], dim=1))
            cost = self.decoder3(torch.cat([up, v1], dim=1))  # (B, N, H/4, W/4)

        with profiling.span("dfv.regress", fs.device):
            pred, std = softmax_argmax(upsample_bilinear(cost, (height, width)), focus_dists,
                                       std=True)
        return pred, std, cost


def dfv_init_params(seed: int = 0) -> Dict[str, np.ndarray]:
    """``DFV``'s parameters drawn from ``seed`` (``init_module_params``: DHWIO
    layout, numpy; load with ``checkpoint.load_jax_params``)."""
    return init_module_params(DFV(), seed)
