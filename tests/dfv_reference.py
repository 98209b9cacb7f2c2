"""DFV's eval forward in plain fp32 PyTorch, the reference the port's
``dffx_torch/models/dfv.py`` is held to: Yang, Huang, Zhou, "Deep Depth
from Focus with Differential Focus Volume", CVPR 2022 (github.com/fuy34/DFV,
``models/DFFNet.py``, ``level=4``, ``use_diff=1``), with HSM's
``decoderBlock``, ``sepConv3dBlock`` and ``projfeat3d`` (Yang et al.,
CVPR 2019, github.com/gengshan-y/high-res-stereo, ``models/submodule.py``).

It imports nothing of the port and nothing of JAX, keeps no derived weight,
lays nothing out but as torch does, and turns TF32 off for its forward.  As
DFV, it runs the per-slice 2-D stage as ``nn.Conv2d`` over the B * N slices
and ``projfeat3d`` as a 1x1 ``nn.Conv2d`` over ``(N, H * W)``, so its
state_dict has DFV's keys and shapes.

Departures from the published code:

* the 2-D feature extractor (DFV's ``models/featExactor2.py``, not in the
  repository) is read from HSM's ``feature_extraction`` one level finer, at
  the widths DFV's decoders fix (16, 32, 64, 128): a stride-2 stem of three
  3x3 conv-BN-ReLUs, five ``BasicBlock``s (ReLU after the residual add),
  sum-fused pyramid pooling with a 1x1 conv-BN-ReLU on each path, and a
  top-down path of nearest x2 upsampling, a 3x3 conv-BN-ReLU, a concat (the
  upsampled first) and a 3x3 conv-BN-ReLU, with a 1x1 conv-BN-ReLU out at
  each scale;
* the 1/4-resolution cost is returned beside DFV's two outputs, so that a
  comparison can read the network before its softmax;
* eval only: the ``classify`` heads of decoders 6, 5 and 4 are built (their
  keys exist) and not run, as in DFV's eval forward;
* ``F.interpolate`` with ``align_corners=False`` stands for torch 1.x's
  ``F.upsample`` / ``nn.Upsample``, whose default it was.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@contextlib.contextmanager
def tf32_off():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def convbn(cin, cout, k, stride):
    return nn.Sequential(nn.Conv2d(cin, cout, k, stride, k // 2, bias=False),
                         nn.BatchNorm2d(cout))


def cbr(cin, cout, k, stride=1):
    return nn.Sequential(convbn(cin, cout, k, stride), nn.ReLU())


class BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride):
        super().__init__()
        self.conv1 = nn.Sequential(convbn(cin, cout, 3, stride), nn.ReLU())
        self.conv2 = convbn(cout, cout, 3, 1)
        self.downsample = (convbn(cin, cout, 1, stride) if cin != cout or stride != 1
                           else None)

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(out + x)


class conv2DBatchNormRelu(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.cbr_unit = nn.Sequential(nn.Conv2d(c, c, 1, bias=False), nn.BatchNorm2d(c),
                                      nn.ReLU())

    def forward(self, x):
        return self.cbr_unit(x)


class pyramidPooling(nn.Module):
    """HSM's sum fusion, a 1x1 conv-BN-ReLU on each path."""

    def __init__(self, c):
        super().__init__()
        self.path_module_list = nn.ModuleList([conv2DBatchNormRelu(c) for _ in range(4)])

    def forward(self, x):
        h, w = x.shape[2:]
        pp_sum = x
        for i, pool_size in enumerate(np.linspace(1, min(h, w) // 2, 4, dtype=int)):
            k = (int(h / pool_size), int(w / pool_size))
            out = self.path_module_list[i](F.avg_pool2d(x, k, stride=k, padding=0))
            out = F.interpolate(out, size=(h, w), mode="bilinear", align_corners=False)
            pp_sum = pp_sum + 0.25 * out
        return F.relu(pp_sum / 2.0)


class feature_extraction(nn.Module):
    def __init__(self):
        super().__init__()
        self.firstconv = nn.Sequential(convbn(3, 16, 3, 2), nn.ReLU(), convbn(16, 16, 3, 1),
                                       nn.ReLU(), convbn(16, 32, 3, 1), nn.ReLU())
        self.layer1 = nn.Sequential(BasicBlock(32, 32, 1))
        self.layer2 = nn.Sequential(BasicBlock(32, 64, 2))
        self.layer3 = nn.Sequential(BasicBlock(64, 128, 2))
        self.layer4 = nn.Sequential(BasicBlock(128, 128, 2))
        self.layer5 = nn.Sequential(BasicBlock(128, 128, 2))
        self.pyramid_pooling = pyramidPooling(128)
        up = lambda cin, cout: nn.Sequential(nn.Upsample(scale_factor=2),  # noqa: E731
                                             convbn(cin, cout, 3, 1), nn.ReLU())
        self.upconv5, self.iconv4 = up(128, 64), cbr(192, 128, 3)
        self.upconv4, self.iconv3 = up(128, 64), cbr(192, 128, 3)
        self.upconv3, self.iconv2 = up(128, 32), cbr(96, 64, 3)
        self.proj5, self.proj4 = cbr(128, 128, 1), cbr(128, 64, 1)
        self.proj3, self.proj2 = cbr(128, 32, 1), cbr(64, 16, 1)

    def forward(self, x):
        conv2 = self.layer2(self.layer1(self.firstconv(x)))
        conv3 = self.layer3(conv2)
        conv4 = self.layer4(conv3)
        conv5 = self.pyramid_pooling(self.layer5(conv4))
        conv4 = self.iconv4(torch.cat((self.upconv5(conv5), conv4), dim=1))
        conv3 = self.iconv3(torch.cat((self.upconv4(conv4), conv3), dim=1))
        conv2 = self.iconv2(torch.cat((self.upconv3(conv3), conv2), dim=1))
        return self.proj5(conv5), self.proj4(conv4), self.proj3(conv3), self.proj2(conv2)


def sepConv3d(cin, cout, k, pad, bias=False):
    if bias:
        return nn.Sequential(nn.Conv3d(cin, cout, k, 1, pad, bias=True))
    return nn.Sequential(nn.Conv3d(cin, cout, k, 1, pad, bias=False), nn.BatchNorm3d(cout))


class projfeat3d(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, (1, 1), padding=(0, 0), stride=(1, 1), bias=False)
        self.bn = nn.BatchNorm2d(cout)

    def forward(self, x):
        b, c, d, h, w = x.size()
        x = self.bn(self.conv1(x.view(b, c, d, h * w)))
        return x.view(b, -1, d, h, w)


class sepConv3dBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.downsample = None if cin == cout else projfeat3d(cin, cout)
        self.conv1 = sepConv3d(cin, cout, 3, 1)
        self.conv2 = sepConv3d(cout, cout, 3, 1)

    def forward(self, x):
        out = F.relu(self.conv1(x))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + self.conv2(out))


class decoderBlock(nn.Module):
    def __init__(self, cin, c, up=False, pool=False):
        super().__init__()
        self.pool = pool
        self.convs = nn.Sequential(sepConv3dBlock(cin, c), sepConv3dBlock(c, c))
        self.classify = nn.Sequential(sepConv3d(c, c, 3, 1), nn.ReLU(),
                                      sepConv3d(c, 1, 3, 1, bias=True))
        self.up = (nn.Sequential(nn.Upsample(scale_factor=(1, 2, 2), mode="trilinear",
                                             align_corners=False),
                                 sepConv3d(c, c // 2, 3, 1), nn.ReLU()) if up else False)
        if pool:
            self.pool_convs = nn.ModuleList([sepConv3d(c, c, 1, 0) for _ in range(4)])

    def forward(self, fvl):
        fvl = self.convs(fvl)
        if self.pool:
            fvl_out = fvl
            _, _, d, h, w = fvl.shape
            for i, pool_size in enumerate(np.linspace(1, min(d, h, w) // 2, 4, dtype=int)):
                k = (int(d / pool_size), int(h / pool_size), int(w / pool_size))
                out = self.pool_convs[i](F.avg_pool3d(fvl, k, stride=k))
                out = F.interpolate(out, size=(d, h, w), mode="trilinear", align_corners=False)
                fvl_out = fvl_out + 0.25 * out
            fvl = F.relu(fvl_out / 2.0)
        if self.up:
            return self.up(fvl)
        return self.classify(fvl).squeeze(1)


def diff_feat_volume1(vol):
    vol_out = vol[:, :, :-1] - vol[:, :, 1:]
    return torch.cat([vol_out, vol[:, :, -1:]], dim=2)


def disparityregression(prob, focal_dist):
    fd = focal_dist[:, :, None, None]
    out = torch.sum(prob * fd, 1, keepdim=True)
    std = torch.sqrt(torch.sum(prob * (fd - out) ** 2, 1, keepdim=True))
    return out.squeeze(1), std.squeeze(1)


class DFVReference(nn.Module):
    """``(fs (B, N, H, W, 3), focus_dists (B, N))`` -> (pred3, std3, cost3):
    DFV's two eval outputs and the 1/4-resolution cost they come from."""

    def __init__(self):
        super().__init__()
        self.feature_extraction = feature_extraction()
        self.decoder3 = decoderBlock(32, 32)
        self.decoder4 = decoderBlock(64, 32, up=True)
        self.decoder5 = decoderBlock(128, 64, up=True, pool=True)
        self.decoder6 = decoderBlock(128, 128, up=True, pool=True)

    def forward(self, fs, focal_dist):
        with tf32_off():
            b, n, h, w, c = fs.shape
            stack = fs.permute(0, 1, 4, 2, 3).reshape(b * n, c, h, w)
            feats = self.feature_extraction(stack)
            vols = [diff_feat_volume1(f.reshape(b, n, -1, *f.shape[2:]).permute(0, 2, 1, 3, 4))
                    for f in feats]
            up6 = self.decoder6(vols[0])
            up5 = self.decoder5(torch.cat((up6, vols[1]), dim=1))
            up4 = self.decoder4(torch.cat((up5, vols[2]), dim=1))
            cost3 = self.decoder3(torch.cat((up4, vols[3]), dim=1))
            full = F.interpolate(cost3, [h, w], mode="bilinear", align_corners=False)
            return (*disparityregression(F.softmax(full, 1), focal_dist), cost3)


def port_state_dict(reference: nn.Module) -> dict:
    """The reference's weights in the port's shapes: each 2-D conv weight
    ``(Cout, Cin, kh, kw)`` as the ``(Cout, Cin, 1, kh, kw)`` of the conv3d
    that computes it."""
    return {k: (v.unsqueeze(2) if v.dim() == 4 else v) for k, v in reference.state_dict().items()}


def reference_state_dict(port_sd: dict) -> dict:
    """The inverse of ``port_state_dict`` for a state dict whose 2-D convs
    have a depth axis of 1, read against the reference's own shapes."""
    shapes = {k: v.shape for k, v in DFVReference().state_dict().items()}
    return {k: v.reshape(shapes[k]) for k, v in port_sd.items()}
