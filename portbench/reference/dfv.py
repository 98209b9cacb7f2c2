"""The plain reference of DFV: Yang, Huang, Zhou, "Deep Depth from Focus with
Differential Focus Volume", CVPR 2022 (github.com/fuy34/DFV,
``models/DFFNet.py``, ``level=4``, ``use_diff=1``), its eval forward in plain
fp32 PyTorch, with HSM's ``decoderBlock``, ``sepConv3dBlock`` and
``projfeat3d`` (Yang et al., CVPR 2019, github.com/gengshan-y/high-res-stereo)
under DFV's state-dict keys.  It reads the benchmark's weights through
``nets.Ref`` (``record_specs``, ``weights.draw``: every convolution MSRA,
N(0, sqrt(2 / (prod(k) * Cout))), as HSM's init loop draws them), imports
nothing of the program, and runs with TF32 off (``drivers/common.py::
serving_checks`` turns it off before any reference forward).

Departures from the published code:

* form only: the per-slice 2-D stage runs as ``(1, k, k)`` 3-D convs on
  ``(B, C, N, H, W)``, not as ``conv2d`` over the B * N slices, and
  ``projfeat3d``'s 1x1 ``Conv2d`` over ``(N, H * W)`` as a 1x1x1 conv: the
  same sums, kept five-dimensional so that the fp8 control
  (``lowp.fp8``) rounds every feature volume; the 2-D conv weights are
  therefore ``(Cout, Cin, 1, kh, kw)``;
* the 2-D feature extractor (DFV's ``models/featExactor2.py``, not in the
  repository) is read from HSM's ``feature_extraction`` one level finer at
  the widths DFV's decoders fix (16, 32, 64, 128): the configuration's
  ``assumed`` lists it;
* the 1/4-resolution cost is returned beside DFV's two outputs, so that a
  comparison can read the network before its softmax;
* eval only: the ``classify`` heads of decoders 6, 5 and 4 are declared
  (their keys exist) and not run, as in DFV's eval forward;
* ``F.interpolate`` with ``align_corners=False`` stands for torch 1.x's
  ``F.upsample`` / ``nn.Upsample``, whose default it was.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.nets import Ref

FE = "feature_extraction."
#: a stack whose forward reaches every layer: H and W multiples of 32, at 1/32 at least 2
PROBE_STACK = (10, 64, 64)


def _convbn2d(r: Ref, x, key, cout, k, stride=1):
    return r.convbn(x, key, cout, (1, k, k), stride=(1, stride, stride),
                    padding=(0, k // 2, k // 2))


def _cbr2d(r: Ref, x, key, cout, k, stride=1):
    """``nn.Sequential(convbn, ReLU)``: keys ``key.0.0``, ``key.0.1``."""
    return torch.relu(_convbn2d(r, x, key + ".0", cout, k, stride))


def _nearest2x(x):
    return F.interpolate(x, scale_factor=(1, 2, 2), mode="nearest")


def _basic_block(r: Ref, x, key, cout, stride):
    out = _convbn2d(r, _cbr2d(r, x, key + ".conv1", cout, 3, stride), key + ".conv2", cout, 3)
    if x.shape[1] != cout or stride != 1:
        x = _convbn2d(r, x, key + ".downsample", cout, 1, stride)
    return torch.relu(out + x)


def _pool_windows(dims):
    return [[int(v / s) for v in dims] for s in np.linspace(1, min(dims) // 2, 4, dtype=int)]


def _spp(r: Ref, x, key):
    """HSM's ``pyramidPooling`` (sum fusion) over each slice, a 1x1
    conv-BN-ReLU a path."""
    n, h, w = x.shape[2:]
    pp_sum = x
    for i, (kh, kw) in enumerate(_pool_windows((h, w))):
        out = F.avg_pool3d(x, (1, kh, kw), stride=(1, kh, kw))
        out = torch.relu(r.convbn(out, f"{key}.path_module_list.{i}.cbr_unit", x.shape[1], 1))
        out = F.interpolate(out, size=(n, h, w), mode="trilinear", align_corners=False)
        pp_sum = pp_sum + 0.25 * out
    return torch.relu(pp_sum / 2.0)


def features(r: Ref, x):
    """The per-slice 2-D pyramid of ``x (B, 3, N, H, W)``: (f4 128ch@1/32,
    f3 64ch@1/16, f2 32ch@1/8, f1 16ch@1/4)."""
    k = FE
    y = torch.relu(_convbn2d(r, x, k + "firstconv.0", 16, 3, 2))
    y = torch.relu(_convbn2d(r, y, k + "firstconv.2", 16, 3))
    y = torch.relu(_convbn2d(r, y, k + "firstconv.4", 32, 3))
    c1 = _basic_block(r, y, k + "layer1.0", 32, 1)
    c2 = _basic_block(r, c1, k + "layer2.0", 64, 2)
    c3 = _basic_block(r, c2, k + "layer3.0", 128, 2)
    c4 = _basic_block(r, c3, k + "layer4.0", 128, 2)
    p = _spp(r, _basic_block(r, c4, k + "layer5.0", 128, 2), k + "pyramid_pooling")

    def up(x, key, cout):
        return torch.relu(_convbn2d(r, _nearest2x(x), key + ".1", cout, 3))

    i4 = _cbr2d(r, torch.cat([up(p, k + "upconv5", 64), c4], 1), k + "iconv4", 128, 3)
    i3 = _cbr2d(r, torch.cat([up(i4, k + "upconv4", 64), c3], 1), k + "iconv3", 128, 3)
    i2 = _cbr2d(r, torch.cat([up(i3, k + "upconv3", 32), c2], 1), k + "iconv2", 64, 3)
    return (_cbr2d(r, p, k + "proj5", 128, 1), _cbr2d(r, i4, k + "proj4", 64, 1),
            _cbr2d(r, i3, k + "proj3", 32, 1), _cbr2d(r, i2, k + "proj2", 16, 1))


def diff_feat_volume1(vol):
    """DFV's differential focus volume: adjacent slices' differences, the
    last slice as it is."""
    return torch.cat([vol[:, :, :-1] - vol[:, :, 1:], vol[:, :, -1:]], dim=2)


def _sep_block(r: Ref, x, key, cout):
    """HSM's ``sepConv3dBlock`` at stride 1."""
    out = torch.relu(r.convbn(x, key + ".conv1", cout, 3, padding=1))
    if x.shape[1] != cout:  # projfeat3d: conv1 and bn
        x = r.bn(r.conv(x, key + ".downsample.conv1", cout, 1), key + ".downsample.bn")
    return torch.relu(x + r.convbn(out, key + ".conv2", cout, 3, padding=1))


def _classify(r: Ref, x, key):
    y = torch.relu(r.convbn(x, key + ".0", x.shape[1], 3, padding=1))
    return r.conv(y, key + ".2.0", 1, 3, padding=1, bias=True)[:, 0]


def _declare_classify(r: Ref, key, c):
    r.declare_conv(key + ".0.0", c, c, (3, 3, 3))
    r.declare_bn(key + ".0.1", c)
    r.declare_conv(key + ".2.0", c, 1, (3, 3, 3), bias=True)


def decoder(r: Ref, x, key, c, *, up: bool, pool: bool = False):
    """HSM's ``decoderBlock(2, cin, c)``, every stride 1, in eval: the
    upsampled features of a block with ``up``, else the cost ``(B, N, H, W)``."""
    x = _sep_block(r, _sep_block(r, x, key + ".convs.0", c), key + ".convs.1", c)
    if pool:
        d, h, w = x.shape[2:]
        out = x
        for i, window in enumerate(_pool_windows((d, h, w))):
            y = r.convbn(F.avg_pool3d(x, window, stride=window), f"{key}.pool_convs.{i}", c, 1)
            out = out + 0.25 * F.interpolate(y, size=(d, h, w), mode="trilinear",
                                             align_corners=False)
        x = torch.relu(out / 2.0)
    if not up:
        return _classify(r, x, key + ".classify")
    _declare_classify(r, key + ".classify", c)  # built by DFV, run only in training
    d, h, w = x.shape[2:]
    y = F.interpolate(x, size=(d, 2 * h, 2 * w), mode="trilinear", align_corners=False)
    return torch.relu(r.convbn(y, key + ".up.1", c // 2, 3, padding=1))


def dfv(r: Ref, fs, focus_dists) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """fs ``(B, N, H, W, 3)``, focus_dists ``(B, N)`` -> (pred3, std3, cost3):
    the expected focus distance under the softmax over N of the
    full-resolution cost and its standard deviation, each ``(B, H, W)``, and
    the 1/4-resolution cost ``(B, N, H/4, W/4)``."""
    r.msra = True
    height, width = fs.shape[2], fs.shape[3]
    f4, f3, f2, f1 = features(r, fs.permute(0, 4, 1, 2, 3))
    up = decoder(r, diff_feat_volume1(f4), "decoder6", 128, up=True, pool=True)
    up = decoder(r, torch.cat([up, diff_feat_volume1(f3)], 1), "decoder5", 64, up=True,
                 pool=True)
    up = decoder(r, torch.cat([up, diff_feat_volume1(f2)], 1), "decoder4", 32, up=True)
    cost = decoder(r, torch.cat([up, diff_feat_volume1(f1)], 1), "decoder3", 32, up=False)
    full = F.interpolate(cost, size=(height, width), mode="bilinear", align_corners=False)
    p = F.softmax(full, dim=1)
    fd = focus_dists[:, :, None, None]
    pred = (p * fd).sum(dim=1, keepdim=True)
    std = (p * (fd - pred) ** 2).sum(dim=1).sqrt()
    return pred[:, 0], std, cost
