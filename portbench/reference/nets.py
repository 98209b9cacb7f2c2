"""The plain reference of DFFNet and of the end-to-end (alignment + depth)
network: plain PyTorch ops in fp32, unpacked, with no kernel, no packed graph
and no cache of derived weights.

It follows the published description ("Learning Depth from Focus in the
Wild", ECCV 2022; the public code wcy199705/DfFintheWild,
`Depth_Estimation_Network.py` and `End_to_End/End_to_End.py`): the same
layers, in the same order, under the reference's state-dict keys.  The
weights are a dict of tensors under those keys (``weights.draw``); the
forwards read them and, in training mode, update the BatchNorm running
statistics in the dict, as ``nn.BatchNorm3d`` does.

The alignment warp is ``F.grid_sample`` (bilinear, ``align_corners=True``,
zero padding) over each slice's scaled and shifted grid, as the published
code computes it, not the program's separable matrix products.

``Ref(params, train=...)``; with ``params=None`` the forward reads zeros and
records each key's shape and how it is drawn (``record_specs``).  The
network modules ``portbench/networks/dffnet.py`` and ``e2e.py`` point at
these forwards.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
ALPHA_DAMPING = 0.001  # `End_to_End.py:79,:88,:99`
N_MOTION = 10  # AdaptiveAvgPool3d((10, 1, 1))
DFF = "DFF_net."
FLOW = "optical_flow_aggregation."


class Ref:
    """One forward's reader of the weights and its layers."""

    def __init__(self, params: Optional[Dict[str, torch.Tensor]], *, train: bool = False):
        self.params = params
        self.train = train
        self.specs: Dict[str, tuple] = {}
        self.msra = True  # DFFNet's convs draw N(0, 2 / fan_out); FlowNetwork's torch's default

    # -- weights -----------------------------------------------------------
    def w(self, key: str, shape: tuple, kind: tuple) -> torch.Tensor:
        if self.params is None:
            self.specs[key] = (tuple(shape), kind)
            return torch.zeros(shape)
        t = self.params[key]
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{key}: expected {tuple(shape)}, got {tuple(t.shape)}")
        return t

    def declare_bn(self, key: str, c: int) -> tuple:
        w = self.w(key + ".weight", (c,), ("bn_weight",))
        b = self.w(key + ".bias", (c,), ("bn_bias",))
        m = self.w(key + ".running_mean", (c,), ("bn_mean",))
        v = self.w(key + ".running_var", (c,), ("bn_var",))
        self.w(key + ".num_batches_tracked", (), ("count",))
        return w, b, m, v

    def declare_conv(self, key: str, cin: int, cout: int, k: tuple, bias: bool = False):
        kind = ("msra",) if self.msra else ("default", cin * _prod(k))
        w = self.w(key + ".weight", (cout, cin, *k), kind)
        b = self.w(key + ".bias", (cout,), ("bias", cin * _prod(k))) if bias else None
        return w, b

    # -- layers ------------------------------------------------------------
    def conv(self, x, key, cout, k, *, stride=1, padding=0, dilation=1, bias=False):
        w, b = self.declare_conv(key, x.shape[1], cout, _triple(k), bias)
        return F.conv3d(x, w, b, stride=stride, padding=padding, dilation=dilation)

    def deconv(self, x, key, cout):
        """k3, pad 1, stride (1, 2, 2), output_padding (0, 1, 1), no bias."""
        w = self.w(key + ".weight", (x.shape[1], cout, 3, 3, 3), ("deconv", cout * 27))
        return F.conv_transpose3d(x, w, stride=(1, 2, 2), padding=1, output_padding=(0, 1, 1))

    def bn(self, x, key):
        w, b, m, v = self.declare_bn(key, x.shape[1])
        if self.params is None:
            return x
        return F.batch_norm(x, m, v, w, b, training=self.train, momentum=BN_MOMENTUM,
                            eps=BN_EPS)

    def convbn(self, x, key, cout, k, **kw):
        return self.bn(self.conv(x, key + ".0", cout, k, **kw), key + ".1")

    def convbn_relu(self, x, key, cout, k, **kw):
        """``nn.Sequential(convbn_3d, ReLU)``: keys ``key.0.0``, ``key.0.1``."""
        return torch.relu(self.convbn(x, key + ".0", cout, k, **kw))

    def deconvbn(self, x, key, cout):
        return self.bn(self.deconv(x, key + ".0", cout), key + ".1")


def _triple(k) -> tuple:
    return (k, k, k) if isinstance(k, int) else tuple(k)


def _prod(k) -> int:
    out = 1
    for v in k:
        out *= v
    return out


# ---------------------------------------------------------------------------
# DFFNet (`Depth_Estimation_Network.py:15-330`)
# ---------------------------------------------------------------------------


def _resnet_block_2d(r: Ref, x, key):
    """relu(x + convbn(relu(convbn(x)))), (1, 3, 3) convs."""
    c = x.shape[1]
    y = torch.relu(r.convbn(x, key + ".conv.0", c, (1, 3, 3), padding=(0, 1, 1)))
    y = r.convbn(y, key + ".conv.2", c, (1, 3, 3), padding=(0, 1, 1))
    return torch.relu(x + y)


def _srd(r: Ref, x, key):
    f = _resnet_block_2d(r, x, key + ".Focus_Measure")
    c = x.shape[1]
    a = torch.relu(r.conv(f, key + ".N_ch_attention.0", c, (3, 1, 1), padding=(1, 0, 0)))
    a = torch.relu(r.conv(a, key + ".N_ch_attention.2", c, 1))
    return f + a


def _efd(r: Ref, x, key, cout):
    s = r.convbn(x, key + ".stride_conv", cout, 3, stride=(1, 2, 2), padding=1)
    m = r.convbn(F.max_pool3d(x, (1, 2, 2)), key + ".max_pooling.1", cout, 3, padding=1)
    return torch.relu(s + m)


def _dres(r: Ref, x, key, cout, relu_last):
    y = torch.relu(r.convbn(x, key + ".0", cout, 3, padding=1))
    y = r.convbn(y, key + ".2", cout, 3, padding=1)
    return torch.relu(y) if relu_last else y


def _hourglassup(r: Ref, x, key):
    c = x.shape[1]

    def pair(name, cout, window):
        p = F.avg_pool3d(x, window)
        d = _dres(r, p, f"{key}.dres{name}_0", cout, True)
        return _dres(r, d, f"{key}.dres{name}_1", cout, False) + d

    x8, x16, x32 = pair(8, c, (1, 2, 2)), pair(16, 2 * c, (1, 4, 4)), pair(32, 2 * c, (1, 8, 8))
    c1 = r.convbn_relu(torch.cat([r.conv(x8, key + ".conv1", 2 * c, 3, stride=(1, 2, 2),
                                         padding=1), x16], 1), key + ".combine1", 2 * c, 3,
                       padding=1)
    c2 = r.convbn_relu(c1, key + ".conv2", 2 * c, 3, padding=1)
    c3 = r.convbn_relu(torch.cat([r.conv(c2, key + ".conv3", 4 * c, 3, stride=(1, 2, 2),
                                         padding=1), x32], 1), key + ".combine2", 4 * c, 3,
                       padding=1)
    c4 = r.convbn_relu(c3, key + ".conv4", 4 * c, 3, padding=1)
    c8 = torch.relu(r.deconvbn(c4, key + ".conv8", 2 * c) + r.convbn(c2, key + ".redir2", 2 * c, 1))
    out = torch.relu(r.deconvbn(c8, key + ".conv9", c) + r.convbn(x8, key + ".redir1", c, 1))
    # constructed by the published code, never called (`:209`)
    r.declare_conv(key + ".redir3.0", 4 * c, 4 * c, (1, 1, 1))
    r.declare_bn(key + ".redir3.1", 4 * c)
    return out


def _hourglass(r: Ref, x, key, c, presqu, postsqu):
    """PSMNet-style hourglass (`:245-284`): returns (out, pre_1)."""
    pre_1 = r.convbn_relu(x, key + ".conv0", c, 3, padding=1)
    out = r.convbn_relu(pre_1, key + ".conv1", 2 * c, 3, stride=(1, 2, 2), padding=1)
    pre = r.convbn(out, key + ".conv2", 2 * c, 3, padding=1)
    pre = torch.relu(pre + postsqu) if postsqu is not None else torch.relu(pre)
    out = r.convbn_relu(pre, key + ".conv3", 2 * c, 3, stride=(1, 2, 2), padding=1)
    out = r.convbn_relu(out, key + ".conv4", 2 * c, 3, padding=1)
    out = torch.relu(r.deconvbn(out, key + ".conv5", 2 * c)
                     + (presqu if presqu is not None else pre))
    # constructed by the published code, never called (`:249-250`)
    r.declare_conv(key + ".pre_conv.0.0", 2 * c, 2 * c, (1, 1, 1))
    r.declare_bn(key + ".pre_conv.0.1", 2 * c)
    return r.deconvbn(out, key + ".conv6", c), pre_1


def softplus_argmax(cost, focus_dists):
    """p = softplus(cost) + 1e-6, normalised over the focus axis; depth =
    sum of focus distances weighted by p (`:88-90, :116-126`)."""
    p = F.softplus(cost) + 1e-6
    p = p / p.sum(dim=1, keepdim=True)
    return (p * focus_dists[:, :, None, None]).sum(dim=1)


def dffnet(r: Ref, fs, focus_dists, prefix: str = DFF) -> Tuple[torch.Tensor, ...]:
    """fs ``(B, N, H, W, 3)``, focus_dists ``(B, N)`` -> (mid_out, pred1,
    pred2, pred3), each ``(B, H, W)``."""
    r.msra = True
    k = prefix
    height, width = fs.shape[2], fs.shape[3]
    x = fs.permute(0, 4, 1, 2, 3)

    def head(cost):
        up = F.interpolate(cost, size=(height, width), mode="bilinear", align_corners=False)
        return softplus_argmax(up, focus_dists)

    fm = torch.relu(r.convbn(x, k + "FM_measure.Focus_extraction.0", 8, (1, 9, 9),
                             padding=(0, 8, 8), dilation=(1, 2, 2)))
    fm = _srd(r, fm, k + "FM_measure.Focus_extraction.2")
    half = _srd(r, _efd(r, fm, k + "FM_conv1.0", 16), k + "FM_conv1.1")
    quad = _srd(r, _efd(r, half, k + "FM_conv2.0", 32), k + "FM_conv2.1")
    vol = _hourglassup(r, quad, k + "SPP_module")

    conf = torch.relu(r.convbn(vol, k + "confidence.0", 32, 3, padding=1))
    conf = r.conv(conf, k + "confidence.2", 1, 3, padding=1)[:, 0]
    mid_out = head(conf)

    y = torch.relu(r.convbn(vol, k + "dres0.0", 64, 3, padding=1))
    y = torch.relu(r.convbn(y, k + "dres0.2", 64, 3, padding=1))
    y = r.deconvbn(y, k + "deconv_1", 32)
    out, pre = _hourglass(r, torch.cat([y, quad], 1), k + "dres2", 32, None, None)
    out_in = y + out
    cost1 = r.conv(out_in, k + "classif1.0", 1, 1)[:, 0]

    out2 = r.deconvbn(out_in, k + "deconv_2", 16)
    out, pre = _hourglass(r, torch.cat([out2, half], 1), k + "dres3", 16, pre, out)
    out_in = out2 + out
    cost2 = r.conv(out_in, k + "classif2.0", 1, 1)[:, 0]

    out3 = r.deconvbn(out_in, k + "deconv_3", 8)
    o, _ = _hourglass(r, torch.cat([out3, fm], 1), k + "dres4", 8, pre, out)
    cost3 = r.conv(out3 + o, k + "classif3.0", 1, 1)[:, 0]
    return mid_out, head(cost1), head(cost2), softplus_argmax(cost3, focus_dists)


# ---------------------------------------------------------------------------
# FlowNetwork and the end-to-end network (`End_to_End/End_to_End.py:8-145`)
# ---------------------------------------------------------------------------


def _resnet_block_of(r: Ref, x, key, cout, stride):
    s = (1, stride, stride)
    y = torch.relu(r.convbn(x, key + ".conv.0", cout, (1, 3, 3), stride=s, padding=(0, 1, 1)))
    y = r.convbn(y, key + ".conv.2", cout, (1, 3, 3), padding=(0, 1, 1))
    return torch.relu(r.conv(x, key + ".feature", cout, 1, stride=s) + y)


def _of_level(r: Ref, x, key, cout, stride):
    return _resnet_block_of(r, _resnet_block_of(r, x, key + ".0", cout, stride), key + ".1",
                            cout, 1)


def _motion_head(r: Ref, volume, key, c):
    y = volume
    for i in (0, 2, 4):
        y = torch.relu(r.convbn(y, f"{key}.{i}", c, (1, 3, 3), padding=(0, 1, 1)))
    y = r.conv(y, key + ".6", 3, (1, 3, 3), padding=(0, 1, 1), bias=True)
    # AdaptiveAvgPool3d((10, 1, 1)) on N = 10 slices: the mean over H and W
    return y.mean(dim=(3, 4)).transpose(1, 2)  # (B, N, 3)


def _axis_grid(n: int, fov, shift):
    """Normalised sampling positions along one axis, ``(B, N, n)``: output
    pixel o reads source o - flow(o), flow(o) = (n // 2) (fov - 1) l(o) +
    shift, l the [-1, 1] lattice; grid_sample (align_corners) maps -1 and 1
    to the first and last pixel."""
    lattice = torch.linspace(-1.0, 1.0, n, device=fov.device)
    o = torch.arange(n, dtype=torch.float32, device=fov.device)
    flow = (n // 2) * (fov[..., None] - 1.0) * lattice + shift[..., None]
    return 2.0 * (o - flow) / (n - 1) - 1.0, flow


def warp(r: Ref, x, fov, beta, gamma):
    """The stack ``x (B, C, N, H, W)`` scaled about the centre by ``fov`` and
    shifted by ``beta`` (x) and ``gamma`` (y), all ``(B, N)``, by bilinear
    ``grid_sample`` with zeros outside.  Returns (warped, flow_x (B, N, W),
    flow_y (B, N, H))."""
    b, c, n, h, w = x.shape
    gx, flow_x = _axis_grid(w, fov, beta)
    gy, flow_y = _axis_grid(h, fov, gamma)
    grid = torch.stack([gx[:, :, None, :].expand(b, n, h, w),
                        gy[:, :, :, None].expand(b, n, h, w)], dim=-1)
    planes = x.permute(0, 2, 1, 3, 4).reshape(b * n, c, h, w)
    out = F.grid_sample(planes, grid.reshape(b * n, h, w, 2).to(planes.dtype),
                        mode="bilinear", padding_mode="zeros", align_corners=True)
    return out.reshape(b, n, c, h, w).permute(0, 2, 1, 3, 4), flow_x, flow_y


def flownet(r: Ref, fs, fovs, prefix: str = FLOW):
    """fs ``(B, 10, H, W, 3)``, fovs ``(B, 10)`` -> (warped ``(B, N, H, W,
    3)``, motion ``(B, N, 3)``)."""
    r.msra = False
    k = prefix
    x = fs.permute(0, 4, 1, 2, 3)
    fe1 = _of_level(r, x, k + "OF_feature", 8, 1)
    fe2 = _of_level(r, fe1, k + "OF_feature1", 16, 2)
    fe3 = _of_level(r, fe2, k + "OF_feature2", 32, 2)
    damping = torch.tensor([ALPHA_DAMPING, 1.0, 1.0], device=x.device)

    def warp_head(key, feat, c, alpha, beta, gamma):
        feat_w, fx, fy = warp(r, feat, alpha, beta, gamma)
        b, _, n, h, w = feat.shape
        flow = torch.stack([fx[:, :, None, :].expand(b, n, h, w),
                            fy[:, :, :, None].expand(b, n, h, w)], dim=1).to(feat.dtype)
        volume = torch.cat([feat_w[:, :, -1:].expand_as(feat_w), feat_w, flow], dim=1)
        return _motion_head(r, volume, key, c) * damping

    zeros = torch.zeros_like(fovs)
    motion = warp_head(k + "conv1", fe3, 64, fovs, zeros, zeros)
    for key, feat, c in ((k + "conv2", fe2, 32), (k + "conv3", fe1, 16)):
        motion = motion + warp_head(key, feat, c, motion[..., 0] + fovs, motion[..., 1],
                                    motion[..., 2])
    warped, _, _ = warp(r, x, motion[..., 0] + fovs, motion[..., 1], motion[..., 2])
    return warped.permute(0, 2, 3, 4, 1), motion


def e2e(r: Ref, fs, focus_dists, fovs) -> Tuple[torch.Tensor, ...]:
    """(mid_out, pred1, pred2, pred3, warped): DFFNet on the aligned stack."""
    warped, _ = flownet(r, fs, fovs)
    return (*dffnet(r, warped, focus_dists), warped)


#: the stack (N, H, W) whose forward records a network's weights
PROBE_STACK = (10, 32, 32)


def record_specs(forward, inputs) -> Dict[str, tuple]:
    """Every state-dict key that ``forward`` (``dffnet`` or ``e2e``) reads,
    with its shape and how it is drawn, recorded from a forward on
    ``inputs`` with no weights."""
    r = Ref(None)
    with torch.no_grad():
        forward(r, *inputs)
    return dict(sorted(r.specs.items()))
