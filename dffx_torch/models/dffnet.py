"""DFFNet — focus-measure pyramid, multi-scale cost aggregation, stacked
refinement hourglasses and four softplus soft-argmax depth heads.

The ``nn.Module`` counterpart of ``dffx/models/dffnet.py`` (reference
`Depth_Estimation_Test/Depth_Estimation_Network.py:15-127`); ``Network`` wraps
it under the ``DFF_net.`` prefix, so its state_dict keys are the reference's.

Resolution flow (focus axis N is never downsampled):
  FM_module 8ch@1/1 -> EFD+SRD 16ch@1/2 -> EFD+SRD 32ch@1/4 ->
  hourglassup 32ch@1/8 -> confidence head -> D1 ->
  dres0 64ch@1/8 -> deconv_1 -> hourglass(32)@1/4 -> D2 ->
  deconv_2 -> hourglass(16)@1/2 -> D3 -> deconv_3 -> hourglass(8)@1/1 -> D4.

With ``packed`` (the counterpart of ``dffx``'s ``Ctx.use_packed``, the graph
its serving path runs) the same arithmetic is evaluated space-to-depth
(``models/packed.py``): both EFDs read their input packed, 4x the channels on
the half lattice (32ch@1/2, 64ch@1/4), and the whole full-resolution stage
(deconv_3, the ends of hourglass(8), the residual add and classif3) runs as
32- and 64-channel convs @1/2; the 1/2 and 1/4 stages are never packed.  The
parameters and the state_dict are the same either way.  ``packed`` is an eval
graph: in training mode (``.train()``) the forward runs unpacked, on stock
ops, as ``dffx`` does under ``Ctx.train``; ``remat`` then recomputes the
stages ``dffnet_apply`` checkpoints (``layers.ckpt_stage``).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from dffx_torch.models.layers import (
    EFD,
    SRD,
    Conv3d,
    ConvBN3d,
    DeconvBN3d,
    FMModule,
    ckpt_stage,
    convbn_relu,
    init_module_params,
)
from dffx_torch.models.packed import (PACKED_DEFAULT, efd_params, pack, packed_efd, packed_stage,
                                      stage_params, stage_sources)
from dffx_torch.ops import avg_pool3d, softplus_argmax, upsample_bilinear
from dffx_torch.ops.kernels import ParamCache


class Hourglass(nn.Module):
    """PSMNet-style refinement with cross-hourglass skip state
    (`Depth_Estimation_Network.py:245-284`); returns (out, pre_1)."""

    def __init__(self, c):
        super().__init__()
        self.conv0 = convbn_relu(2 * c, c, 3, padding=1)
        self.conv1 = convbn_relu(c, 2 * c, 3, stride=(1, 2, 2), padding=1)
        # constructed by the reference but unused in its forward (`:249-250`);
        # kept so the state_dict matches
        self.pre_conv = convbn_relu(2 * c, 2 * c, 1)
        self.conv2 = ConvBN3d(2 * c, 2 * c, 3, padding=1)
        self.conv3 = convbn_relu(2 * c, 2 * c, 3, stride=(1, 2, 2), padding=1)
        self.conv4 = convbn_relu(2 * c, 2 * c, 3, padding=1)
        self.conv5 = DeconvBN3d(2 * c, 2 * c)
        self.conv6 = DeconvBN3d(2 * c, c)

    def interior(self, out, presqu: Optional[torch.Tensor], postsqu: Optional[torch.Tensor]):
        """conv2..conv5, from conv1's output to conv6's input: half the
        hourglass's resolution and below."""
        pre = self.conv2(out)
        pre = torch.relu(pre + postsqu) if postsqu is not None else torch.relu(pre)
        out = self.conv4(self.conv3(pre))
        return torch.relu(self.conv5(out) + (presqu if presqu is not None else pre))

    def forward(self, x, presqu: Optional[torch.Tensor], postsqu: Optional[torch.Tensor]):
        pre_1 = self.conv0(x)
        return self.conv6(self.interior(self.conv1(pre_1), presqu, postsqu)), pre_1


def _dres(c_in, c_out, *, relu_last: bool) -> nn.Sequential:
    mods = [ConvBN3d(c_in, c_out, 3, padding=1), nn.ReLU(),
            ConvBN3d(c_out, c_out, 3, padding=1)]
    return nn.Sequential(*mods, nn.ReLU()) if relu_last else nn.Sequential(*mods)


class HourglassUp(nn.Module):
    """Multi-scale feature aggregation (`Depth_Estimation_Network.py:145-238`):
    avg-pool pyramid, per-scale residual branches, strided encoder with skip
    concats, two deconv decoders with 1x1 redir skips.  32ch@1/4 -> 32ch@1/8."""

    def __init__(self, c):
        super().__init__()
        self.dres8_0 = _dres(c, c, relu_last=True)
        self.dres16_0 = _dres(c, 2 * c, relu_last=True)
        self.dres32_0 = _dres(c, 2 * c, relu_last=True)
        self.dres8_1 = _dres(c, c, relu_last=False)
        self.dres16_1 = _dres(2 * c, 2 * c, relu_last=False)
        self.dres32_1 = _dres(2 * c, 2 * c, relu_last=False)
        self.conv1 = Conv3d(c, 2 * c, 3, stride=(1, 2, 2), padding=1)
        self.conv2 = convbn_relu(2 * c, 2 * c, 3, padding=1)
        self.conv3 = Conv3d(2 * c, 4 * c, 3, stride=(1, 2, 2), padding=1)
        self.conv4 = convbn_relu(4 * c, 4 * c, 3, padding=1)
        self.conv8 = DeconvBN3d(4 * c, 2 * c)
        self.conv9 = DeconvBN3d(2 * c, c)
        self.combine1 = convbn_relu(4 * c, 2 * c, 3, padding=1)
        self.combine2 = convbn_relu(6 * c, 4 * c, 3, padding=1)
        self.redir1 = ConvBN3d(c, c, 1)
        self.redir2 = ConvBN3d(2 * c, 2 * c, 1)
        self.redir3 = ConvBN3d(4 * c, 4 * c, 1)  # constructed but unused (`:209`)

    @staticmethod
    def _pair(d0, d1, x):
        r = d0(x)
        return d1(r) + r

    def forward(self, x):
        x8 = self._pair(self.dres8_0, self.dres8_1, avg_pool3d(x, (1, 2, 2)))
        x16 = self._pair(self.dres16_0, self.dres16_1, avg_pool3d(x, (1, 4, 4)))
        x32 = self._pair(self.dres32_0, self.dres32_1, avg_pool3d(x, (1, 8, 8)))
        c1 = self.combine1(torch.cat([self.conv1(x8), x16], dim=1))
        c2 = self.conv2(c1)
        c3 = self.combine2(torch.cat([self.conv3(c2), x32], dim=1))
        c4 = self.conv4(c3)
        c8 = torch.relu(self.conv8(c4) + self.redir2(c2))
        return torch.relu(self.conv9(c8) + self.redir1(x8))


class DFFNet(nn.Module):
    """Focal stack -> (mid_out, pred1, pred2, pred3) depth heads.  ``packed``:
    in eval mode both EFDs and the full-resolution stage run space-to-depth
    (``models/packed.py``), an exact reparameterisation of the same weights."""

    #: the reference's MSRA init loop covers DFFNet's convs (init_module_params)
    msra_init = True

    def __init__(self, packed: bool = PACKED_DEFAULT):
        super().__init__()
        self.packed = packed
        self._efd_params = (ParamCache(efd_params), ParamCache(efd_params))
        self._tail_params = ParamCache(stage_params)
        self.FM_measure = FMModule()
        self.FM_conv1 = nn.Sequential(EFD(8, 16), SRD(16))
        self.FM_conv2 = nn.Sequential(EFD(16, 32), SRD(32))
        self.SPP_module = HourglassUp(32)
        self.confidence = nn.Sequential(ConvBN3d(32, 32, 3, padding=1), nn.ReLU(),
                                        Conv3d(32, 1, 3, padding=1))
        self.dres0 = nn.Sequential(ConvBN3d(32, 64, 3, padding=1), nn.ReLU(),
                                   ConvBN3d(64, 64, 3, padding=1), nn.ReLU())
        self.deconv_1 = DeconvBN3d(64, 32)
        self.dres2 = Hourglass(32)
        self.deconv_2 = DeconvBN3d(32, 16)
        self.dres3 = Hourglass(16)
        self.deconv_3 = DeconvBN3d(16, 8)
        self.dres4 = Hourglass(8)
        self.classif1 = nn.Sequential(Conv3d(32, 1, 1))
        self.classif2 = nn.Sequential(Conv3d(16, 1, 1))
        self.classif3 = nn.Sequential(Conv3d(8, 1, 1))

    def _packed_down(self, level: int, x: torch.Tensor,
                     x_packed: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``FM_conv1`` (level 0) or ``FM_conv2`` packed: the EFD reads
        ``pack(x)`` (``x_packed`` where the caller has it already), then the SRD."""
        efd, srd = (self.FM_conv1, self.FM_conv2)[level]
        xp = pack(x) if x_packed is None else x_packed
        w_s2 = self._efd_params[level].or_packed(xp, efd.stride_conv[0].weight)
        return srd(packed_efd(efd, xp, w_s2))

    def _tail(self, out_in, fm, pre, out):
        """deconv_3 -> dres4 -> classif3, unpacked: the full-resolution cost."""
        out2 = self.deconv_3(out_in)  # 8ch @ 1/1
        o, _ = self.dres4(torch.cat([out2, fm], dim=1), pre, out)
        return self.classif3(out2 + o)[:, 0]

    def forward(self, fs: torch.Tensor, focus_dists: torch.Tensor, *, remat: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """fs ``(B, N, H, W, 3)`` in [-1, 1], H and W multiples of 32;
        focus_dists ``(B, N)``.  Returns four ``(B, H, W)`` depth maps;
        ``pred3`` is the full-resolution head used for evaluation.  ``remat``:
        recompute each stage's activations in the backward
        (``layers.ckpt_stage``)."""
        if fs.dim() != 5 or fs.shape[-1] != 3:
            raise ValueError(f"fs must be (B, N, H, W, 3), got {tuple(fs.shape)}")
        height, width = fs.shape[2], fs.shape[3]
        if height % 32 or width % 32:
            raise ValueError(f"H and W must be multiples of 32, got {height}x{width}")
        x = fs.permute(0, 4, 1, 2, 3).contiguous()  # the one transpose: (B,3,N,H,W)
        packed = self.packed and not self.training
        stage = functools.partial(ckpt_stage, remat)

        def head(cost, fd):
            return softplus_argmax(upsample_bilinear(cost, (height, width)), fd)

        fm = stage(self.FM_measure, x)  # 8ch @ 1/1
        if packed:
            fm_packed = pack(fm)  # read by FM_conv1.0 and by dres4
            half = self._packed_down(0, fm, fm_packed)
            quad = self._packed_down(1, half)
        else:
            half = stage(self.FM_conv1, fm)
            quad = stage(self.FM_conv2, half)
        vol = stage(self.SPP_module, quad)  # 32ch @ 1/8

        conf = stage(lambda v: self.confidence(v)[:, 0], vol)  # (B, N, h8, w8)
        mid_out = stage(head, conf, focus_dists)

        x = stage(lambda v: self.deconv_1(self.dres0(v)), vol)  # 32ch @ 1/4
        out, pre = stage(lambda x, q: self.dres2(torch.cat([x, q], dim=1), None, None), x, quad)
        out_in = x + out
        cost1 = self.classif1(out_in)[:, 0]

        def dres3(out_in, half, pre, out):
            out2 = self.deconv_2(out_in)  # 16ch @ 1/2
            return (out2, *self.dres3(torch.cat([out2, half], dim=1), pre, out))

        out2, out, pre = stage(dres3, out_in, half, pre, out)
        out_in = out2 + out
        cost2 = self.classif2(out_in)[:, 0]

        if packed:
            params = self._tail_params.or_packed(
                out_in, *stage_sources(self.deconv_3, self.dres4, self.classif3[0]))
            cost3 = packed_stage(self.dres4, out_in, fm_packed, pre, out, params)
        else:
            cost3 = stage(self._tail, out_in, fm, pre, out)

        pred1 = stage(head, cost1, focus_dists)
        pred2 = stage(head, cost2, focus_dists)
        pred3 = stage(softplus_argmax, cost3, focus_dists)
        return mid_out, pred1, pred2, pred3


class Network(nn.Module):
    """The reference test-time wrapper (depth only): keys under ``DFF_net.``."""

    def __init__(self, packed: bool = PACKED_DEFAULT):
        super().__init__()
        self.DFF_net = DFFNet(packed)

    def forward(self, fs, focus_dists, *, remat: bool = False):
        return self.DFF_net(fs, focus_dists, remat=remat)


def init_params(seed: int = 0) -> Dict[str, np.ndarray]:
    """``Network``'s parameters as ``dffx.models.init_params(network_specs(),
    seed)`` draws them, bit for bit (DHWIO layout, numpy)."""
    return init_module_params(Network(), seed)
