"""Building blocks of DFFNet and FlowNetwork as ``nn.Module``s, eval mode only.

Submodule names and indices follow the reference constructors
(`Depth_Estimation_Test/Depth_Estimation_Network.py`,
`End_to_End/End_to_End.py`), so every
``state_dict`` key equals the reference key and the JAX package's param key.
Parameters stay fp32; convs run in the activation dtype (weights are cast at
use, as ``dffx`` casts its kernels), and BN always normalises with the running
statistics.  Activations are ``(B, C, N, H, W)``.

``init_module_params(Network(), seed)`` reproduces
``dffx.models.init_params(network_specs(), seed)`` bit for bit (and the same
for ``E2ENetwork`` and ``e2e_network_specs``): the same per-kind
distributions drawn from one ``np.random.default_rng(seed)`` in sorted-key
order, in the JAX package's DHWIO weight layout (load it with
``dffx_torch.checkpoint.load_jax_params``).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch import nn

from dffx_torch.ops import batch_norm, bn_fused_affine, conv3d, deconv3d
from dffx_torch.ops.kernels import (ParamCache, fm_conv_bn_relu, fm_conv_params, rb2d_residual,
                                    srd_attention_residual, tensor_stamp)


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` that runs in the input's dtype; bias-free unless asked."""

    def __init__(self, cin, cout, k, *, stride=1, padding=0, dilation=1, bias=False):
        super().__init__(cin, cout, k, stride=stride, padding=padding,
                         dilation=dilation, bias=bias)

    def forward(self, x):
        return conv3d(x, self.weight, bias=self.bias, stride=self.stride,
                      padding=self.padding, dilation=self.dilation)


class ConvTranspose3d(nn.ConvTranspose3d):
    """The reference's only deconv: k3, pad 1, stride (1,2,2), output_padding
    (0,1,1), bias-free; doubles H and W."""

    def __init__(self, cin, cout):
        super().__init__(cin, cout, 3, stride=(1, 2, 2), padding=1,
                         output_padding=(0, 1, 1), bias=False)

    def forward(self, x):
        return deconv3d(x, self.weight)


class BatchNorm3d(nn.BatchNorm3d):
    """Eval-mode BatchNorm3d with the JAX package's numerics."""

    def _eval_only(self):
        if self.training:
            raise RuntimeError("dffx_torch modules are eval-only: call .eval() first")

    def forward(self, x):
        self._eval_only()
        return batch_norm(x, self.running_mean, self.running_var, self.weight,
                          self.bias, eps=self.eps)

    _affine_key = _affine = None

    def fused_affine(self):
        """The fused fp32 (scale, shift) the kernels take: the same two
        tensors from call to call until a statistic or an affine parameter
        changes (``tensor_stamp``), so that a ``ParamCache`` can tell."""
        self._eval_only()
        src = (self.weight, self.bias, self.running_mean, self.running_var)
        if torch.is_grad_enabled() and any(t.requires_grad for t in src):
            return bn_fused_affine(*src, self.eps)  # part of a graph: not kept
        key = tuple(map(tensor_stamp, src))
        if key != self._affine_key:
            self._affine, self._affine_key = bn_fused_affine(*src, self.eps), key
        return self._affine


class ConvBN3d(nn.Sequential):
    """``convbn_3d`` = Sequential(Conv3d(bias=False), BatchNorm3d)."""

    def __init__(self, cin, cout, k, **conv_kw):
        super().__init__(Conv3d(cin, cout, k, **conv_kw), BatchNorm3d(cout))


class DeconvBN3d(nn.Sequential):
    """Sequential(ConvTranspose3d(bias=False), BatchNorm3d)."""

    def __init__(self, cin, cout):
        super().__init__(ConvTranspose3d(cin, cout), BatchNorm3d(cout))


def convbn_relu(cin, cout, k, **conv_kw) -> nn.Sequential:
    return nn.Sequential(ConvBN3d(cin, cout, k, **conv_kw), nn.ReLU())


class ResnetBlock2d(nn.Module):
    """Two (1,3,3) convbn with a residual (`Depth_Estimation_Network.py:295-304`)."""

    def __init__(self, c):
        super().__init__()
        self.conv = nn.Sequential(
            ConvBN3d(c, c, (1, 3, 3), padding=(0, 1, 1)), nn.ReLU(),
            ConvBN3d(c, c, (1, 3, 3), padding=(0, 1, 1)))

    def forward(self, x):
        return torch.relu(x + self.conv(x))


class SRD(nn.Module):
    """Stack-reduction block: spatial residual features plus additive
    focus-axis attention (`Depth_Estimation_Network.py:317-330`)."""

    def __init__(self, c):
        super().__init__()
        self.Focus_Measure = ResnetBlock2d(c)
        self.N_ch_attention = nn.Sequential(
            Conv3d(c, c, (3, 1, 1), padding=(1, 0, 0)), nn.ReLU(),
            Conv3d(c, c, 1), nn.ReLU())

    def forward(self, x):
        f = self.Focus_Measure(x)
        return f + self.N_ch_attention(f)


class EFD(nn.Module):
    """Dual-branch spatial downsampling: strided conv + maxpool-conv, summed
    (`Depth_Estimation_Network.py:306-315`).  Never strides the focus axis."""

    def __init__(self, cin, cout):
        super().__init__()
        self.stride_conv = ConvBN3d(cin, cout, 3, stride=(1, 2, 2), padding=1)
        self.max_pooling = nn.Sequential(nn.MaxPool3d((1, 2, 2)),
                                         ConvBN3d(cin, cout, 3, padding=1))

    def forward(self, x):
        return torch.relu(self.stride_conv(x) + self.max_pooling(x))


class FMModule(nn.Module):
    """Full-resolution focus-measure extraction: dilated (1,9,9) conv + BN +
    ReLU, then an SRD (`Depth_Estimation_Network.py:131-143`).

    Always runs as the three kernels, chained channel-first like
    ``dffx/models/layers.py::_fm_fused_chain``: conv -> rb2d -> attention.  On
    CUDA tensors they launch the CUDA kernels; on CPU tensors their plain
    twins run through the same chain."""

    def __init__(self):
        super().__init__()
        self.Focus_extraction = nn.Sequential(
            ConvBN3d(3, 8, (1, 9, 9), padding=(0, 8, 8), dilation=(1, 2, 2)),
            nn.ReLU(),
            SRD(8))
        self._conv_params = ParamCache(fm_conv_params)

    def forward(self, x):
        conv, _, srd = self.Focus_extraction
        args = (conv[0].weight, *conv[1].fused_affine())
        y = fm_conv_bn_relu(x, *args, params=self._conv_params(x, *args))
        rb = srd.Focus_Measure.conv
        f = rb2d_residual(y, rb[0][0].weight, rb[0][1].fused_affine(),
                          rb[2][0].weight, rb[2][1].fused_affine())
        att = srd.N_ch_attention
        return srd_attention_residual(f, att[0].weight, att[2].weight)


# ---------------------------------------------------------------------------
# Parameter init, bit-equal to the JAX package's
# ---------------------------------------------------------------------------


def _dhwio(shape, transposed: bool) -> tuple:
    """torch weight shape -> dffx (kd, kh, kw, Cin, Cout)."""
    if transposed:  # (Cin, Cout, d, h, w)
        return (*shape[2:], shape[0], shape[1])
    return (*shape[2:], shape[1], shape[0])  # (Cout, Cin, d, h, w)


def init_module_params(module: nn.Module, seed: int = 0) -> Dict[str, np.ndarray]:
    """Fresh parameters for ``module``'s state_dict keys, in the JAX package's
    layout and draw.  Convs inside a module that sets ``msra_init`` (DFFNet,
    whose reference constructor runs an init loop over its own modules,
    `Depth_Estimation_Network.py:59-73`) draw ``N(0, sqrt(2 / (prod(k) *
    Cout)))``; every other conv keeps torch's default ``U(+-1/sqrt(Cin *
    prod(k)))`` and its bias ``U(+-1/sqrt(Cin * prod(k)))``; deconvs draw
    ``U(+-1/sqrt(Cout * prod(k)))``; BN weight/var 1, bias/mean 0."""
    msra_roots = [f"{name}." if name else "" for name, m in module.named_modules()
                  if getattr(m, "msra_init", False)]
    kinds = {}
    for name, m in module.named_modules():
        pfx = f"{name}." if name else ""
        if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d)):
            tr = isinstance(m, nn.ConvTranspose3d)
            if tr:
                if m.bias is not None:
                    raise ValueError(f"{name}: deconv biases are not part of the model")
                kind = "deconv"
            else:
                kind = ("conv_msra" if any(pfx.startswith(r) for r in msra_roots)
                        else "conv_default")
            kinds[pfx + "weight"] = (kind, _dhwio(m.weight.shape, tr))
            if m.bias is not None:
                fan_in = math.prod(m.weight.shape[1:])
                kinds[pfx + "bias"] = ("bias", tuple(m.bias.shape), fan_in)
        elif isinstance(m, nn.BatchNorm3d):
            c = (m.num_features,)
            kinds.update({pfx + "weight": ("one", c), pfx + "bias": ("zero", c),
                          pfx + "running_mean": ("zero", c),
                          pfx + "running_var": ("one", c),
                          pfx + "num_batches_tracked": ("count", ())})
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}
    for key, (kind, shape, *fan_in) in sorted(kinds.items()):
        if kind == "conv_msra":
            *k, _cin, cout = shape
            v = rng.normal(0.0, math.sqrt(2.0 / (math.prod(k) * cout)), size=shape)
        elif kind == "conv_default":
            *k, cin, _cout = shape
            bound = 1.0 / math.sqrt(cin * math.prod(k))
            v = rng.uniform(-bound, bound, size=shape)
        elif kind == "bias":
            bound = 1.0 / math.sqrt(fan_in[0])
            v = rng.uniform(-bound, bound, size=shape)
        elif kind == "deconv":
            *k, _cin, cout = shape
            bound = 1.0 / math.sqrt(cout * math.prod(k))
            v = rng.uniform(-bound, bound, size=shape)
        elif kind == "count":
            out[key] = np.zeros(shape, dtype=np.int64)
            continue
        else:
            v = (np.ones if kind == "one" else np.zeros)(shape)
        out[key] = v.astype(np.float32)
    return out
