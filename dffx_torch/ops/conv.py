"""3D convolution and transposed convolution in ``(B, C, N, H, W)``.

The reference's convs and deconvs (`Depth_Estimation_Network.py:286-289`,
`:41`, `:195`; `End_to_End/End_to_End.py:33-61, :135-145`) are plain ``F.conv3d`` / ``F.conv_transpose3d`` calls; the JAX
package left them to XLA, and the port leaves them to cuDNN.  Weights are in
torch layout and may be kept in fp32: they are cast to the activation dtype
here, as ``dffx`` casts its kernels.

The logical shape is always ``(B, C, N, H, W)``; the memory layout is the
activations' own.  cuDNN's 16-bit convs and deconvs run NDHWC kernels, and an
NCDHW operand costs them a transpose in and one out, so DFFNet's 16-bit eval
activations are ``torch.channels_last_3d`` (``activation_format``).  Each
conv and deconv of a 16-bit input adds one to the counter
``stock.conv_ndhwc`` (an NDHWC input) or ``stock.conv_ncdhw`` (any other,
which cuDNN transposes) while the program's counters record
(``utils/profiling.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.nn.modules.utils import _triple

from dffx_torch.utils import profiling

_HALF = (torch.bfloat16, torch.float16)


def activation_format(x: torch.Tensor, training: bool) -> torch.memory_format:
    """The memory layout DFFNet keeps its activations in after the
    focus-measure chain, from what ``x`` shows: ``channels_last_3d`` (NDHWC)
    for bf16 and fp16 in eval mode, where cuDNN's convs read and write NDHWC;
    ``contiguous_format`` (NCDHW) for fp32, whose cuDNN kernels are NCDHW,
    and for training."""
    if x.dtype in _HALF and not training:
        return torch.channels_last_3d
    return torch.contiguous_format


def is_ndhwc(x: torch.Tensor) -> bool:
    """Whether ``x`` is laid out NDHWC and not NCDHW (a tensor whose size-1
    axes make it both counts as NCDHW)."""
    return (x.dim() == 5 and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last_3d))


def layout_of(x: torch.Tensor) -> torch.memory_format:
    """``x``'s layout: ``channels_last_3d`` if it is NDHWC, else
    ``contiguous_format``."""
    return torch.channels_last_3d if is_ndhwc(x) else torch.contiguous_format


def ndhwc_weight(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A conv or deconv weight as cuDNN reads it for an NDHWC ``x``: in x's
    dtype and NDHWC (what ``layers.Conv3d`` keeps in a ``ParamCache``)."""
    return w.to(x.dtype).contiguous(memory_format=torch.channels_last_3d)


def _count_layout(x: torch.Tensor, ndhwc: bool) -> None:
    if x.dtype in _HALF:
        profiling.count("stock.conv_ndhwc" if ndhwc else "stock.conv_ncdhw")


def conv3d(x: torch.Tensor, w: torch.Tensor, *, bias=None, stride=1, padding=0,
           dilation=1) -> torch.Tensor:
    """``F.conv3d``: x ``(B, Cin, N, H, W)``, w ``(Cout, Cin, kd, kh, kw)``, an
    optional bias ``(Cout,)`` (the FlowNetwork heads' last conv).  On the card
    the output has x's layout.

    Two kinds of conv on an NDHWC ``x`` avoid kernels of cuDNN that would
    transpose it, with the same sums: one output channel (``_one_channel``)
    and a kernel that spans N alone (``_along_n``)."""
    ndhwc = is_ndhwc(x)
    _count_layout(x, ndhwc)
    w = w.to(x.dtype)
    bias = None if bias is None else bias.to(x.dtype)
    if ndhwc:
        stride, padding, dilation = _triple(stride), _triple(padding), _triple(dilation)
        if w.shape[0] == 1:
            return _one_channel(x, w, bias, stride, padding, dilation)
        if (w.shape[2] > 1 and w.shape[3:] == (1, 1) and stride[1:] == (1, 1)
                and padding[1:] == (0, 0)):
            return _along_n(x, w, bias, stride, padding, dilation)
    return F.conv3d(x, w, bias, stride=stride, padding=padding, dilation=dilation)


def _one_channel(x, w, bias, stride, padding, dilation) -> torch.Tensor:
    """A conv to one channel (the heads' last convs) of an NDHWC ``x``, which
    cuDNN writes NCDHW and transposes: a pointwise one as a product over x's
    channel axis (``F.linear`` on its channels-last view, a GEMM), any other
    with the weight padded to eight output channels, of which the first is
    kept."""
    if w.shape[2:] == (1, 1, 1) and stride == (1, 1, 1) and padding == (0, 0, 0):
        y = F.linear(x.permute(0, 2, 3, 4, 1), w.reshape(1, -1), bias)
        return y.permute(0, 4, 1, 2, 3)
    w = F.pad(w, (0, 0, 0, 0, 0, 0, 0, 0, 0, 7))
    bias = None if bias is None else F.pad(bias, (0, 7))
    return F.conv3d(x, w, bias, stride=stride, padding=padding, dilation=dilation)[:, :1]


def _along_n(x, w, bias, stride, padding, dilation) -> torch.Tensor:
    """A ``(kd, 1, 1)`` conv (the SRDs' focus-axis attention) of an NDHWC
    ``x`` as ``F.conv2d`` over its channels-last ``(B, Cin, N, H * W)`` view:
    for such a kernel cuDNN's 3D heuristics choose an fp32 NCDHW engine with
    a transpose on each side, its 2D ones the NHWC tensor-core conv."""
    b, c, n, h, wd = x.shape
    w = w[..., 0].contiguous(memory_format=torch.channels_last)  # a view if kept NDHWC
    y = F.conv2d(x.view(b, c, n, h * wd), w, bias, stride=(stride[0], 1),
                 padding=(padding[0], 0), dilation=(dilation[0], 1))
    return y.unflatten(3, (h, wd))


def deconv3d(x: torch.Tensor, w: torch.Tensor, *, stride=(1, 2, 2), padding=1,
             output_padding=(0, 1, 1)) -> torch.Tensor:
    """Bias-free ``F.conv_transpose3d``: w ``(Cin, Cout, kd, kh, kw)``.

    Defaults are the only configuration the reference uses: k3, pad 1,
    stride ``(1, 2, 2)`` and ``output_padding=(0, 1, 1)``, which doubles H and
    W and keeps the focus axis N.  On the card the output has x's layout."""
    _count_layout(x, is_ndhwc(x))
    return F.conv_transpose3d(x, w.to(x.dtype), stride=stride, padding=padding,
                              output_padding=output_padding)
