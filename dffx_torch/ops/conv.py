"""3D convolution and transposed convolution in ``(B, C, N, H, W)``.

The reference's convs and deconvs (`Depth_Estimation_Network.py:286-289`,
`:41`, `:195`; `End_to_End/End_to_End.py:33-61, :135-145`) are plain ``F.conv3d`` / ``F.conv_transpose3d`` calls; the JAX
package left them to XLA, and the port leaves them to cuDNN.  Weights are in
torch layout and may be kept in fp32: they are cast to the activation dtype
here, as ``dffx`` casts its DHWIO kernels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv3d(x: torch.Tensor, w: torch.Tensor, *, bias=None, stride=1, padding=0,
           dilation=1) -> torch.Tensor:
    """``F.conv3d``: x ``(B, Cin, N, H, W)``, w ``(Cout, Cin, kd, kh, kw)``, an
    optional bias ``(Cout,)`` (the FlowNetwork heads' last conv)."""
    return F.conv3d(x, w.to(x.dtype), None if bias is None else bias.to(x.dtype),
                    stride=stride, padding=padding, dilation=dilation)


def deconv3d(x: torch.Tensor, w: torch.Tensor, *, stride=(1, 2, 2), padding=1,
             output_padding=(0, 1, 1)) -> torch.Tensor:
    """Bias-free ``F.conv_transpose3d``: w ``(Cin, Cout, kd, kh, kw)``.

    Defaults are the only configuration the reference uses: k3, pad 1,
    stride ``(1, 2, 2)`` and ``output_padding=(0, 1, 1)``, which doubles H and
    W and keeps the focus axis N."""
    return F.conv_transpose3d(x, w.to(x.dtype), stride=stride, padding=padding,
                              output_padding=output_padding)
