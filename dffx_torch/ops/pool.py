"""Pooling in ``(B, C, N, H, W)``: the EFD max-pool
(`Depth_Estimation_Network.py:310`), the hourglassup avg-pool pyramid
(`:149-153`), the motion heads' ``AdaptiveAvgPool3d((10, 1, 1))``
(`End_to_End/End_to_End.py:40`), DFV's pyramid pooling, whose decoders'
windows span N too, and DDFFNet's 2x2 max-pools.  The max- and avg-pools
keep an NDHWC input NDHWC (``ops/conv.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.nn.modules.utils import _triple

from dffx_torch.ops.conv import is_ndhwc, per_slice
from dffx_torch.utils import profiling


def max_pool3d(x: torch.Tensor, window, stride=None) -> torch.Tensor:
    """``nn.MaxPool3d(window, stride)``, no padding, counted as
    ``stock.pool_aten``.  ``F.max_pool3d`` keeps an NDHWC input NDHWC, on the
    card and on the CPU; for DDFFNet's five (1, 2, 2) pools of a b32 forward
    it took 37.7 ms on an H100 against 46.0 for ``F.max_pool2d`` on each
    slice's channels-last view (PERF.md §6).  A 16-bit eval forward of
    DDFFNet pools in ``norm.affine_act_pool``'s one pass instead."""
    profiling.count("stock.pool_aten")
    return F.max_pool3d(x, window, stride if stride is not None else window)


def avg_pool3d(x: torch.Tensor, window, stride=None) -> torch.Tensor:
    """``nn.AvgPool3d(window, stride)``, no padding.

    ``F.avg_pool3d`` returns NCDHW whatever its input's layout, so an NDHWC
    ``x`` pooled over H and W alone runs as ``F.avg_pool2d`` on its
    channels-last ``(B * N, C, H, W)`` view: the same fp32 sum over the same
    window in the same order, and an NDHWC output with no copy.  Pooled over
    N too, its output is copied to NDHWC (DFV's decoders: at most a few
    values a channel); the CPU, which has no 16-bit ``avg_pool3d``, sums in
    fp32 as the card does."""
    window = _triple(window)
    stride = _triple(stride if stride is not None else window)
    if not is_ndhwc(x):
        return F.avg_pool3d(x, window, stride)
    if window[0] != 1 or stride[0] != 1:
        y = F.avg_pool3d(x if x.is_cuda else x.float(), window, stride).to(x.dtype)
        return y.contiguous(memory_format=torch.channels_last_3d)
    return per_slice(x, lambda y: F.avg_pool2d(y, window[1:], stride[1:]))


def adaptive_avg_pool_focus(x: torch.Tensor, n_out: int) -> torch.Tensor:
    """``nn.AdaptiveAvgPool3d((n_out, 1, 1))`` as ``dffx`` computes it: the
    mean over H and W (summed in fp32, or float64 for a float64 ``x``), then
    torch's segment rule over N, ``[floor(i * N / n_out), ceil((i + 1) * N /
    n_out))``.  Returns
    ``(B, C, n_out, 1, 1)`` in x.dtype."""
    n = x.shape[2]
    wide = torch.promote_types(x.dtype, torch.float32)
    pooled = torch.mean(x, dim=(3, 4), dtype=wide).to(x.dtype)  # (B, C, N)
    if n != n_out:
        segs = [pooled[:, :, (i * n) // n_out: -(-((i + 1) * n) // n_out)].mean(dim=2)
                for i in range(n_out)]
        pooled = torch.stack(segs, dim=2)
    return pooled[..., None, None]
