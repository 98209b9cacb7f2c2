"""Pooling in ``(B, C, N, H, W)``: the EFD max-pool
(`Depth_Estimation_Network.py:310`), the hourglassup avg-pool pyramid
(`:149-153`) and the motion heads' ``AdaptiveAvgPool3d((10, 1, 1))``
(`End_to_End/End_to_End.py:40`).  The focus axis N is never strided."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool3d(x: torch.Tensor, window, stride=None) -> torch.Tensor:
    """``nn.MaxPool3d(window, stride)``, no padding."""
    return F.max_pool3d(x, window, stride if stride is not None else window)


def avg_pool3d(x: torch.Tensor, window, stride=None) -> torch.Tensor:
    """``nn.AvgPool3d(window, stride)``, no padding."""
    return F.avg_pool3d(x, window, stride if stride is not None else window)


def adaptive_avg_pool_focus(x: torch.Tensor, n_out: int) -> torch.Tensor:
    """``nn.AdaptiveAvgPool3d((n_out, 1, 1))`` as ``dffx`` computes it: the
    mean over H and W (summed in fp32), then torch's segment rule over N,
    ``[floor(i * N / n_out), ceil((i + 1) * N / n_out))``.  Returns
    ``(B, C, n_out, 1, 1)`` in x.dtype."""
    n = x.shape[2]
    pooled = torch.mean(x, dim=(3, 4), dtype=torch.float32).to(x.dtype)  # (B, C, N)
    if n != n_out:
        segs = [pooled[:, :, (i * n) // n_out: -(-((i + 1) * n) // n_out)].mean(dim=2)
                for i in range(n_out)]
        pooled = torch.stack(segs, dim=2)
    return pooled[..., None, None]
