"""(1, k, k) pooling in ``(B, C, N, H, W)``: the EFD max-pool
(`Depth_Estimation_Network.py:310`) and the hourglassup avg-pool pyramid
(`:149-153`).  The focus axis N is never strided."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool3d(x: torch.Tensor, window, stride=None) -> torch.Tensor:
    """``nn.MaxPool3d(window, stride)``, no padding."""
    return F.max_pool3d(x, window, stride if stride is not None else window)


def avg_pool3d(x: torch.Tensor, window, stride=None) -> torch.Tensor:
    """``nn.AvgPool3d(window, stride)``, no padding."""
    return F.avg_pool3d(x, window, stride if stride is not None else window)
