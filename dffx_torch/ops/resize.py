"""Bilinear 2D upsampling, torch-1.6 ``F.upsample(mode='bilinear')`` semantics
(`Depth_Estimation_Network.py:86,111,113`): ``align_corners=False``."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """Resize the two trailing axes of a ``(B, N, H, W)`` cost volume."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)
