"""Softplus-normalised soft-argmax over the focus axis
(`Depth_Estimation_Network.py:88-90, :116-126`):

    p = softplus(cost) + 1e-6;  p /= sum_N p;  depth = sum_N focus_dist * p
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def softplus_argmax(cost: torch.Tensor, focus_dists: torch.Tensor) -> torch.Tensor:
    """cost ``(B, N, H, W)``, focus_dists ``(B, N)`` -> ``(B, H, W)``.

    Computed in fp32 and cast back to ``cost.dtype``."""
    p = F.softplus(cost.float()) + 1e-6
    p = p / p.sum(dim=1, keepdim=True)
    return torch.einsum("bnhw,bn->bhw", p, focus_dists.float()).to(cost.dtype)
