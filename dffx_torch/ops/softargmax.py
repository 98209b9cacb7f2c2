"""Soft-argmax over the focus axis, DFFNet's softplus-normalised form
(`Depth_Estimation_Network.py:88-90, :116-126`):

    p = softplus(cost) + 1e-6;  p /= sum_N p;  depth = sum_N focus_dist * p

and DFV's softmax regression (its ``disparityregression``), whose spread is
the depth's uncertainty:

    p = softmax_N(cost);  depth = sum_N p * fd;  std = sqrt(sum_N p * (fd - depth)^2)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def softplus_argmax(cost: torch.Tensor, focus_dists: torch.Tensor) -> torch.Tensor:
    """cost ``(B, N, H, W)``, focus_dists ``(B, N)`` -> ``(B, H, W)``.

    Computed in fp32 (float64 for a float64 ``cost``) and cast back to
    ``cost.dtype``."""
    wide = torch.promote_types(cost.dtype, torch.float32)
    p = F.softplus(cost.to(wide)) + 1e-6
    p = p / p.sum(dim=1, keepdim=True)
    return torch.einsum("bnhw,bn->bhw", p, focus_dists.to(wide)).to(cost.dtype)


def softmax_argmax(cost: torch.Tensor, focus_dists: torch.Tensor, *, std: bool = False):
    """cost ``(B, N, H, W)``, focus_dists ``(B, N)`` -> the depth ``(B, H,
    W)``, and with ``std`` also its standard deviation under the softmax
    over N: ``(depth, std)``.

    Computed in fp32 (float64 for a float64 ``cost``) and cast back to
    ``cost.dtype``."""
    wide = torch.promote_types(cost.dtype, torch.float32)
    p = torch.softmax(cost.to(wide), dim=1)
    fd = focus_dists.to(wide)[:, :, None, None]
    depth = (p * fd).sum(dim=1)
    if not std:
        return depth.to(cost.dtype)
    spread = (p * (fd - depth[:, None]).square()).sum(dim=1).sqrt()
    return depth.to(cost.dtype), spread.to(cost.dtype)
