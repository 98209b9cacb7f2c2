"""Eval-mode BatchNorm over channel dim 1, with the JAX package's numerics:
the affine is folded in fp32, cast to the activation dtype, and applied as
``x * scale + shift``."""

from __future__ import annotations

from typing import Tuple

import torch

EPS = 1e-5


def bn_fused_affine(weight, bias, mean, var, eps: float = EPS
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold eval-mode BatchNorm into an fp32 ``(scale, shift)`` pair."""
    scale = weight.float() * torch.rsqrt(var.float() + eps)
    shift = bias.float() - mean.float() * scale
    return scale, shift


def batch_norm(x: torch.Tensor, mean, var, weight, bias, *, eps: float = EPS
               ) -> torch.Tensor:
    """Normalize ``x (B, C, ...)`` with given running statistics."""
    scale, shift = bn_fused_affine(weight, bias, mean, var, eps)
    view = (1, -1) + (1,) * (x.dim() - 2)
    return x * scale.to(x.dtype).view(view) + shift.to(x.dtype).view(view)
