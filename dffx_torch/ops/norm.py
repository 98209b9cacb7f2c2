"""BatchNorm over channel dim 1, with the JAX package's numerics
(``dffx/ops/norm.py``).

* eval: normalize with the running statistics; the affine is folded in fp32,
  cast to the activation dtype, and applied as ``x * scale + shift``;
* train: normalize with the biased batch variance ``E[x^2] - mean^2`` (one
  pass, fp32, over every axis but C), and update the running statistics at
  momentum 0.1 with the unbiased variance ``var * n / (n - 1)``, ``n`` the
  number of values a channel has in the batch (torch's ``nn.BatchNorm3d``).
"""

from __future__ import annotations

from typing import Tuple

import torch

EPS = 1e-5
MOMENTUM = 0.1  # torch default: new = (1 - m) * old + m * batch


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


def batch_norm_train(x: torch.Tensor, running_mean, running_var, weight, bias, *,
                     eps: float = EPS, momentum: float = MOMENTUM
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training-mode BatchNorm of ``x (B, C, ...)``.

    Returns ``(y, new_running_mean, new_running_var)``.  ``y`` carries the
    gradient through the batch statistics; the new running statistics are
    fp32 and carry none."""
    xf = x.float()
    dims = [0, *range(2, x.dim())]
    n = x.numel() // x.shape[1]
    mean = xf.mean(dims)
    var = xf.square().mean(dims) - mean.square()  # biased, used for normalization
    y = batch_norm(x, mean, var, weight, bias, eps=eps)
    with torch.no_grad():
        unbiased = var * (n / max(n - 1, 1))
        new_mean = (1.0 - momentum) * running_mean.float() + momentum * mean
        new_var = (1.0 - momentum) * running_var.float() + momentum * unbiased
    return y, new_mean, new_var
