"""BatchNorm over channel dim 1, with the JAX package's numerics
(``dffx/ops/norm.py``).

* eval: normalize with the running statistics; the affine is folded in fp32,
  cast to the activation dtype, and applied as ``x * scale + shift``;
* train: normalize with the biased batch variance ``E[x^2] - mean^2`` (one
  pass, fp32, or float64 for float64 activations, over every axis but C),
  and update the running statistics at momentum 0.1 with the unbiased
  variance ``var * n / (n - 1)``, ``n`` the number of values a channel has
  in the batch (torch's ``nn.BatchNorm3d``).

With a process group (``group``: sync BN over the data axis, ``dffx``'s
``axis_name``) the fp32 sums of ``x`` and ``x^2`` and each rank's count are
summed over the group's ranks in one all-reduce before they are divided: the
statistics of the global batch, whatever rows each rank holds (``dffx``'s
``sync`` mode is one program over the global batch).
"""

from __future__ import annotations

from typing import Tuple

import torch

from dffx_torch.parallel.distributed import all_reduce_

EPS = 1e-5
MOMENTUM = 0.1  # torch default: new = (1 - m) * old + m * batch


def bn_fused_affine(weight, bias, mean, var, eps: float = EPS
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold eval-mode BatchNorm into an fp32 ``(scale, shift)`` pair (float64
    where the weight or the statistics are)."""
    wide = torch.promote_types(torch.promote_types(weight.dtype, var.dtype), torch.float32)
    scale = weight.to(wide) * torch.rsqrt(var.to(wide) + eps)
    shift = bias.to(wide) - mean.to(wide) * scale
    return scale, shift


def batch_norm(x: torch.Tensor, mean, var, weight, bias, *, eps: float = EPS
               ) -> torch.Tensor:
    """Normalize ``x (B, C, ...)`` with given running statistics."""
    scale, shift = bn_fused_affine(weight, bias, mean, var, eps)
    view = (1, -1) + (1,) * (x.dim() - 2)
    return x * scale.to(x.dtype).view(view) + shift.to(x.dtype).view(view)


class _SumOverRanks(torch.autograd.Function):
    """Sum over a process group's ranks whose backward sums the incoming
    gradient over them too: every rank's loss depends on every rank's
    activations through the summed value."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


def sum_over_ranks(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``'s ranks, differentiably (``_SumOverRanks``)."""
    return _SumOverRanks.apply(x, group)


def batch_norm_train(x: torch.Tensor, running_mean, running_var, weight, bias, *,
                     eps: float = EPS, momentum: float = MOMENTUM, group=None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training-mode BatchNorm of ``x (B, C, ...)``.

    Returns ``(y, new_running_mean, new_running_var)``.  ``y`` carries the
    gradient through the batch statistics; the new running statistics are
    fp32 (float64 for float64 ``x``) and carry none.  ``group``: a process
    group whose ranks' batches together make the statistics (sync BN; one
    all-reduce of ``2 C + 1`` fp32 values: the two sums and the count, which
    carries no gradient)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    dims = [0, *range(2, x.dim())]
    n = x.numel() // x.shape[1]
    if group is None:
        mean, mean_sq = xf.mean(dims), xf.square().mean(dims)
    else:
        sums = sum_over_ranks(torch.cat([xf.sum(dims), xf.square().sum(dims),
                                         xf.new_full((1,), n)]), group)
        n = sums[-1].detach()  # the group's count (exact in fp32 up to 2^24 values)
        mean, mean_sq = sums[:-1].view(2, -1) / n
    var = mean_sq - mean.square()  # biased, used for normalization
    y = batch_norm(x, mean, var, weight, bias, eps=eps)
    with torch.no_grad():
        unbiased = var * (n / max(n - 1, 1) if group is None else n / (n - 1).clamp(min=1))
        new_mean = (1.0 - momentum) * running_mean.to(mean.dtype) + momentum * mean
        new_var = (1.0 - momentum) * running_var.to(mean.dtype) + momentum * unbiased
    return y, new_mean, new_var
