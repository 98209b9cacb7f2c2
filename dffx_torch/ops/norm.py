"""BatchNorm over channel dim 1, with the JAX package's numerics
(``dffx/ops/norm.py``).

* eval: normalize with the running statistics; the affine is folded in fp32,
  cast to the activation dtype, and applied as ``x * scale + shift``
  (``batch_norm``), or by ``affine_act`` with a residual add and a ReLU after
  it: for a 16-bit activation outside autograd in one pass of
  ``kernels.bn_act``, else (fp32, or autograd recording) as ATen's ops;
  ``affine_act_pool`` adds the 2x2 max-pool that reads a BN-ReLU (DDFFNet's
  encoder), in one pass of ``kernels.bn_act_pool`` where that kernel reads
  the activation, else as ``affine_act`` then ``max_pool3d``;
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

from typing import Optional, Tuple

import torch

from dffx_torch.ops.pool import max_pool3d
from dffx_torch.parallel.distributed import all_reduce_
from dffx_torch.utils import profiling

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


def _apply_affine(x: torch.Tensor, scale, shift) -> torch.Tensor:
    """``x * scale + shift`` over channel dim 1, both cast to x's dtype."""
    view = (1, -1) + (1,) * (x.dim() - 2)
    return x * scale.to(x.dtype).view(view) + shift.to(x.dtype).view(view)


def batch_norm(x: torch.Tensor, mean, var, weight, bias, *, eps: float = EPS
               ) -> torch.Tensor:
    """Normalize ``x (B, C, ...)`` with given running statistics."""
    return _apply_affine(x, *bn_fused_affine(weight, bias, mean, var, eps))


def takes_pass(x: torch.Tensor, scale, shift, z=None) -> bool:
    """Whether ``affine_act`` applies an eval BN in ``kernels.bn_act``'s one
    pass: a 16-bit activation, and no autograd recording (the pass has no
    backward).  There is no other case: ``bn_act`` takes every dense layout
    and raises on what it cannot read."""
    reads = (x, scale, shift) if z is None else (x, scale, shift, z)
    return (x.dtype in (torch.bfloat16, torch.float16)
            and not (torch.is_grad_enabled() and any(t.requires_grad for t in reads)))


def affine_act(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, *, z=None,
               relu: bool = False) -> torch.Tensor:
    """An eval BatchNorm's folded affine ``(scale, shift)``, ``(C,)`` each,
    then a residual ``z`` and a ReLU where given: ``relu?(x * scale + shift
    (+ z))``.  Where ``takes_pass`` says so, ``kernels.bn_act`` (a CUDA
    kernel, or its twin on the CPU) computes it in fp32 with one rounding and
    the counter ``stock.bn_fused`` adds one; otherwise (fp32, or autograd
    recording) ATen's ops do, each rounding to x's dtype as ``batch_norm``
    does (bit for bit its result in fp32), and ``stock.bn_aten`` adds one."""
    if takes_pass(x, scale, shift, z):
        from dffx_torch.ops import kernels  # kernels imports this module

        y = kernels.bn_act(x, scale, shift, z, relu)
        profiling.count("stock.bn_fused")
        return y
    profiling.count("stock.bn_aten")
    y = _apply_affine(x, scale, shift)
    if z is not None:
        y = y + z
    return torch.relu(y) if relu else y


def takes_pool_pass(x: torch.Tensor, scale, shift) -> bool:
    """Whether ``affine_act_pool`` runs ``kernels.bn_act_pool``'s one pass:
    where ``takes_pass`` sends the BN to a pass (16-bit, no autograd
    recording) and the kernel reads ``x`` (``kernels.bn_act_pool_takes``:
    NDHWC, C % 8 == 0, H and W even, aligned)."""
    from dffx_torch.ops import kernels  # kernels imports this module

    return takes_pass(x, scale, shift) and kernels.bn_act_pool_takes(x)


def affine_act_pool(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, *,
                    keep: bool = False) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """An eval BatchNorm's folded affine and the ReLU after it, then the
    (1, 2, 2) max-pool of the result: ``(y, max_pool3d(y, (1, 2, 2)))`` with
    ``y = relu(x * scale + shift)`` where ``keep``, else ``(None, ...)``.
    Where ``takes_pool_pass`` says so, ``kernels.bn_act_pool`` (a CUDA kernel,
    or its twin on the CPU) computes both in one pass, bit for bit what the two
    ops give, and the counters ``stock.bn_fused`` and ``stock.pool_fused``
    add one; otherwise ``affine_act`` (which counts the BN) then
    ``max_pool3d`` (which counts ``stock.pool_aten``)."""
    if takes_pool_pass(x, scale, shift):
        from dffx_torch.ops import kernels

        y, pooled = kernels.bn_act_pool(x, scale, shift, keep)
        profiling.count("stock.bn_fused")
        profiling.count("stock.pool_fused")
        return y, pooled
    y = affine_act(x, scale, shift, relu=True)
    return (y if keep else None), max_pool3d(y, (1, 2, 2))


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
