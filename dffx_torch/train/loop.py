"""The train step: forward with train-mode BatchNorm, the weighted masked MSE
over the four depth heads, the backward, and one Adam(0.9, 0.99) step over the
weights and biases; the BN running statistics update in the forward.

The counterpart of ``dffx/train/loop.py`` (the template of the reference
``train_code_*.py`` scripts, `train_code_DDFF.py:143-168`): loss weights mid
0.3 / D2 0.5 / D3 0.7 / D4 1.0, the per-recipe normalisation of predictions
and ground truth, and the confidence-weighted MSE of the Smartphone recipe.
The model runs on stock ops in training mode (``.train()``): no CUDA kernel
launches, as no Pallas kernel runs under ``dffx``'s ``Ctx.train``.

**Data parallelism** (``make_train_step(..., mesh=)``, one process a rank,
``dffx_torch.parallel``).  Each rank runs its rows of the global batch.  The
step minimises the sum over ranks of each rank's part of the loss,
``total_r = sum_h w_h num_h,r / den_h``, where ``den_h`` (the masked pixel
count, or the confidence sum) is summed over the ranks without gradient,
then sums the parameter gradients over the ranks with one all-reduce of one
flat buffer: the result is the gradient of one process on the global batch.
The logged losses are the sums of the ranks' parts, ``dffx``'s
``total_loss(..., axis_name=DATA_AXIS)``.  An all-reduce that carried
gradients on the loss itself would make every rank back-propagate the
global loss, a gradient ``world_size`` times too large (``dffx`` notes the
same trap: "an explicit psum double-counts"); PyTorch's
``DistributedDataParallel`` would average, ``1 / world_size`` of it.
``bn_mode="sync"`` (the default) takes every BatchNorm's statistics over all
ranks (``layers.data_parallel``); ``"per_shard"`` over each rank's own rows,
as ``nn.DataParallel`` did, with rank 0's running statistics broadcast after
the step (``dffx``'s replica-0 update).  Every rank steps the same Adam on the
same summed gradients from the parameters ``create_train_state`` broadcast,
so the parameters stay the same bits on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
from torch import nn

from dffx_torch.models.layers import data_parallel
from dffx_torch.parallel import distributed
from dffx_torch.parallel.mesh import DATA_AXIS, Mesh, replicate

BETAS = (0.9, 0.99)  # `train_code_DDFF.py:66`
ADAM_EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Per-recipe loss shaping (``dffx.train.LossConfig``)."""

    weights: Tuple[float, float, float, float] = (0.3, 0.5, 0.7, 1.0)  # mid, D2, D3, D4
    norm_range: Optional[Tuple[float, float]] = None  # (min, max) applied to preds+gt
    normalize_mid: bool = True  # HCI leaves mid_out unnormalized (train_code_HCI.py:134-137)
    conf_weighted: bool = False  # Smartphone confidence-weighted MSE


def _weighted_sq_sums(est, gt, w) -> Tuple[torch.Tensor, torch.Tensor]:
    """(numerator, denominator) of a weighted MSE."""
    w = w.float()
    return (w * (est - gt).square()).sum(), w.sum()


def masked_mse(est: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
               den: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean squared error over masked pixels (= torch MSELoss(est[mask], gt[mask]));
    0 for an empty mask.  ``den``: the count to divide by in place of the
    mask's own (a data-parallel step's count over every rank)."""
    num, own = _weighted_sq_sums(est, gt, mask)
    return num / (own if den is None else den).clamp(min=1.0)


def conf_masked_mse(est, gt, conf, mask, den: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Confidence-weighted MSE over masked pixels (the Smartphone recipe);
    ``den`` as ``masked_mse``'s, a confidence sum."""
    num, own = _weighted_sq_sums(est, gt, conf.float() * mask.float())
    return num / (own if den is None else den).clamp(min=1e-12)


def total_loss(outs, batch: Dict[str, torch.Tensor], cfg: LossConfig, group=None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted four-head loss of ``outs = (mid, pred1, pred2, pred3, ...)``
    against ``batch["depth"]`` over ``batch["mask"]`` (and ``batch["conf"]``
    with ``cfg.conf_weighted``).

    ``group``: this rank's rows are one part of a batch spread over the
    group's ranks.  The MSEs' denominator (the masked pixel count, or the
    confidence sum) is then summed over the ranks, once for the four heads
    and without gradient (the mask and confidence carry none), and the
    result is this rank's part of the global loss; the parts sum over the
    ranks to the loss of the gathered batch (``dffx``'s ``axis_name``)."""
    mid, p1, p2, p3 = outs[:4]
    gt, mask = batch["depth"], batch["mask"]

    def norm(x):
        if cfg.norm_range is None:
            return x
        lo, hi = cfg.norm_range
        return (x - lo) / (hi - lo)

    gt_n = norm(gt)
    mid_n, mid_gt = (norm(mid), gt_n) if cfg.normalize_mid else (mid, gt)

    conf = batch["conf"] if cfg.conf_weighted else None
    den = None
    if group is not None:
        weight = mask.float() if conf is None else conf.float() * mask.float()
        den = distributed.all_reduce_(weight.sum(), group)

    def term(est, target):
        if conf is None:
            return masked_mse(est, target, mask, den)
        return conf_masked_mse(est, target, conf, mask, den)

    losses = [term(norm(p), gt_n) for p in (p1, p2, p3)]
    mid_loss = term(mid_n, mid_gt)
    w_mid, w1, w2, w3 = cfg.weights
    total = w_mid * mid_loss + w1 * losses[0] + w2 * losses[1] + w3 * losses[2]
    return total, {"loss": total, "mid_loss": mid_loss, "loss1": losses[0],
                   "loss2": losses[1], "loss3": losses[2]}


def nonfinite_count(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """Non-finite elements over all floating tensors, one int32 scalar on
    their device (``dffx.utils.sanitize.nonfinite_count``)."""
    counts = [(~torch.isfinite(t)).sum() for t in tensors if t.is_floating_point()]
    return torch.stack(counts).sum().int() if counts else torch.zeros((), dtype=torch.int32)


@dataclasses.dataclass
class TrainState:
    """The step count, the model (its parameters and BN running statistics)
    and the optimizer (Adam's moments)."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer


def create_train_state(model: nn.Module, lr: float) -> TrainState:
    """Adam(lr, betas (0.9, 0.99), eps 1e-8) over ``model.parameters()``: the
    weights and biases.  BN running statistics are buffers, which no
    optimizer sees (``dffx``'s ``trainable_mask``).  In a process group the
    parameters and buffers are broadcast from rank 0 (``replicate_state``)."""
    state = TrainState(0, model, torch.optim.Adam(model.parameters(), lr=lr, betas=BETAS,
                                                  eps=ADAM_EPS))
    return replicate_state(state)


def replicate_state(state: TrainState) -> TrainState:
    """Rank 0's parameters, buffers and Adam moments in every rank's state, in
    place (a fresh state, or one each rank restored); nothing without a
    process group."""
    tensors = list(state.model.state_dict().values())
    for p in state.model.parameters():
        tensors += [v for v in state.optimizer.state.get(p, {}).values()
                    if isinstance(v, torch.Tensor)]
    replicate(tensors)
    return state


def _sum_grads(params, group) -> None:
    """Every gradient summed over ``group``'s ranks: one all-reduce of one
    flat fp32 buffer."""
    flat = distributed.all_reduce_(torch.cat([p.grad.reshape(-1) for p in params]), group)
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad.copy_(g.view_as(p.grad))


def make_train_step(lr: float, loss_cfg: LossConfig, *, e2e: bool = False,
                    compute_dtype: torch.dtype = torch.float32, remat: bool = False,
                    sanitize: bool = False, bn_mode: str = "sync",
                    mesh: Optional[Mesh] = None
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """The train step ``(state, batch) -> (state, logs)``, updating the state
    in place.

    ``batch`` holds ``fs (B, N, H, W, 3)``, ``depth (B, H, W)``,
    ``focus_dists (B, N)``, ``mask (B, H, W)`` and, as needed, ``conf`` and
    (``e2e``) ``fovs``, on the model's device.  The step puts the model in
    training mode, casts ``fs`` to ``compute_dtype`` (parameters stay fp32;
    convs cast them at use), takes the loss in fp32 on the heads cast to
    fp32, and steps Adam at ``lr``.  A float64 model and batch with
    ``compute_dtype=torch.float64`` step in float64 throughout (BN
    statistics, soft-argmax and loss included), which the tests use to tell
    summation order from error.  A parameter the loss does not reach gets
    a zero gradient, so that Adam counts every step for every parameter as
    ``optax`` does.  ``remat``: the model's stages recompute their
    activations in the backward.  The logs are detached scalars ``loss``,
    ``mid_loss``, ``loss1..3`` and, with ``sanitize``, ``nonfinite_grads``.

    ``mesh``: the batch is this rank's rows of a global batch spread over the
    mesh's ``data`` axis (see the module docstring); without a process group
    the mesh has no group and the step is the one-process step.  ``bn_mode``:
    ``"sync"`` takes BatchNorm's statistics over the axis, ``"per_shard"``
    over this rank's rows and then broadcasts the data axis's first rank's
    running statistics; it needs a mesh, as ``dffx``'s does."""
    if bn_mode not in ("sync", "per_shard"):
        raise ValueError(f"bn_mode must be 'sync' or 'per_shard', got {bn_mode!r}")
    if bn_mode == "per_shard" and mesh is None:
        raise ValueError("bn_mode='per_shard' requires a mesh")
    data_group = None if mesh is None else mesh.group(DATA_AXIS)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model, opt = state.model.train(), state.optimizer
        extra = (batch["fovs"],) if e2e else ()
        with data_parallel(data_group if bn_mode == "sync" else None):
            outs = model(batch["fs"].to(compute_dtype), batch["focus_dists"], *extra,
                         remat=remat)
        heads = tuple(o.to(torch.promote_types(o.dtype, torch.float32)) for o in outs[:4])
        total, logs = total_loss(heads, batch, loss_cfg, group=data_group)
        opt.zero_grad(set_to_none=True)
        total.backward()
        params = [p for g in opt.param_groups for p in g["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        logs = {k: v.detach() for k, v in logs.items()}
        if data_group is not None:
            _sum_grads(params, data_group)
            parts = distributed.all_reduce_(torch.stack(list(logs.values())), data_group)
            logs = dict(zip(logs, parts))
            if bn_mode == "per_shard":
                first = mesh.ranks[DATA_AXIS][0]
                for name, buf in model.named_buffers():
                    if name.endswith(("running_mean", "running_var", "num_batches_tracked")):
                        distributed.broadcast_(buf, first, data_group)
        if sanitize:
            logs["nonfinite_grads"] = nonfinite_count(p.grad for p in params)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        state.step += 1
        return state, logs

    return step


def make_eval_fn(*, e2e: bool = False, compute_dtype: torch.dtype = torch.float32
                 ) -> Callable[[nn.Module, Dict[str, torch.Tensor]], Tuple[torch.Tensor, ...]]:
    """The validation forward ``(model, batch) -> outputs``: all four heads
    (and, ``e2e``, the warped stack and the motion) of the model in eval mode
    under ``torch.inference_mode()``, then the model back in training mode.

    Eval mode reads BN's running statistics and writes none, and on the card
    it runs the CUDA kernels, which would raise under autograd
    (``kernels.cuts_gradients``); inference mode records no graph.
    ``batch`` holds ``fs``, ``focus_dists`` and (``e2e``) ``fovs`` on the
    model's device; ``fs`` is cast to ``compute_dtype``."""

    def fwd(model: nn.Module, batch: Dict[str, torch.Tensor]):
        extra = (batch["fovs"],) if e2e else ()
        model.eval()
        try:
            with torch.inference_mode():
                return model(batch["fs"].to(compute_dtype), batch["focus_dists"], *extra)
        finally:
            model.train()

    return fwd
