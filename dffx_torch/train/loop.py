"""The train step: forward with train-mode BatchNorm, the weighted masked MSE
over the four depth heads, the backward, and one Adam(0.9, 0.99) step over the
weights and biases; the BN running statistics update in the forward.

The counterpart of ``dffx/train/loop.py`` (the template of the reference
``train_code_*.py`` scripts, `train_code_DDFF.py:143-168`): loss weights mid
0.3 / D2 0.5 / D3 0.7 / D4 1.0, the per-recipe normalisation of predictions
and ground truth, and the confidence-weighted MSE of the Smartphone recipe.
The model runs on stock ops in training mode (``.train()``): no CUDA kernel
launches, as no Pallas kernel runs under ``dffx``'s ``Ctx.train``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
from torch import nn

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


def masked_mse(est: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean squared error over masked pixels (= torch MSELoss(est[mask], gt[mask]));
    0 for an empty mask."""
    num, den = _weighted_sq_sums(est, gt, mask)
    return num / den.clamp(min=1.0)


def conf_masked_mse(est, gt, conf, mask) -> torch.Tensor:
    """Confidence-weighted MSE over masked pixels (the Smartphone recipe)."""
    num, den = _weighted_sq_sums(est, gt, conf.float() * mask.float())
    return num / den.clamp(min=1e-12)


def total_loss(outs, batch: Dict[str, torch.Tensor], cfg: LossConfig
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted four-head loss of ``outs = (mid, pred1, pred2, pred3, ...)``
    against ``batch["depth"]`` over ``batch["mask"]`` (and ``batch["conf"]``
    with ``cfg.conf_weighted``)."""
    mid, p1, p2, p3 = outs[:4]
    gt, mask = batch["depth"], batch["mask"]

    def norm(x):
        if cfg.norm_range is None:
            return x
        lo, hi = cfg.norm_range
        return (x - lo) / (hi - lo)

    gt_n = norm(gt)
    mid_n, mid_gt = (norm(mid), gt_n) if cfg.normalize_mid else (mid, gt)

    def term(est, target):
        if cfg.conf_weighted:
            return conf_masked_mse(est, target, batch["conf"], mask)
        return masked_mse(est, target, mask)

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
    optimizer sees (``dffx``'s ``trainable_mask``)."""
    return TrainState(0, model, torch.optim.Adam(model.parameters(), lr=lr, betas=BETAS,
                                                 eps=ADAM_EPS))


def make_train_step(lr: float, loss_cfg: LossConfig, *, e2e: bool = False,
                    compute_dtype: torch.dtype = torch.float32, remat: bool = False,
                    sanitize: bool = False
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """The train step ``(state, batch) -> (state, logs)``, updating the state
    in place.

    ``batch`` holds ``fs (B, N, H, W, 3)``, ``depth (B, H, W)``,
    ``focus_dists (B, N)``, ``mask (B, H, W)`` and, as needed, ``conf`` and
    (``e2e``) ``fovs``, on the model's device.  The step puts the model in
    training mode, casts ``fs`` to ``compute_dtype`` (parameters stay fp32;
    convs cast them at use), takes the loss in fp32 on the heads cast to
    fp32, and steps Adam at ``lr``.  A parameter the loss does not reach gets
    a zero gradient, so that Adam counts every step for every parameter as
    ``optax`` does.  ``remat``: the model's stages recompute their
    activations in the backward.  The logs are detached scalars ``loss``,
    ``mid_loss``, ``loss1..3`` and, with ``sanitize``, ``nonfinite_grads``."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model, opt = state.model.train(), state.optimizer
        extra = (batch["fovs"],) if e2e else ()
        outs = model(batch["fs"].to(compute_dtype), batch["focus_dists"], *extra, remat=remat)
        total, logs = total_loss(tuple(o.float() for o in outs[:4]), batch, loss_cfg)
        opt.zero_grad(set_to_none=True)
        total.backward()
        params = [p for group in opt.param_groups for p in group["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        logs = {k: v.detach() for k, v in logs.items()}
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
