"""The plain reference of one train step, in fp32: the network's reference
forward in training mode (BatchNorm on batch statistics, running statistics
updated at momentum 0.1 with the unbiased variance), its loss, the backward,
and Adam (betas 0.9 and 0.99, eps 1e-8) over every weight and bias, written
out here.  The DDFF loss (``loss``), the masked MSE of the four depth heads
weighted 0.3 / 0.5 / 0.7 / 1.0 (`train_code_DDFF.py:143-168`), is the one
DFFNet and E2E train with.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch

LOSS_WEIGHTS = (0.3, 0.5, 0.7, 1.0)  # mid_out, pred1, pred2, pred3
BETAS = (0.9, 0.99)
ADAM_EPS = 1e-8
BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def trainable(key: str) -> bool:
    return not key.endswith(BUFFERS)


def masked_mse(est, gt, mask):
    m = mask.to(est.dtype)
    return (m * (est - gt).square()).sum() / m.sum().clamp(min=1.0)


def loss(outs, batch) -> torch.Tensor:
    return sum(w * masked_mse(o, batch["depth"], batch["mask"])
               for w, o in zip(LOSS_WEIGHTS, outs[:4]))


class Adam:
    """Adam with bias correction, as the published scripts configure
    ``torch.optim.Adam``: m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2,
    p -= lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)."""

    def __init__(self, lr: float):
        self.lr, self.t = lr, 0
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        b1, b2 = BETAS
        self.t += 1
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, g in grads.items():
            m = self.m.setdefault(k, torch.zeros_like(g)).mul_(b1).add_(g, alpha=1 - b1)
            v = self.v.setdefault(k, torch.zeros_like(g)).mul_(b2).addcmul_(g, g, value=1 - b2)
            params[k].sub_(self.lr * (m / c1) / ((v / c2).sqrt() + ADAM_EPS))


def step(net, params: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
         opt: Adam, compute=contextlib.nullcontext) -> Tuple[float, Dict[str, torch.Tensor],
                                                            Tuple[torch.Tensor, ...]]:
    """One step of the network module ``net`` (``portbench/networks``) on
    ``batch`` (its ``INPUT_KEYS`` and what its loss reads), updating
    ``params`` in place.  Returns (loss, the gradients Adam got, the heads
    ``net.TRAIN_HEADS`` of the forward).  The forward and the backward run
    under ``compute()`` (the control's ``lowp.fp8``); Adam runs outside it."""
    keys = [k for k in params if trainable(k)]
    for k in keys:
        params[k].requires_grad_(True)
    inputs = [batch[k] for k in net.INPUT_KEYS]
    with compute():
        outs = net.reference(params, inputs, train=True)
        total = net.reference_loss(outs, batch)
        grads = dict(zip(keys, torch.autograd.grad(total, [params[k] for k in keys],
                                                   allow_unused=True)))
    grads = {k: torch.zeros_like(params[k]) if g is None else g for k, g in grads.items()}
    for k in keys:
        params[k].requires_grad_(False)
    opt.step(params, grads)
    heads = outs[:len(net.TRAIN_HEADS)]
    return float(total.detach()), grads, tuple(o.detach() for o in heads)
