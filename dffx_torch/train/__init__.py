"""dffx_torch.train — the train step of ``dffx.train`` in PyTorch.

``create_train_state`` / ``make_train_step`` (``dffx_torch.train.loop``) take
one step of train-mode BatchNorm, the weighted masked MSE over the four depth
heads and Adam(0.9, 0.99) over the weights and biases, on stock ops (the CUDA
kernels are eval-only, as the Pallas kernels are in ``dffx``).  The per-dataset
loss settings are ``dffx_torch.train.recipes.RECIPES``; the train state goes to
and from ``dffx``'s checkpoint format through ``dffx_torch.checkpoint``.
"""

from dffx_torch.train.loop import (
    LossConfig,
    TrainState,
    conf_masked_mse,
    create_train_state,
    make_train_step,
    masked_mse,
    total_loss,
)

__all__ = [
    "LossConfig",
    "TrainState",
    "conf_masked_mse",
    "create_train_state",
    "make_train_step",
    "masked_mse",
    "total_loss",
]
