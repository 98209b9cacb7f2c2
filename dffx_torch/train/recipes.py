"""Per-dataset training recipes: every constant of the five reference
``train_code_*.py`` scripts, as ``dffx/train/recipes.py`` tables them.

Shared template: batch 4, Adam(lr, betas=(0.9, 0.99)), loss weights
mid 0.3 / D2 0.5 / D3 0.7 / D4 1.0, save/validate every epoch.  Deltas:

* DDFF         — GT pre-normalized in the loader; plain masked MSE.
* HCI          — test/save/print every 10 epochs; preds+GT normalized by
                 (±2.5) inside the loss but *mid_out is not* (the reference's
                 quirk, `train_code_HCI.py:134-137`); bumpiness metric in val.
* Defocus      — plain.
* FlyingThings — max_epoch 2500 hardcoded; all four preds normalized by
                 [10, 100]; val crops to 540 rows.
* Smartphone   — confidence-weighted masked MSE; normalized by
                 [1/3.91092, 1/0.10201].
* Simulated    — ``dffx``'s end-to-end (alignment + depth) recipe on
                 simulator output.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from dffx_torch.train.loop import LossConfig

SMARTPHONE_MIN = 1 / 3.91092
SMARTPHONE_MAX = 1 / 0.10201


@dataclasses.dataclass(frozen=True)
class Recipe:
    name: str
    loss: LossConfig
    e2e: bool = False  # train alignment + depth end-to-end (needs fovs)
    batch_size: int = 4
    max_epoch: int = 1000
    test_epoch: int = 1
    save_epoch: int = 1
    print_epoch: int = 1
    val_metrics: Tuple[str, ...] = (
        "mse", "mae", "abs_rel", "sq_rel", "rmse", "rmse_log",
        "accuracy_1", "accuracy_2", "accuracy_3",
    )
    val_crop_rows: Optional[int] = None  # FlyingThings validates on 540 rows


RECIPES = {
    "DDFF": Recipe(name="DDFF", loss=LossConfig()),
    "HCI": Recipe(
        name="HCI",
        loss=LossConfig(norm_range=(-2.5, 2.5), normalize_mid=False),
        test_epoch=10,
        save_epoch=10,
        print_epoch=10,
        val_metrics=("mse", "mae", "bumpiness", "rmse"),
    ),
    "Defocus": Recipe(name="Defocus", loss=LossConfig()),
    "FlyingThings": Recipe(
        name="FlyingThings",
        loss=LossConfig(norm_range=(10.0, 100.0)),
        max_epoch=2500,
        val_crop_rows=540,
    ),
    "Smartphone": Recipe(
        name="Smartphone",
        loss=LossConfig(norm_range=(SMARTPHONE_MIN, SMARTPHONE_MAX), conf_weighted=True),
        val_metrics=("mse", "mae"),
    ),
    "Simulated": Recipe(
        name="Simulated",
        loss=LossConfig(),
        e2e=True,
        val_metrics=("mse", "mae", "rmse"),
    ),
}
