"""Inputs made from the run's seed, on the device, in a few large calls.

The serving generators are frozen copies of ``dffx_torch/headline.py``'s
(``uniform``, ``focus_dists``, ``dffnet_inputs``, ``e2e_inputs``): stacks in
U[-1, 1), focus distances evenly spaced over the configuration's range,
fields of view evenly spaced over theirs.  ``serving_inputs`` asks the
configuration's network module (``portbench/networks``) for its inputs;
``train_batches`` makes the train feed's host batches.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench import networks


def uniform(shape, dtype, dev, gen) -> torch.Tensor:
    """U[-1, 1) made on ``dev`` directly in ``dtype``."""
    return torch.rand(shape, generator=gen, device=dev, dtype=dtype).mul_(2).sub_(1)


def focus_dists(b: int, n: int, dev, lo: float, hi: float) -> torch.Tensor:
    return torch.linspace(lo, hi, n, device=dev).expand(b, n).contiguous()


def serving_inputs(config: dict, b: int, dtype, dev, gen) -> List[torch.Tensor]:
    """The inputs of one request or batch of the configuration's network:
    the stack ``(B, N, H, W, 3)`` in ``dtype`` first."""
    return networks.load(config["network"]).serving_inputs(config, b, dtype, dev, gen)


def train_batches(config: dict, b: int, count: int, dev, gen) -> List[Dict[str, np.ndarray]]:
    """``count`` host batches of the train step, made on ``dev`` and copied
    out: fs U[-1, 1) fp32 at the train crop; each row's depth uniform over a
    window of half the unit range starting at a U[0, 0.5) offset of its own,
    as scenes near and far share a batch; every pixel valid; focus distances
    evenly spaced over the train range; then what else the network's forward
    reads (``train_extras``: E2E's fields of view)."""
    extras = networks.load(config["network"]).train_extras
    n, h, w = config["train_stack"]
    lo, hi = config["train_focus"]
    out = []
    for _ in range(count):
        offset = 0.5 * torch.rand((b, 1, 1), generator=gen, device=dev)
        depth = offset + 0.5 * torch.rand((b, h, w), generator=gen, device=dev)
        batch = {"fs": uniform((b, n, h, w, 3), torch.float32, dev, gen),
                 "depth": depth,
                 "focus_dists": focus_dists(b, n, dev, lo, hi),
                 "mask": torch.ones((b, h, w), dtype=torch.bool, device=dev),
                 **extras(config, b, dev)}
        out.append({k: v.cpu().numpy() for k, v in batch.items()})
    return out
