"""Weights into the port: the JAX package's param dicts and reference ``.pth``
files.

Keys are shared by all three (reference, ``dffx``, ``dffx_torch``); only conv
weight layouts differ.  ``load_jax_params`` undoes the JAX package's layout by
the type of module that owns each weight (the inverse of
``dffx/checkpoint.py::from_torch_state_dict``):

* Conv3d weight           ``(kd, kh, kw, Cin, Cout)`` -> ``(Cout, Cin, kd, kh, kw)``
* ConvTranspose3d weight  ``(kd, kh, kw, Cin, Cout)`` -> ``(Cin, Cout, kd, kh, kw)``
* conv biases (the FlowNetwork heads' last conv) and BN tensors pass through;
  ``num_batches_tracked`` becomes int64.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def _check_keys(got, want) -> None:
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(
            f"key mismatch: {len(missing)} missing {missing[:5]}, "
            f"{len(extra)} extra {extra[:5]}")


def load_jax_params(module: nn.Module, params: Mapping[str, np.ndarray]) -> nn.Module:
    """Load a ``dffx`` parameter dict (arrays in DHWIO layout) into ``module``."""
    own = module.state_dict()
    _check_keys(params, own)
    owners = dict(module.named_modules())
    sd: Dict[str, torch.Tensor] = {}
    for key, ref in own.items():
        arr = np.asarray(params[key])
        owner_name, _, leaf = key.rpartition(".")
        owner = owners[owner_name]
        if leaf == "weight" and isinstance(owner, nn.ConvTranspose3d):
            arr = arr.transpose(3, 4, 0, 1, 2)
        elif leaf == "weight" and isinstance(owner, nn.Conv3d):
            arr = arr.transpose(4, 3, 0, 1, 2)
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: shape {arr.shape} != module's {tuple(ref.shape)}")
        sd[key] = torch.from_numpy(np.array(arr, order="C")).to(ref.dtype)
    module.load_state_dict(sd)
    return module


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``check_point.pth`` as a state dict for ``Network`` or
    ``E2ENetwork``, ``module.`` prefixes (the DataParallel save flavour)
    stripped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
