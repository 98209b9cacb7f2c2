"""Weights into the port: the JAX package's param dicts, its ``.ckpt``
checkpoints (format v2) and reference ``.pth`` files.

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

import io
import json
import re
import zipfile
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


FORMAT_VERSION = 2  # the newest dffx checkpoint format read here
_MANIFEST = "__dffx_manifest__"
#: one dict segment ``['name']`` of a ``jax.tree_util.keystr`` path
_SEGMENT = re.compile(r"\['((?:[^'\\]|\\.)*)'\]")


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


def load_dffx_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """The parameters of a checkpoint the JAX package wrote (``dffx.checkpoint.
    save``, format v2), as ``load_jax_params`` takes them (DHWIO arrays).

    The file is a zip whose member ``__dffx_manifest__`` is JSON ``{"version",
    "keys"}`` and whose members ``leaf_{i}.npy`` hold one array each; the keys
    are ``keystr`` paths.  The train CLI saves ``{"step", "params",
    "opt_state"}``: the leaves under ``['params']`` are returned and the rest
    is ignored; a file that holds a bare parameter dict is returned whole.
    The legacy pickle (format v1) is not read: a pickle of jax arrays cannot be
    opened without jax."""
    if not zipfile.is_zipfile(path):
        raise ValueError(
            f"{path!r} is not a dffx checkpoint of format v2 (a zip archive); the legacy "
            "pickle format (v1) holds jax arrays and cannot be read without jax: load it "
            "with dffx.checkpoint.load and save it again")
    with zipfile.ZipFile(path) as zf:
        if _MANIFEST not in zf.namelist():
            raise ValueError(f"{path!r} is a zip archive without a {_MANIFEST} member")
        manifest = json.loads(zf.read(_MANIFEST).decode())
        if manifest["version"] > FORMAT_VERSION:
            raise ValueError(f"checkpoint {path!r} has format v{manifest['version']} > "
                             f"supported v{FORMAT_VERSION}")
        trees: Dict[str, Dict[str, np.ndarray]] = {}
        for i, key in enumerate(manifest["keys"]):
            parts, pos = [], 0
            while (m := _SEGMENT.match(key, pos)) is not None:
                parts.append(m.group(1))
                pos = m.end()
            if pos != len(key) or len(parts) > 2:
                continue  # a leaf of the optimizer state
            if len(parts) == 1:
                root, leaf = "", parts[0]
            elif parts[0] == "params":
                root, leaf = parts
            else:
                continue
            trees.setdefault(root, {})[leaf] = np.lib.format.read_array(
                io.BytesIO(zf.read(f"leaf_{i}.npy")), allow_pickle=False)
    if "params" in trees:
        return trees["params"]
    return trees.get("", {})
