"""Weights into and out of the port: the JAX package's param dicts, its
``.ckpt`` checkpoints (format v2) and reference ``.pth`` files.

Keys are shared by all three (reference, ``dffx``, ``dffx_torch``); only conv
weight layouts differ.  ``load_jax_params`` undoes the JAX package's layout by
the type of module that owns each weight (the inverse of
``dffx/checkpoint.py::from_torch_state_dict``), ``jax_layout`` applies it:

* Conv3d weight           ``(kd, kh, kw, Cin, Cout)`` <-> ``(Cout, Cin, kd, kh, kw)``
* ConvTranspose3d weight  ``(kd, kh, kw, Cin, Cout)`` <-> ``(Cin, Cout, kd, kh, kw)``
* conv biases (the FlowNetwork heads' last conv) and BN tensors pass through;
  ``num_batches_tracked`` is int64 in the port and int32 in ``dffx``'s files.

A train state (``dffx_torch.train.TrainState``) goes to a format-v2 file as
the train CLI of ``dffx`` writes one (``save``, ``save_async``), and comes
back from a file either package wrote (``restore``).
"""

from __future__ import annotations

import io
import itertools
import json
import os
import re
import threading
import zipfile
from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch
from torch import nn


FORMAT_VERSION = 2  # the dffx checkpoint format read and written here
_MANIFEST = "__dffx_manifest__"
#: one dict segment ``['name']`` of a ``jax.tree_util.keystr`` path
_SEGMENT = re.compile(r"\['((?:[^'\\]|\\.)*)'\]")
#: ``keystr`` paths of a ``dffx`` train state: ``{"step", "params", "opt_state"}``,
#: the optimizer ``optax.masked(optax.adam(...))`` over the trainable keys
_STEP = "['step']"
_ADAM = "['opt_state'].inner_state[0]"
_COUNT = f"{_ADAM}.count"
_tmp_counter = itertools.count()


def _check_keys(got, want) -> None:
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(
            f"key mismatch: {len(missing)} missing {missing[:5]}, "
            f"{len(extra)} extra {extra[:5]}")


def _conv_kinds(module: nn.Module) -> Dict[str, type]:
    """The state_dict key of every conv and deconv weight, and its module type."""
    return {f"{name}.weight": type(m) for name, m in module.named_modules()
            if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d))}


def _from_jax(kind, arr: np.ndarray) -> np.ndarray:
    if kind is not None and issubclass(kind, nn.ConvTranspose3d):
        return arr.transpose(3, 4, 0, 1, 2)
    if kind is not None:
        return arr.transpose(4, 3, 0, 1, 2)
    return arr


def _to_jax(kind, arr: np.ndarray) -> np.ndarray:
    if kind is not None and issubclass(kind, nn.ConvTranspose3d):
        return arr.transpose(2, 3, 4, 0, 1)
    if kind is not None:
        return arr.transpose(2, 3, 4, 1, 0)
    return arr


def jax_layout(module: nn.Module, tensors: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Tensors keyed like ``module``'s state_dict (its parameters and buffers,
    their gradients or Adam moments) as numpy arrays in ``dffx``'s layout."""
    kinds = _conv_kinds(module)
    # asarray(order="C"), not ascontiguousarray, which makes a 0-d count 1-d
    return {k: np.asarray(_to_jax(kinds.get(k), t.detach().cpu().numpy()), order="C")
            for k, t in tensors.items()}


def load_jax_params(module: nn.Module, params: Mapping[str, np.ndarray]) -> nn.Module:
    """Load a ``dffx`` parameter dict (arrays in DHWIO layout) into ``module``."""
    own = module.state_dict()
    _check_keys(params, own)
    kinds = _conv_kinds(module)
    sd: Dict[str, torch.Tensor] = {}
    for key, ref in own.items():
        arr = _from_jax(kinds.get(key), np.asarray(params[key]))
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


def _read(path: str) -> Dict[str, np.ndarray]:
    """Every leaf of a format-v2 file, by ``keystr`` path.

    The file is a zip whose member ``__dffx_manifest__`` is JSON ``{"version",
    "keys"}`` and whose members ``leaf_{i}.npy`` hold one array each.  The
    legacy pickle (format v1) is not read: a pickle of jax arrays cannot be
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
        return {key: np.lib.format.read_array(io.BytesIO(zf.read(f"leaf_{i}.npy")),
                                              allow_pickle=False)
                for i, key in enumerate(manifest["keys"])}


def _segments(key: str) -> List[str]:
    """The dict segments of a ``keystr`` path; ``[]`` unless it is dicts only."""
    parts, pos = [], 0
    while (m := _SEGMENT.match(key, pos)) is not None:
        parts.append(m.group(1))
        pos = m.end()
    return parts if pos == len(key) else []


def load_dffx_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """The parameters of a checkpoint the JAX package wrote (``dffx.checkpoint.
    save``, format v2), as ``load_jax_params`` takes them (DHWIO arrays).

    The train CLI saves ``{"step", "params", "opt_state"}``: the leaves under
    ``['params']`` are returned and the rest is ignored; a file that holds a
    bare parameter dict is returned whole."""
    return _params(_read(path))


def _params(leaves: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    trees: Dict[str, Dict[str, np.ndarray]] = {}
    for key, arr in leaves.items():
        parts = _segments(key)
        if len(parts) == 1:
            trees.setdefault("", {})[parts[0]] = arr
        elif len(parts) == 2 and parts[0] == "params":
            trees.setdefault("params", {})[parts[1]] = arr
    if "params" in trees:
        return trees["params"]
    return trees.get("", {})


def _named_params(state) -> Dict[str, torch.nn.Parameter]:
    """The model's parameters by state_dict key, checked to be the
    optimizer's, in its order (``create_train_state``)."""
    named = dict(state.model.named_parameters())
    opt_params = [p for g in state.optimizer.param_groups for p in g["params"]]
    if [id(p) for p in opt_params] != [id(p) for p in named.values()]:
        raise ValueError("the optimizer does not hold the model's parameters in their order")
    return named


def _adam_count(state, params: Sequence[torch.Tensor]) -> int:
    """The number of Adam steps every parameter has taken (optax's ``count``)."""
    steps = {int(state.optimizer.state[p]["step"]) if p in state.optimizer.state else 0
             for p in params}
    if len(steps) != 1:
        raise ValueError(f"the parameters have taken different numbers of Adam steps: "
                         f"{sorted(steps)}; a dffx checkpoint holds one count")
    return steps.pop()


def _train_leaves(state) -> Dict[str, np.ndarray]:
    """The train state as ``dffx``'s train CLI saves it: ``keystr`` path ->
    array, in ``dffx``'s layout and dtypes (int32 for the counts)."""
    named = _named_params(state)
    count = _adam_count(state, list(named.values()))
    moments = {}
    for which, slot in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        held = {k: state.optimizer.state[p][slot] if p in state.optimizer.state
                else torch.zeros_like(p) for k, p in named.items()}
        moments[which] = jax_layout(state.model, held)
    params = jax_layout(state.model, state.model.state_dict())
    leaves = {_COUNT: np.asarray(count, np.int32)}
    for which in ("mu", "nu"):
        leaves.update({f"{_ADAM}.{which}['{k}']": v for k, v in moments[which].items()})
    leaves.update({f"['params']['{k}']": v.astype(np.int32) if v.dtype == np.int64 else v
                   for k, v in params.items()})
    leaves[_STEP] = np.asarray(state.step, np.int32)
    return dict(sorted(leaves.items()))  # jax's flattening order: sorted dict keys


def _write(path: str, leaves: Mapping[str, np.ndarray]) -> None:
    """Write a format-v2 file atomically: to a file of its own beside
    ``path``, flushed and synced, then renamed over it."""
    manifest = json.dumps({"version": FORMAT_VERSION, "keys": list(leaves)})
    tmp = f"{path}.tmp.{os.getpid()}.{next(_tmp_counter)}"
    try:
        with open(tmp, "wb") as f:
            with zipfile.ZipFile(f, "w", zipfile.ZIP_STORED) as zf:
                zf.writestr(_MANIFEST, manifest)
                for i, arr in enumerate(leaves.values()):
                    buf = io.BytesIO()
                    np.lib.format.write_array(buf, np.asarray(arr, order="C"),
                                              allow_pickle=False)
                    zf.writestr(f"leaf_{i}.npy", buf.getvalue())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save(path: str, state) -> None:
    """Write a train state (``dffx_torch.train.TrainState``) as a format-v2
    checkpoint that ``dffx.checkpoint.load`` reads with a ``{"step",
    "params", "opt_state"}`` template of ``dffx.train.create_train_state``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    _write(path, _train_leaves(state))


class AsyncSave:
    """Handle for a checkpoint being written in the background."""

    def __init__(self, path: str, leaves: Mapping[str, np.ndarray]):
        self.error = None
        self._thread = threading.Thread(target=self._run, args=(path, leaves), daemon=True)
        self._thread.start()

    def _run(self, path, leaves) -> None:
        try:
            _write(path, leaves)
        except Exception as e:  # noqa: BLE001 - handed to the caller by wait()
            self.error = e

    def wait(self) -> None:
        self._thread.join()
        if self.error is not None:
            raise self.error


def save_async(path: str, state) -> AsyncSave:
    """``save`` with the write in a background thread: the state is copied to
    host memory first (which waits for the card), so training may go on at
    once.  Call ``.wait()`` before relying on the file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    return AsyncSave(path, _train_leaves(state))


def restore(path: str, state):
    """Load a train-state checkpoint (``save``'s, or the train CLI's of
    ``dffx``) into ``state`` in place: the model's parameters and BN
    statistics, Adam's moments and step count, and ``state.step``.
    Returns ``state``."""
    leaves = _read(path)
    if _STEP not in leaves or _COUNT not in leaves:
        raise ValueError(f"{path!r} holds no train state ({_STEP} and {_COUNT})")
    named = _named_params(state)
    load_jax_params(state.model, _params(leaves))
    kinds = _conv_kinds(state.model)
    count = float(leaves[_COUNT])
    opt_state = {}
    for i, (key, p) in enumerate(named.items()):
        slots = {}
        for which, slot in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            leaf = f"{_ADAM}.{which}['{key}']"
            if leaf not in leaves:
                raise ValueError(f"{path!r} has no Adam moment {leaf}")
            arr = _from_jax(kinds.get(key), leaves[leaf])
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{leaf}: shape {arr.shape} != {tuple(p.shape)}")
            slots[slot] = torch.from_numpy(np.array(arr, order="C"))
        opt_state[i] = {"step": torch.tensor(count), **slots}
    sd = state.optimizer.state_dict()
    state.optimizer.load_state_dict({"state": opt_state, "param_groups": sd["param_groups"]})
    state.step = int(leaves[_STEP])
    return state
