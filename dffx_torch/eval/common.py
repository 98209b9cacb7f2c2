"""Serving utilities: weights from a reference ``.pth``, a ``dffx`` ``.ckpt``
or a seed, a timed eval forward with the reference's ``AVG_time``
semantics (on one rank, or H-sharded over ``spatial`` ranks), the device of
the command lines, and the jet depth JPEGs."""

from __future__ import annotations

import os
import time
from typing import Optional, Union

import numpy as np
import torch
from torch import nn

from dffx_torch.checkpoint import load_dffx_checkpoint, load_jax_params, load_torch_checkpoint
from dffx_torch.data.native import require
from dffx_torch.models import E2ENetwork, Network, e2e_init_params, init_params
from dffx_torch.models.layers import spatial_serving
from dffx_torch.models.packed import PACKED_DEFAULT
from dffx_torch.parallel import distributed, make_mesh


def load_params_auto(source: Union[str, int], *, device="cuda", e2e: bool = False,
                     packed: bool = PACKED_DEFAULT) -> nn.Module:
    """An eval-mode ``Network`` (depth only) or, with ``e2e``, ``E2ENetwork``
    (alignment + depth) on ``device``.  The weights come from a reference
    ``.pth`` path (a torch state dict), from any other path as a checkpoint
    the JAX package wrote (``dffx.checkpoint.save``, format v2: a ``.ckpt`` of
    the train CLI, whose ``params`` are served) or from an int seed
    (``init_params`` / ``e2e_init_params``).  ``packed``: DFFNet's EFDs and
    full-resolution stage run space-to-depth (``models/packed.py``), the
    graph the JAX package serves; the weights are the same either way.  The
    default device is the GPU: without one this raises, and the CPU is used
    only when asked for (``device="cpu"``)."""
    net = E2ENetwork(packed) if e2e else Network(packed)
    if isinstance(source, int):
        load_jax_params(net, (e2e_init_params if e2e else init_params)(source))
    elif not os.path.isfile(source):
        raise FileNotFoundError(f"checkpoint {source!r} not found")
    elif source.endswith(".pth"):
        net.load_state_dict(load_torch_checkpoint(source))
    else:
        load_jax_params(net, load_dffx_checkpoint(source))
    return net.to(device).eval()


class TimedForward:
    """Eval forward with timing around the model call only (`test.py:115-119`):
    inputs are copied to the model's device before the clock starts.  On a
    CUDA device the time comes from CUDA events on the current stream.

    ``avg_time`` is seconds per sample, as the reference's ``AVG_time``: with a
    batch of B, one call adds B samples.  Inputs after the focus distances
    (``E2ENetwork``'s ``fovs``) go to the model as fp32 tensors.

    ``spatial > 1`` serves each forward over ``spatial`` processes, one rank
    each (``dffx_torch.parallel``; the process group must hold exactly that
    many): every rank holds the whole model and the whole stack, runs the
    kernels' chains on its rows of H behind one halo exchange
    (``layers.spatial_serving``, ``ops/halo.py``), rebuilds each chain's
    output with one all-gather, and runs the rest of the forward whole.
    ``spatial_pallas``: the chains run the kernels (the default on the card;
    on the CPU the default is the stock layers) or, ``False``
    (``--spatial-xla``), their stock layers, so that no kernel launches.

    Only the chains split: every rank runs the rest of the forward whole and
    holds the whole model and stack, so ``spatial > 1`` saves no memory and
    was slower than one card at every shape measured (``PERF.md``; ROADMAP
    queue 1 item 10 would shard every stage)."""

    def __init__(self, model: nn.Module, *, dtype: torch.dtype = torch.float32,
                 spatial: int = 1, spatial_pallas: Optional[bool] = None):
        self.model = model.eval()
        self.dtype = dtype
        self.device = next(model.parameters()).device
        self.total = 0.0
        self.count = 0
        self._spatial = None
        if spatial > 1:
            if distributed.process_count() != spatial:
                raise ValueError(
                    f"--spatial {spatial} runs one process a rank and needs {spatial} of "
                    f"them, this has {distributed.process_count()}; launch with "
                    f"torchrun --nproc_per_node {spatial} -m dffx_torch.eval.test "
                    f"--spatial {spatial} ...")
            if spatial_pallas is None:
                spatial_pallas = self.device.type == "cuda"
            self._spatial = (make_mesh(data=1, spatial=spatial), bool(spatial_pallas))

    def _forward(self, fs, rest):
        if self._spatial is None:
            return self.model(fs, *rest)
        mesh, kernels = self._spatial
        with spatial_serving(mesh, kernels=kernels):
            return self.model(fs, *rest)

    def __call__(self, fs, focus_dists, *extra):
        fs = torch.as_tensor(fs).to(self.device, self.dtype)
        rest = [torch.as_tensor(a).to(self.device, torch.float32) for a in (focus_dists, *extra)]
        with torch.inference_mode():
            if self.device.type == "cuda":
                stream = torch.cuda.current_stream(self.device)
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record(stream)
                outs = self._forward(fs, rest)
                end.record(stream)
                end.synchronize()
                seconds = start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                outs = self._forward(fs, rest)
                seconds = time.perf_counter() - t0
        self.total += seconds
        self.count += int(fs.shape[0])
        return outs

    @property
    def avg_time(self) -> float:
        return self.total / max(self.count, 1)


def cli_device(name: str) -> torch.device:
    """The device a command line runs on (its ``--device``, default ``cuda``).
    Without a card a CUDA device raises: the command lines do not carry on on
    the CPU unless asked (``--device cpu``).  On the card TF32 is turned off
    for cuDNN's convolutions and for matmuls: the forwards and train steps
    stay full fp32, as the port's correctness gates hold them."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {name}: no CUDA device is available; "
                               "pass --device cpu to run on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return device


def checkpoint_or_seed(path: Optional[str], *, allow_random: bool) -> Union[str, int]:
    """What ``load_params_auto`` loads for a command line: ``path`` if the file
    exists; else, with ``allow_random`` (``--allow-random-init``), seed 0, as
    ``dffx``'s command lines do (``dffx/eval/common.py:32``)."""
    if path and os.path.exists(path):
        return path
    if allow_random:
        if distributed.is_primary():
            print(f"[dffx_torch] checkpoint {path!r} not found — using random init "
                  "(--allow-random-init)")
        return 0
    raise FileNotFoundError(
        f"checkpoint {path!r} not found; pass --checkpoint or --allow-random-init")


#: matplotlib's "jet" (``matplotlib/_cm.py``): per channel, the (x, y0, y1)
#: points of its piecewise-linear segments
_JET = {
    "red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1.0, 0.5, 0.5)),
    "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1), (0.91, 0, 0),
              (1.0, 0, 0)),
    "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1.0, 0, 0)),
}
_JET_N = 256  # matplotlib's quantisation of a segmented colormap


def _jet_lut() -> np.ndarray:
    """(256, 3) float64: each channel's segments sampled at 256 points, as
    matplotlib's ``_create_lookup_table`` samples them (gamma 1)."""
    n = _JET_N
    lut = np.empty((n, 3))
    for c, name in enumerate(("red", "green", "blue")):
        data = np.asarray(_JET[name], dtype=np.float64)
        x, y0, y1 = data[:, 0] * (n - 1), data[:, 1], data[:, 2]
        xind = (n - 1) * np.linspace(0, 1, n)
        ind = np.searchsorted(x, xind)[1:-1]
        distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
        lut[:, c] = np.clip(np.concatenate(
            [[y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1], [y0[-1]]]), 0.0, 1.0)
    return lut


def jet_colormap(x: np.ndarray) -> np.ndarray:
    """The 'jet' RGB colormap as uint8, equal byte for byte to ``dffx``'s
    ``matplotlib.colormaps["jet"](x)[..., :3]`` times 255 (the reference's
    ``cm.get_cmap('jet')``, `test.py:133-140`), in numpy: ``x`` in [0, 1] picks
    one of 256 entries, below 0 the first, above 1 the last, NaN black."""
    lut = _jet_lut()
    xa = np.array(x, dtype=np.float64) * _JET_N
    xa[xa == _JET_N] = _JET_N - 1
    under, over, bad = xa < 0, xa >= _JET_N, np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = xa.astype(int)
    idx[under] = 0
    idx[over] = _JET_N - 1
    rgb = lut.take(np.clip(idx, 0, _JET_N - 1), axis=0)
    rgb[bad] = 0.0
    return (255 * rgb).astype(np.uint8)


def save_jet(path: str, normalized: np.ndarray, user: str) -> None:
    """Write ``jet_colormap(normalized)`` as a JPEG of quality 100 with
    ``imageio``, as ``dffx`` writes its depth maps; ``user`` names the command
    line for the error where ``imageio`` is missing."""
    imageio = require("imageio", user)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    imageio.imwrite(path, jet_colormap(normalized), quality=100)
