"""Serving utilities: weights from a reference ``.pth``, a ``dffx`` ``.ckpt``
or a seed, and a timed eval forward with the reference's ``AVG_time``
semantics."""

from __future__ import annotations

import os
import time
from typing import Union

import torch
from torch import nn

from dffx_torch.checkpoint import load_dffx_checkpoint, load_jax_params, load_torch_checkpoint
from dffx_torch.models import E2ENetwork, Network, e2e_init_params, init_params
from dffx_torch.models.packed import PACKED_DEFAULT


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
    (``E2ENetwork``'s ``fovs``) go to the model as fp32 tensors."""

    def __init__(self, model: nn.Module, *, dtype: torch.dtype = torch.float32):
        self.model = model.eval()
        self.dtype = dtype
        self.device = next(model.parameters()).device
        self.total = 0.0
        self.count = 0

    def __call__(self, fs, focus_dists, *extra):
        fs = torch.as_tensor(fs).to(self.device, self.dtype)
        rest = [torch.as_tensor(a).to(self.device, torch.float32) for a in (focus_dists, *extra)]
        with torch.inference_mode():
            if self.device.type == "cuda":
                stream = torch.cuda.current_stream(self.device)
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record(stream)
                outs = self.model(fs, *rest)
                end.record(stream)
                end.synchronize()
                seconds = start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                outs = self.model(fs, *rest)
                seconds = time.perf_counter() - t0
        self.total += seconds
        self.count += int(fs.shape[0])
        return outs

    @property
    def avg_time(self) -> float:
        return self.total / max(self.count, 1)
