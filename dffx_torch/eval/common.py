"""Serving utilities: DFFNet, the end-to-end network, DFV or DDFFNet with
weights from a reference ``.pth``, a ``dffx`` ``.ckpt`` or a seed, a timed eval
forward with the reference's ``AVG_time`` semantics (on one rank, or
H-sharded over ``spatial`` ranks), the device of the command lines, and the
jet depth JPEGs."""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from dffx_torch.checkpoint import load_dffx_checkpoint, load_jax_params, load_torch_checkpoint
from dffx_torch.data.native import require
from dffx_torch.models import (DFV, DDFFNet, E2ENetwork, Network, ddffnet_init_params,
                               dfv_init_params, e2e_init_params, init_params)
from dffx_torch.models.layers import spatial_serving
from dffx_torch.models.packed import PACKED_DEFAULT
from dffx_torch.parallel import distributed, make_mesh
from dffx_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class Served:
    """A network that ``load_params_auto`` builds: its module (given
    ``packed``), its parameters drawn from a seed, the index of its depth map
    ``pred3`` among its outputs, and whether a checkpoint of the JAX package
    can hold it."""

    build: Callable[[bool], nn.Module]
    init: Callable[[int], Dict[str, np.ndarray]]
    depth: int
    dffx_checkpoint: bool


#: the networks ``load_params_auto`` serves, by ``arch``
NETWORKS = {
    "dffnet": Served(Network, init_params, 3, True),
    "e2e": Served(E2ENetwork, e2e_init_params, 3, True),
    "dfv": Served(lambda packed: DFV(), dfv_init_params, 0, False),
    "ddffnet": Served(lambda packed: DDFFNet(), ddffnet_init_params, 0, False),
}


def load_params_auto(source: Union[str, int], *, device="cuda", packed: bool = PACKED_DEFAULT,
                     arch: str = "dffnet") -> nn.Module:
    """The eval-mode network ``NETWORKS[arch]`` on ``device``: ``Network``
    (depth only, the default), ``E2ENetwork`` (alignment + depth),
    ``DFV`` (depth and its spread) or ``DDFFNet`` (depth and the per-slice
    maps it fuses, for DDFF-12's 10-slice stacks).  The weights come from a
    reference ``.pth`` path (a torch state dict, or one under a training
    checkpoint's ``state_dict`` key, as DFV's are saved), from any other
    path as a checkpoint the JAX package wrote (``dffx.checkpoint.save``,
    format v2: a ``.ckpt`` of the train CLI, whose ``params`` are served;
    not DFV or DDFFNet, which the JAX package lacks) or from an int seed
    (``Served.init``).  ``packed``: DFFNet's EFDs and
    full-resolution stage run space-to-depth (``models/packed.py``), the
    graph the JAX package serves; the weights are the same either way.  The
    default device is the GPU: without one this raises, and the CPU is used
    only when asked for (``device="cpu"``)."""
    if arch not in NETWORKS:
        raise ValueError(f"arch must be one of {sorted(NETWORKS)}, got {arch!r}")
    served = NETWORKS[arch]
    net = served.build(packed)
    if isinstance(source, int):
        load_jax_params(net, served.init(source))
    elif not os.path.isfile(source):
        raise FileNotFoundError(f"checkpoint {source!r} not found")
    elif source.endswith(".pth"):
        sd = load_torch_checkpoint(source)
        if isinstance(sd.get("state_dict"), dict):
            sd = {k.removeprefix("module."): v for k, v in sd["state_dict"].items()}
        net.load_state_dict(sd)
    elif not served.dffx_checkpoint:
        raise ValueError(f"{source!r}: {arch}'s weights come from a seed or a .pth")
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

    Stage-in: with the model on the card, an input in host memory (a CPU
    tensor or a numpy array) crosses through pinned host memory that the
    instance keeps from call to call (``_PinnedStage``), one slice of
    ``stage_plan`` at a time, cast on the host to the dtype the model gets;
    the copies overlap the host's cast of the next slice and do not wait
    for the previous call's forward.  The staged values equal
    ``.to(device, dtype)``'s bit for bit.  An input already on the model's
    device is used as it is, and with the model elsewhere (the CPU, the
    ``meta`` device) every input goes through ``.to(device, dtype)``.  Once
    a call returns, the caller's inputs are no longer read: it may
    overwrite them at once.

    On the card a call returns once the previous call's forward has ended,
    not its own: the next forward is enqueued while this one runs, so the
    card does not idle between calls, and at most two forwards are in
    flight.  The outputs are on the current stream, as any CUDA op's; a
    reader on the host (``.cpu()``) waits for them.  ``total`` (seconds)
    takes in the last forward's events when it is read.

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
    queue 1 item 10 would shard every stage).

    Spans (``utils/profiling.py``): ``serve.stage_in``, the inputs' copies
    to the device, with the counters of ``_count_staged``:
    ``serve.staged_bytes``, the bytes that came to the model's device from
    elsewhere, as the model gets them, and, with the model on the card,
    ``serve.staged_pinned``, those of them that came through the pinned
    stage-in; ``serve.forward``, the model call, whose host time is the time
    to enqueue the forward and whose device time on the card is this class's
    own pair of events."""

    def __init__(self, model: nn.Module, *, dtype: torch.dtype = torch.float32,
                 spatial: int = 1, spatial_pallas: Optional[bool] = None):
        self.model = model.eval()
        self.dtype = dtype
        self.device = next(model.parameters()).device
        self._total = 0.0
        self._pending = None  # the last forward's (start, end) events on the card
        self.count = 0
        self._pinned = _PinnedStage(self.device) if self.device.type == "cuda" else None
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
        with profiling.span("serve.stage_in", self.device):
            sources = [torch.as_tensor(a) for a in (fs, focus_dists, *extra)]
            dtypes = [self.dtype] + [torch.float32] * (len(sources) - 1)
            staged = [self._stage_in(s, dtype) for s, dtype in zip(sources, dtypes)]
        if profiling.enabled():
            _count_staged(sources, staged, self._pinned is not None)
        fs, rest = staged[0], staged[1:]
        with torch.inference_mode():
            if self.device.type == "cuda":
                stream = torch.cuda.current_stream(self.device)
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record(stream)
                # the span's host time is the enqueue; its device time, these events'
                with profiling.span("serve.forward", self.device, events=(start, end)):
                    outs = self._forward(fs, rest)
                    end.record(stream)
                self._settle()
                self._pending = (start, end)
            else:
                t0 = time.perf_counter()
                with profiling.span("serve.forward", self.device):
                    outs = self._forward(fs, rest)
                self._total += time.perf_counter() - t0
        self.count += int(fs.shape[0])
        return outs

    def _stage_in(self, src: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if self._pinned is not None and src.device.type == "cpu":
            return self._pinned(src, dtype)
        return src.to(self.device, dtype)

    def _settle(self) -> None:
        """Wait for the last forward on the card and add its time."""
        if self._pending is not None:
            start, end = self._pending
            end.synchronize()
            self._total += start.elapsed_time(end) / 1e3
            self._pending = None

    @property
    def total(self) -> float:
        self._settle()
        return self._total

    @total.setter
    def total(self, seconds: float) -> None:
        self._settle()
        self._total = seconds

    @property
    def avg_time(self) -> float:
        return self.total / max(self.count, 1)


def _count_staged(sources, staged, pinned: bool) -> None:
    """Counters ``serve.staged_bytes``: bytes of the inputs that came to the
    model's device from elsewhere, as the model gets them (a CPU source is
    cast on the host before it crosses); and, where the model is on the card
    (``pinned``), ``serve.staged_pinned``: those that came from host memory,
    through ``_PinnedStage``."""
    moved = [(s, t) for s, t in zip(sources, staged) if s.device != t.device]
    profiling.count("serve.staged_bytes", sum(t.nbytes for _, t in moved))
    if pinned:
        profiling.count("serve.staged_pinned",
                        sum(t.nbytes for s, t in moved if s.device.type == "cpu"))


#: pinned host chunks that ``_PinnedStage`` cycles through: the host writes
#: one while the link reads the ones before it
STAGE_RING = 3


def stage_plan(shape) -> List[Tuple[int, ...]]:
    """The slices in which a host input crosses to the card, in order: an
    index over every dimension but the last three (``(b, n)`` of a
    ``(B, N, H, W, C)`` stack), or ``()``, the whole input, where it has
    three dimensions or fewer."""
    return list(itertools.product(*(range(d) for d in shape[:-3])))


class _PinnedStage:
    """Host tensors to the card through ``STAGE_RING`` pinned chunks kept
    from call to call, one slice of ``stage_plan`` at a time: the host
    writes a slice into a chunk, cast to the dtype the model gets (ATen's
    host cast, as ``.to(device, dtype)`` makes it: round to nearest even),
    enqueues the chunk's copy into its place (``non_blocking``) and goes on
    to the next slice, so the link carries a slice while the host casts the
    next one.  A chunk is written again once the copy that read it has
    ended (its event), so pinned memory stays at ``STAGE_RING`` slices
    whatever the batch.

    The copies run on a stream of their own, which waits for nothing else:
    they do not queue behind the previous call's forward, and waiting for a
    chunk never waits for it.  The tensors are made on that stream and
    marked used on the caller's (``record_stream``), and the caller's
    stream waits for the copies, so that work enqueued after the call reads
    the staged values."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.chunks: List[torch.Tensor] = []
        self.read = [torch.cuda.Event() for _ in range(STAGE_RING)]  # each chunk's last copy
        self.turn = 0

    def __call__(self, src: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        size = math.prod(src.shape[-3:]) * dtype.itemsize
        if not self.chunks or self.chunks[0].numel() < size:
            self.chunks = [torch.empty(size, dtype=torch.uint8, pin_memory=True)
                           for _ in range(STAGE_RING)]
        current = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.stream):
            dst = torch.empty(src.shape, dtype=dtype, device=self.device)
            for index in stage_plan(src.shape):
                part = dst[index]
                k, self.turn = self.turn, (self.turn + 1) % STAGE_RING
                self.read[k].synchronize()
                chunk = self.chunks[k][:part.nbytes].view(dtype).view(part.shape)
                chunk.copy_(src[index])
                part.copy_(chunk, non_blocking=True)
                self.read[k].record(self.stream)
        dst.record_stream(current)
        current.wait_stream(self.stream)
        return dst


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
