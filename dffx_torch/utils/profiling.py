"""Profiling and throughput instrumentation, the port of
``dffx/utils/profiling.py`` on ``torch.profiler`` and CUDA events.

* ``trace(logdir)``     — context manager around ``torch.profiler`` with the
  CPU and (on a machine with a card) CUDA activities; writes a Chrome trace
  (view it in Perfetto or ``chrome://tracing``).
* ``StepTimer``         — per-step wall timing with EMA + items/sec.
* ``device_loop_time``  — seconds per call of a function on its device: CUDA
  events around ``iters`` calls after a warm one, with a synchronise, on the
  card; the host clock on the CPU.

``dffx``'s ``enable_persistent_cache`` (an XLA compilation cache) has no
counterpart: an eager PyTorch forward compiles nothing.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str):
    """``with profiling.trace(dir) as prof: step()``: profiles the block and
    writes its Chrome trace to ``<logdir>/trace.json``.  Yields the
    ``torch.profiler.profile``, whose ``key_averages()`` sums time by op and
    kernel once the block has ended."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


class StepTimer:
    """Wall-clock per-step timing + items/sec, EMA-smoothed."""

    def __init__(self, ema: float = 0.9):
        self._ema = ema
        self._avg: Optional[float] = None
        self._last: Optional[float] = None
        self.total = 0.0
        self.count = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._last = dt
        self.total += dt
        self.count += 1
        self._avg = dt if self._avg is None else self._ema * self._avg + (1 - self._ema) * dt

    @property
    def avg(self) -> float:
        return self._avg or 0.0

    def items_per_sec(self, items_per_step: int) -> float:
        return items_per_step / self._avg if self._avg else 0.0


def device_loop_time(fn: Callable, *args, iters: int = 10) -> float:
    """Seconds per call of ``fn(*args)`` on the device of its first tensor
    argument: one warm call, then ``iters`` calls between two CUDA events on
    the current stream, with a synchronise, on a CUDA device; on the CPU
    (or with no tensor argument) the host clock around the ``iters`` calls."""
    dev = next((a.device for a in args if isinstance(a, torch.Tensor)), torch.device("cpu"))
    fn(*args)  # warm: cuDNN's plan choice, the allocator
    if dev.type == "cuda":
        stream = torch.cuda.current_stream(dev)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record(stream)
        for _ in range(iters):
            fn(*args)
        end.record(stream)
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters
