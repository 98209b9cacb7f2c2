"""Profiling and throughput instrumentation, the port of
``dffx/utils/profiling.py`` on ``torch.profiler`` and CUDA events.

* ``trace(logdir)``     — context manager around ``torch.profiler`` with the
  CPU and (on a machine with a card) CUDA activities; writes a Chrome trace
  (view it in Perfetto or ``chrome://tracing``), which holds the spans below.
* ``span(name, device)`` and ``count(name, n)`` — the program's own spans
  and counters at its layers' boundaries; ``spans()``, ``counters()``,
  ``reset()``, ``collect()`` and ``enabled()`` read and steer them.
* ``device_loop_time``  — seconds per call of a function on its device: CUDA
  events around ``iters`` calls after a warm one, with a synchronise, on the
  card; the host clock on the CPU.

Spans and counters are on only while ``torch.profiler`` records
(``torch.autograd.profiler._is_profiler_enabled``) or inside ``with
collect():``.  Off, ``span`` and ``count`` do one flag test and nothing
else.  On, a span opens a ``record_function`` of its name while the
profiler records (so that it sits on the trace's timeline beside the
kernels it launched), reads ``time.perf_counter_ns`` at both ends, and on a
CUDA device records a pair of timing events on the current stream, which
are resolved when the totals are read (and, once thousands wait, those the
device has finished) and never synchronised on the way; on the CPU its
device time is its host time.  A stack a thread gives each span
its parent: a span's self time is its host time less what its children
cover.  The totals are the process's, summed over every thread since
``reset()``.

``dffx``'s ``StepTimer`` and ``enable_persistent_cache`` (an XLA
compilation cache) have no counterpart: spans time the program's steps, and
an eager PyTorch forward compiles nothing.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Callable, Dict, Optional, Tuple

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


#: read at every span: ``torch.profiler`` sets its ``_is_profiler_enabled``
#: while it records
_profiler = torch.autograd.profiler

_lock = threading.Lock()  # the totals below; span stacks are per thread
_collecting = 0  # open ``collect()`` blocks
_spans: Dict[str, list] = {}  # name -> [count, host ns, self host ns, device s]
_pending: list = []  # (name, start event, end event) of CUDA spans not yet read
#: fold the finished ones of ``_pending`` into the totals once it is this long
#: (a profiler run that never reads the spans would otherwise keep them all)
_fold_at = 4096
_counters: Dict[str, int] = {}
_local = threading.local()  # .stack: this thread's open spans


def enabled() -> bool:
    """Whether spans and counters record now: under ``torch.profiler`` or
    inside ``collect()``."""
    return bool(_collecting) or _profiler._is_profiler_enabled


@contextlib.contextmanager
def collect():
    """``with profiling.collect(): ...`` records spans and counters in the
    block without a profiler (tests, ``chip_smoke.py``); the totals stay until
    ``reset()``."""
    global _collecting
    with _lock:
        _collecting += 1
    try:
        yield
    finally:
        with _lock:
            _collecting -= 1


class _Off:
    """The span handed out while nothing records: it does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "cuda", "device", "events", "own_events", "record", "parent",
                 "children_ns", "t0")

    def __init__(self, name: str, device, events):
        self.name = name
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.events, self.own_events = events, events is None and self.cuda

    def __enter__(self):
        self.record = None
        if _profiler._is_profiler_enabled:
            self.record = torch.profiler.record_function(self.name)
            self.record.__enter__()
        if self.own_events:
            self.events = tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
            self.events[0].record(torch.cuda.current_stream(self.device))
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.children_ns = 0
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        host = time.perf_counter_ns() - self.t0
        if self.own_events:
            self.events[1].record(torch.cuda.current_stream(self.device))
        _local.stack.pop()
        if self.parent is not None:
            self.parent.children_ns += host
        with _lock:
            total = _spans.setdefault(self.name, [0, 0, 0, 0.0])
            total[0] += 1
            total[1] += host
            total[2] += host - self.children_ns
            if self.cuda:
                _pending.append((self.name, *self.events))
                if len(_pending) >= _fold_at:
                    _fold(wait=False)
            else:
                total[3] += host / 1e9
        if self.record is not None:
            self.record.__exit__(*exc)
        return False


def span(name: str, device, events: Optional[Tuple] = None):
    """``with profiling.span(name, device): ...`` times the block as the span
    ``name`` of work on ``device`` (see the module's docstring).  ``events``:
    a pair of CUDA timing events that the caller records itself on the
    current stream, the first before the block and the second inside it at
    its end, read as the span's device time in place of a pair of its own."""
    if not (_collecting or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, device, events)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while spans record."""
    if not (_collecting or _profiler._is_profiler_enabled):
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def spans() -> Dict[str, Tuple[int, float, float, float]]:
    """Each span's ``(count, host_s, self_host_s, device_s)`` since
    ``reset()``; waits for the device time of CUDA spans not yet read."""
    with _lock:
        _fold(wait=True)
        return {name: (c, host / 1e9, own / 1e9, dev) for name, (c, host, own, dev)
                in _spans.items()}


def _fold(wait: bool) -> None:
    """Add the device time of the pending CUDA spans to their totals: every
    one, waiting for it, with ``wait``; else those the device has finished,
    without waiting.  The caller holds ``_lock``."""
    global _fold_at
    left = []
    for name, start, end in _pending:
        if wait:
            end.synchronize()
        elif not end.query():
            left.append((name, start, end))
            continue
        _spans[name][3] += start.elapsed_time(end) / 1e3
    _pending[:] = left
    _fold_at = max(4096, 2 * len(left))


def counters() -> Dict[str, int]:
    """Each counter's sum since ``reset()``."""
    with _lock:
        return dict(_counters)


def reset() -> None:
    """Forget every span and counter recorded so far."""
    with _lock:
        _spans.clear()
        _pending.clear()
        _counters.clear()


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
