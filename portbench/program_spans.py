"""Per-layer readings from the program's own spans and counters
(``dffx_torch.utils.profiling``), which the readers of ``metrics/`` return.

The program records them only while ``torch.profiler`` runs, and the traced
slice is a run's one profiled stretch, so the totals cover the slice alone:
the first reading of a run takes them all and clears the program's, so that
a later traced run in the same process starts from nothing.  They are
readings under the profiler, whose cost a host span includes.  Each
reading returns None where there is nothing to read: a run without a
slice, a program without spans, or a span or counter that never fired in
the slice."""

from __future__ import annotations

import weakref
from typing import Optional

from portbench.core import Run

#: where each clock's seconds sit in a span's (count, host_s, self_host_s, device_s)
CLOCKS = {"host": 1, "device": 3}

#: a run's (spans, counters), taken at its first reading
_taken: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _recorded():
    """The program's profiling module, if it records spans and counters."""
    try:
        from dffx_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "spans") and hasattr(profiling, "counters") else None


def _totals(r: Run, profiling) -> tuple:
    """The run's spans and counters: the program's totals at its first
    reading, which then clears them."""
    if r not in _taken:
        _taken[r] = (profiling.spans(), profiling.counters())
        profiling.reset()
    return _taken[r]


def _per(r: Run, per: str, fired: int) -> int:
    """The slice's requests, forwards or steps (``call``), its stacks
    (``stack``), or the span's own count (``firing``)."""
    return {"call": r.slice.calls, "stack": r.slice.items, "firing": fired}[per]


def span_ms(r: Run, name: str, clock: str, per: str) -> Optional[float]:
    """The ``clock`` (``host`` or ``device``) milliseconds of the span
    ``name`` in the slice, over ``per`` (``_per``)."""
    profiling = _recorded()
    if r.slice is None or profiling is None:
        return None
    total = _totals(r, profiling)[0].get(name)
    if total is None or total[0] == 0:
        return None
    return total[CLOCKS[clock]] * 1e3 / _per(r, per, total[0])


def counter_per_call(r: Run, name: str, scale: float = 1.0) -> Optional[float]:
    """The counter ``name`` in the slice a request, forward or step, times
    ``scale``."""
    profiling = _recorded()
    if r.slice is None or profiling is None:
        return None
    value = _totals(r, profiling)[1].get(name)
    return None if value is None else value * scale / r.slice.calls
