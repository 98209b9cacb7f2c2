"""The share of the serving entry's staged bytes that came through its
pinned stage-in, from the program's counters ``serve.staged_pinned`` (bytes
that crossed from host memory through the pinned chunks) and
``serve.staged_bytes`` (every byte that came to the card from elsewhere),
in the traced slice (``program_spans``)."""

from __future__ import annotations

from typing import Optional

from portbench import program_spans
from portbench.core import Run


def pinned_pct(r: Run) -> Optional[float]:
    """100 x pinned bytes over staged bytes; None where nothing was staged
    (an untraced run, inputs already on the model's device) or the program
    has no ``serve.staged_pinned``."""
    staged = program_spans.counter_per_call(r, "serve.staged_bytes")
    pinned = program_spans.counter_per_call(r, "serve.staged_pinned")
    if pinned is None or not staged:
        return None
    return 100.0 * pinned / staged
