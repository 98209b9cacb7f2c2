"""The share of the program's eval BatchNorms that its one pass applied, from
the program's counters ``stock.bn_fused`` (the pass: the affine with the
residual add and ReLU after it) and ``stock.bn_aten`` (ATen's multiply and
add), in the traced slice (``program_spans``)."""

from __future__ import annotations

from typing import Optional

from portbench import program_spans
from portbench.core import Run


def fused_pct(r: Run) -> Optional[float]:
    """100 x fused BNs over all counted eval BNs; None where neither counter
    fired (an untraced run, a train step, a program without them)."""
    fused = program_spans.counter_per_call(r, "stock.bn_fused")
    aten = program_spans.counter_per_call(r, "stock.bn_aten")
    if fused is None and aten is None:
        return None
    fused, aten = fused or 0.0, aten or 0.0
    return 100.0 * fused / (fused + aten)
