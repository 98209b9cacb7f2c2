"""The share of the program's 2x2 max-pools that its BN-ReLU pass applied
with the BN before them, from the program's counters ``stock.pool_fused``
(the pass: the eval BN, its ReLU and the pool, DDFFNet's encoder) and
``stock.pool_aten`` (ATen's ``max_pool3d``), in the traced slice
(``program_spans``)."""

from __future__ import annotations

from typing import Optional

from portbench import program_spans
from portbench.core import Run


def fused_pct(r: Run) -> Optional[float]:
    """100 x fused pools over all counted pools; None where neither counter
    fired (an untraced run, a network without max-pools, a program without
    the counters)."""
    fused = program_spans.counter_per_call(r, "stock.pool_fused")
    aten = program_spans.counter_per_call(r, "stock.pool_aten")
    if fused is None and aten is None:
        return None
    fused, aten = fused or 0.0, aten or 0.0
    return 100.0 * fused / (fused + aten)
