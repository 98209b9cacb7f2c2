"""The share of the program's stock 16-bit convs and deconvs that cuDNN got
in its own NDHWC layout, from the program's counters ``stock.conv_ndhwc``
(an NDHWC input) and ``stock.conv_ncdhw`` (an input cuDNN transposes), in
the traced slice (``program_spans``)."""

from __future__ import annotations

from typing import Optional

from portbench import program_spans
from portbench.core import Run


def ndhwc_pct(r: Run) -> Optional[float]:
    """100 x NDHWC calls over all counted calls; None where neither counter
    fired (an untraced run, an fp32 forward, a program without them)."""
    ndhwc = program_spans.counter_per_call(r, "stock.conv_ndhwc")
    ncdhw = program_spans.counter_per_call(r, "stock.conv_ncdhw")
    if ndhwc is None and ncdhw is None:
        return None
    ndhwc, ncdhw = ndhwc or 0.0, ncdhw or 0.0
    return 100.0 * ndhwc / (ndhwc + ncdhw)
