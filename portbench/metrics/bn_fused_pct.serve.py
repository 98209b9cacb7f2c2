"""Share of the traced slice's eval BatchNorms that the program's one pass
applied (the program's counters stock.bn_fused and stock.bn_aten)."""

from portbench import bn_fused


def read(r):
    return bn_fused.fused_pct(r)
