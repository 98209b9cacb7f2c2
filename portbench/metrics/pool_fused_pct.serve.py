"""Share of the traced slice's max-pools that the program's BN-ReLU pass
applied with the BN before them (the program's counters stock.pool_fused and
stock.pool_aten)."""

from portbench import pool_fused


def read(r):
    return pool_fused.fused_pct(r)
