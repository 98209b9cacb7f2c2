"""Share of the traced slice in which no work ran on rank 0's card."""

from portbench import readings


def read(r):
    return readings.device_idle_pct(r)
