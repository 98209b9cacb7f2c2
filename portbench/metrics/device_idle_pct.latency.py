"""Share of the traced slice in which no work ran on the card."""

from portbench import readings


def read(r):
    return readings.device_idle_pct(r)
