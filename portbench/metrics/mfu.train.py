"""The train step's share of the cards' bf16 peak, by three times the
reference's convolution FLOPs a stack."""

from portbench import readings


def read(r):
    return readings.mfu_pct(r)
