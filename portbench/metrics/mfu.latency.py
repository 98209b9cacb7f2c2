"""The forward's share of the card's bf16 peak, by the reference's
convolution FLOPs."""

from portbench import readings


def read(r):
    return readings.mfu_pct(r)
