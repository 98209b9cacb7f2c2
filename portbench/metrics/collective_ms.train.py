"""Device time of NCCL's kernels a step on rank 0, in the traced slice."""

from portbench import readings


def read(r):
    return readings.collective_ms(r)
