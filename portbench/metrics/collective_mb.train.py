"""Bytes the program's collectives moved a step on rank 0
(dffx_torch.parallel.distributed.traffic), in MB."""

from portbench import readings


def read(r):
    return readings.value(r, "collective_mb") if r.world > 1 else None
