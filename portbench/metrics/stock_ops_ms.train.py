"""Device time a step of the kernels that are neither the program's own
nor NCCL's (cuDNN, ATen, cuBLAS), in the traced slice."""

from portbench import readings


def read(r):
    return readings.stock_ops_ms(r)
