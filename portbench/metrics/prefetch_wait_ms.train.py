"""The host's wait in next() on the program's device_prefetch iterator, a
step's mean over the window."""

from portbench import readings


def read(r):
    return readings.value(r, "prefetch_wait_ms")
