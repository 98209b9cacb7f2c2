"""The models' time a request: TimedForward's CUDA-event time, its mean."""

from portbench import readings


def read(r):
    return readings.value(r, "model_ms")
