"""The serving entry's own time a request: the mean request time by the
host clock (the call to the depth map on the host) less TimedForward's
CUDA-event time a request."""

from portbench import readings


def read(r):
    value = readings.value(r, "request_ms")
    model = readings.value(r, "model_ms")
    return None if value is None or model is None else value - model
