"""Device ms a step of the program's span train.backward, in the traced
slice."""

from portbench import program_spans


def read(r):
    return program_spans.span_ms(r, "train.backward", "device", "call")
