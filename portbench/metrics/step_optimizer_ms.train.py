"""Device ms a step of the program's span train.optimizer (Adam's step), in
the traced slice."""

from portbench import program_spans


def read(r):
    return program_spans.span_ms(r, "train.optimizer", "device", "call")
