"""Device ms a stack of the program's span ddffnet.score (the fusion of the N per-slice
maps), in the traced slice."""

from portbench import program_spans


def read(r):
    return program_spans.span_ms(r, "ddffnet.score", "device", "stack")
