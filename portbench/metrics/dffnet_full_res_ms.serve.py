"""Device ms a stack of the program's span dffnet.full_res (the
full-resolution stage and the heads), in the traced slice."""

from portbench import program_spans


def read(r):
    return program_spans.span_ms(r, "dffnet.full_res", "device", "stack")
