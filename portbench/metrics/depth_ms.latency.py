"""Device ms a request of the program's span e2e.depth (DFFNet on the
aligned stack), in the traced slice."""

from portbench import program_spans


def read(r):
    return program_spans.span_ms(r, "e2e.depth", "device", "call")
