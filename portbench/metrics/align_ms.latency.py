"""Device ms a request of the program's span e2e.align (FlowNetwork, its
warps included), in the traced slice."""

from portbench import program_spans


def read(r):
    return program_spans.span_ms(r, "e2e.align", "device", "call")
