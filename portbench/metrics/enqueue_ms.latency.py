"""Host ms a request of the program's span serve.forward: the time the host
takes to enqueue the forward, in the traced slice."""

from portbench import program_spans


def read(r):
    return program_spans.span_ms(r, "serve.forward", "host", "call")
