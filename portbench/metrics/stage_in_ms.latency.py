"""Host ms a request of the program's span serve.stage_in: the serving
entry's copies of the inputs to the card, in the traced slice."""

from portbench import program_spans


def read(r):
    return program_spans.span_ms(r, "serve.stage_in", "host", "call")
