"""Device ms a stack of the program's span dffnet.aggregate (the confidence
head, dres0 to hourglass(16)), in the traced slice."""

from portbench import program_spans


def read(r):
    return program_spans.span_ms(r, "dffnet.aggregate", "device", "stack")
