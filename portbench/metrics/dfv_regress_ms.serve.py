"""Device ms a stack of the program's span dfv.regress (the cost's resize
to full resolution and the softmax regression), in the traced slice."""

from portbench import program_spans


def read(r):
    return program_spans.span_ms(r, "dfv.regress", "device", "stack")
