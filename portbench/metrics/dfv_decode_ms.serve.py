"""Device ms a stack of the program's span dfv.decode (decoder6 to decoder3 with their concatenations),
in the traced slice."""

from portbench import program_spans


def read(r):
    return program_spans.span_ms(r, "dfv.decode", "device", "stack")
