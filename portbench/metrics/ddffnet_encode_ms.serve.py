"""Device ms a stack of the program's span ddffnet.encode (the transpose in, the encoder's 13 convs and
5 pools), in the traced slice."""

from portbench import program_spans


def read(r):
    return program_spans.span_ms(r, "ddffnet.encode", "device", "stack")
