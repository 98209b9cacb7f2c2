"""Device ms a stack of the program's span ddffnet.decode (the 5 upconvs, the decoder's 13 convs and
the CC3 concat), in the traced slice."""

from portbench import program_spans


def read(r):
    return program_spans.span_ms(r, "ddffnet.decode", "device", "stack")
