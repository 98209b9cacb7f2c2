"""Device ms a stack of the program's span dfv.volume (the four differential focus volumes),
in the traced slice."""

from portbench import program_spans


def read(r):
    return program_spans.span_ms(r, "dfv.volume", "device", "stack")
