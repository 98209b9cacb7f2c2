"""Device ms a stack of the program's span dfv.features (the transpose in
and the per-slice 2-D feature pyramid), in the traced slice."""

from portbench import program_spans


def read(r):
    return program_spans.span_ms(r, "dfv.features", "device", "stack")
