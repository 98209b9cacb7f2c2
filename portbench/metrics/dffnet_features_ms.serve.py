"""Device ms a stack of the program's span dffnet.features (FM_module,
both EFD+SRD, hourglassup), in the traced slice."""

from portbench import program_spans


def read(r):
    return program_spans.span_ms(r, "dffnet.features", "device", "stack")
