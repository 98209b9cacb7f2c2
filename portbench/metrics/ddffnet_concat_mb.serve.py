"""MB a forward that DDFFNet's CC3 concat writes (the program's counter
ddffnet.concat_bytes), in the traced slice."""

from portbench import program_spans


def read(r):
    return program_spans.counter_per_call(r, "ddffnet.concat_bytes", 1e-6)
