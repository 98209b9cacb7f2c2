"""MB a forward that the program's differential focus volumes write (the
program's counter dfv.volume_bytes), in the traced slice."""

from portbench import program_spans


def read(r):
    return program_spans.counter_per_call(r, "dfv.volume_bytes", 1e-6)
