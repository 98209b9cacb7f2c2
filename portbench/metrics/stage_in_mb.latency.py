"""MB a request that the serving entry staged on the card from elsewhere
(the program's counter serve.staged_bytes), in the traced slice."""

from portbench import program_spans


def read(r):
    return program_spans.counter_per_call(r, "serve.staged_bytes", 1e-6)
