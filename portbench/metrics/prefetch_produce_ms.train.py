"""Host ms a batch of the program's span prefetch.produce: the prefetch
thread pins a batch and enqueues its copies, over the batches it made in the
traced slice."""

from portbench import program_spans


def read(r):
    return program_spans.span_ms(r, "prefetch.produce", "host", "firing")
