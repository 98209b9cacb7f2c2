"""Share of the bytes that the serving entry staged on the card that came
through its pinned stage-in (the program's counters serve.staged_pinned and
serve.staged_bytes), in the traced slice."""

from portbench import stage_in


def read(r):
    return stage_in.pinned_pct(r)
