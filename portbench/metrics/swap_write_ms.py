"""Milliseconds of a hot swap's chunked device writes, with their pauses: the
program's ``serve.swap.write`` span inside ``serve.swap``, the mean over the
window."""
from portbench import harness


def read(records: dict) -> float | None:
    return harness.span_mean_ms(records, "serve.swap.write")
