"""Milliseconds of a hot swap: the program's ``serve.swap`` span (host copy,
chunked device writes, the flip), the mean over the window."""
from portbench import harness


def read(records: dict) -> float | None:
    return harness.span_mean_ms(records, "serve.swap")
