"""Milliseconds a hot swap waits for the batch still decoding on the standby
device leaves: the program's ``serve.swap.wait`` span inside ``serve.swap``,
the mean over the window."""
from portbench import harness


def read(records: dict) -> float | None:
    return harness.span_mean_ms(records, "serve.swap.wait")
