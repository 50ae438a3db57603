"""Milliseconds a round spends putting its rows onto the card's (K, N) stack:
the program's ``aggregate.stack`` span inside ``aggregate`` (the rows go up
from pageable host memory), the mean over the window."""
from portbench import harness


def read(records: dict) -> float | None:
    return harness.span_mean_ms(records, "aggregate.stack")
