"""Milliseconds of a hybrid's decode step of the whole batch: the program's
``serve.decode`` span, which ends at the token's host sync."""
from portbench import harness


def read(records: dict) -> float | None:
    return harness.span_mean_ms(records, "serve.decode")
