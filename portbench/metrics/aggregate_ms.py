"""Milliseconds of a federation round's ``aggregate`` span, the mean over the window."""
from portbench import harness


def read(records: dict) -> float | None:
    return harness.span_mean_ms(records, "aggregate")
