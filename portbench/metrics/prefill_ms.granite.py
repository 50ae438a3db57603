"""Milliseconds of a hybrid's bulk prefill of the whole batch: the program's
``serve.prefill`` span, which ends at the first token's host sync."""
from portbench import harness


def read(records: dict) -> float | None:
    return harness.span_mean_ms(records, "serve.prefill")
