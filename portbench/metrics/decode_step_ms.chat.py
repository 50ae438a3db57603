"""Milliseconds of a decode step of the whole batch in chat traffic: the
program's ``serve.decode`` span, which ends at the token's host sync. There
a step is the gap between two tokens, so it moves the gap's tail."""
from portbench import harness


def read(records: dict) -> float | None:
    return harness.span_mean_ms(records, "serve.decode")
