"""Milliseconds the host takes to issue a decode step of the whole batch: the
program's ``serve.decode.issue`` span, from the start of ``serve.decode`` to
its host sync, the mean over the window."""
from portbench import harness


def read(records: dict) -> float | None:
    return harness.span_mean_ms(records, "serve.decode.issue")
