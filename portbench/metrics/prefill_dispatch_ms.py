"""Milliseconds the host takes to issue a bulk prefill: the program's
``serve.prefill.issue`` span, from the start of ``serve.prefill`` to its host
sync, the mean over the window."""
from portbench import harness


def read(records: dict) -> float | None:
    return harness.span_mean_ms(records, "serve.prefill.issue")
