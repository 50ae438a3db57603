"""Milliseconds the store watcher spends polling for each swap: every
``serve.poll`` span of the window (an empty poll included, and the blob's
npz decode) over the swaps (``serve.swap`` spans), both outside the profiled
sub-window."""
from portbench import harness


def read(records: dict) -> float | None:
    swaps = harness.span_durations(records, "serve.swap")
    if not swaps:
        return None
    return 1e3 * sum(harness.span_durations(records, "serve.poll")) / len(swaps)
