"""Milliseconds of a training step: the program's ``train`` spans (one an
epoch, ended by the epoch's single host sync) over the steps in them."""
from portbench import harness


def read(records: dict) -> float | None:
    xs = harness.span_durations(records, "train")
    return 1e3 * sum(xs) / (len(xs) * records["steps_per_epoch"]) if xs else None
