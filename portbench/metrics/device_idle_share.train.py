"""Share (%) of the profiled sub-window (whole epochs and their rounds) in
which no operation ran on the card."""
from portbench import harness


def read(records: dict) -> float | None:
    return harness.idle_share(records)
