"""Share (%) of the profiled sub-window of serving the hybrid in which no
operation ran on the card."""
from portbench import harness


def read(records: dict) -> float | None:
    return harness.idle_share(records)
