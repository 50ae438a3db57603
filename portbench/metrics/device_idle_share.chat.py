"""Share (%) of the profiled sub-window of chat serving in which no
operation ran on the card: the host's share of a decode step and a swap."""
from portbench import harness


def read(records: dict) -> float | None:
    return harness.idle_share(records)
