"""Milliseconds of the device-to-host copy of the client's parameters before
each push: the program's ``host_copy`` span (``FederatedCallback``, around
``Trainer.host_params``), the mean over the window."""
from portbench import harness


def read(records: dict) -> float | None:
    return harness.span_mean_ms(records, "host_copy")
