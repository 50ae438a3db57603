"""Milliseconds the host takes to issue one training step: the program's
``train.step`` span (input upload, gradient, update; it does not wait for the
card), the mean over the window. Beside ``train_step_ms`` it says whether a
step is host dispatch or device work."""
from portbench import harness


def read(records: dict) -> float | None:
    return harness.span_mean_ms(records, "train.step")
