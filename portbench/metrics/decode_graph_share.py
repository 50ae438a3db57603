"""Share (%) of the window's decode steps that the serving node replayed
from a CUDA graph: 100 × the program's ``serve.decode.replay`` spans (one
inside each replayed step's ``serve.decode.issue``) ÷ its ``serve.decode``
spans. None where the program records no replay span, as a program without
decode graphs does."""
from portbench import harness


def read(records: dict) -> float | None:
    replays = harness.span_durations(records, "serve.decode.replay")
    steps = harness.span_durations(records, "serve.decode")
    return 100.0 * len(replays) / len(steps) if replays and steps else None
