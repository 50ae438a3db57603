"""Share (%) of chat serving's decode steps that the serving node replayed
from a CUDA graph: 100 × the program's ``serve.decode.replay`` spans ÷ its
``serve.decode`` spans. A step that is not replayed issues every layer's
calls from the host, which a swap's host work then slows: the gap's tail.
None where the program records no replay span."""
from portbench import harness


def read(records: dict) -> float | None:
    replays = harness.span_durations(records, "serve.decode.replay")
    steps = harness.span_durations(records, "serve.decode")
    return 100.0 * len(replays) / len(steps) if replays and steps else None
