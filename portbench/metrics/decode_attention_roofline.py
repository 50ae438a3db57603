"""Share (%) of ``decode_attention``'s roofline at the cell's decode shape:
the least time of one call over the fewest valid ring entries a step of the
cell has, the prompt and the first token (``counts.granite_hybrid``), times
the calls, over the device time of the program's ``kernel.decode_attention``
ranges in the profiled sub-window."""
from portbench.counts import granite_hybrid

RANGE = "kernel.decode_attention"


def read(records: dict) -> float | None:
    tr, shape = records.get("trace"), records.get("decode_shape")
    if not tr or not shape:
        return None
    spans = [b - a for a, b, name in tr["kernels"] if name == RANGE]
    bound = granite_hybrid.decode_attention_bound_s(records["card"], **shape)
    if not spans or sum(spans) <= 0 or bound is None:
        return None
    return 100.0 * len(spans) * bound / sum(spans)
