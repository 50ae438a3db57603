"""Share (%) of ``flash_attention``'s roofline at the cell's prefill shape:
the least time of one causal call (``counts.granite_hybrid``: q, k, v and o
once against the visible pairs' operations) times the calls, over the device
time of the program's ``kernel.flash_attention`` ranges (one a call, around
the launch alone) in the profiled sub-window."""
from portbench.counts import granite_hybrid

RANGE = "kernel.flash_attention"


def read(records: dict) -> float | None:
    tr, shape = records.get("trace"), records.get("flash_shape")
    if not tr or not shape:
        return None
    spans = [b - a for a, b, name in tr["kernels"] if name == RANGE]
    bound = granite_hybrid.flash_bound_s(records["card"], **shape)
    if not spans or sum(spans) <= 0 or bound is None:
        return None
    return 100.0 * len(spans) * bound / sum(spans)
