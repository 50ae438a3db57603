"""Share (%) of ``ssd_scan``'s roofline read through the op's own range: the
least time of one call at the prefill's shapes (``counts.roofline``) times
the calls, over the device time of the program's ``kernel.ssd_scan`` ranges
(one a call, around the launch alone) in the profiled sub-window. It reads
the op whatever kernel implements it; ``ssd_scan_roofline`` reads the
kernels by symbol."""
from portbench import harness
from portbench.counts import roofline

RANGE = "kernel.ssd_scan"


def read(records: dict) -> float | None:
    tr, shape = records.get("trace"), records.get("ssd_shape")
    if not tr or not shape:
        return None
    spans = [b - a for a, b, name in tr["kernels"] if name == RANGE]
    bound = roofline.ssd_bound_s(records["card"], **shape)
    if not spans or sum(spans) <= 0 or bound is None:
        return None
    return 100.0 * len(spans) * bound / sum(spans)
