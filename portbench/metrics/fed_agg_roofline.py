"""Share (%) of ``fed_agg``'s roofline: the least time of the rounds' weighted
sums over their (K, N) f32 stacks (``counts.roofline``), over the device time
of the kernels the op launched in the profiled sub-window."""
from portbench import harness
from portbench.counts import roofline

KERNELS = ("fed_agg_kernel",)


def read(records: dict) -> float | None:
    tr = records.get("trace")
    if not tr:
        return None
    calls = [(k, n) for t, k, n in records["fed_agg_calls"] if tr["t0"] <= t <= tr["t1"]]
    launches, seconds = harness.kernel_seconds(tr, KERNELS)
    bounds = [roofline.fed_agg_bound_s(k, n, records["card"]) for k, n in calls]
    if not calls or launches != len(calls) or seconds <= 0 or None in bounds:
        return None
    return 100.0 * sum(bounds) / seconds
