"""Share (%) of ``ssd_scan``'s roofline at the prefill's shapes (every batch
of the mix has the same): the least time of one call (``counts.roofline``)
times the launches, over the device time of the kernels the op launched in
the profiled sub-window."""
from portbench import harness
from portbench.counts import roofline

KERNELS = ("ssd_mma_kernel", "ssd_scan_kernel")


def read(records: dict) -> float | None:
    tr, shape = records.get("trace"), records.get("ssd_shape")
    if not tr or not shape:
        return None
    launches, seconds = harness.kernel_seconds(tr, KERNELS)
    bound = roofline.ssd_bound_s(records["card"], **shape)
    if not launches or seconds <= 0 or bound is None:
        return None
    return 100.0 * launches * bound / seconds
