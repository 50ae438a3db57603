"""Share (%) of the card's dense bf16 peak that serving the hybrid reaches:
its operations for every prompt token prefilled and every token decoded
(``counts.granite_hybrid``), over the window's seconds outside the profiled
sub-window."""
from portbench import harness
from portbench.counts import peaks


def read(records: dict) -> float | None:
    peak = peaks.rate(peaks.BF16_FLOPS, records["card"])
    flops_per_s = harness.untraced_rate(records, "flop_events")
    if peak is None or flops_per_s is None:
        return None
    return 100.0 * flops_per_s / peak
