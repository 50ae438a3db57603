"""Share (%) of the card's float32 peak (outside the tensor cores: the cell
runs without TF32) that the client's training reaches: ResNet-18's operations
for every sample trained, over the window's seconds outside the profiled
sub-window."""
from portbench import harness
from portbench.counts import peaks


def read(records: dict) -> float | None:
    peak = peaks.rate(peaks.F32_FLOPS, records["card"])
    samples_per_s = harness.untraced_rate(records, "sample_events")
    if peak is None or samples_per_s is None:
        return None
    return 100.0 * samples_per_s * records["train_flops_per_sample"] / peak
