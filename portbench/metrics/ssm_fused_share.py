"""Share (%) of the bulk prefill's Mamba2 mixers whose elementwise work ran
fused: 100 × the program's ``kernel.ssm_prefill_in`` ranges (one around each
launch of the fused kernel before the scan) ÷ its ``kernel.ssd_scan`` ranges
(one a mixer), each counted by exact name among the card's operations of the
profiled sub-window, as ``ssd_scan_roofline.op`` finds its range. None where
the program records no ``kernel.ssm_prefill_in`` range, as a program that
runs the mixer's elementwise chain eagerly does."""

FUSED, SCAN = "kernel.ssm_prefill_in", "kernel.ssd_scan"


def read(records: dict) -> float | None:
    tr = records.get("trace")
    if not tr:
        return None
    names = [name for _, _, name in tr["kernels"]]
    fused, scans = names.count(FUSED), names.count(SCAN)
    return 100.0 * fused / scans if fused and scans else None
