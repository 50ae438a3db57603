"""The reader of the fused mixer share, on synthetic traces: 100 × the
``kernel.ssm_prefill_in`` ranges ÷ the ``kernel.ssd_scan`` ranges, each
counted by exact name, and None where the program records no fused range."""
from __future__ import annotations

import pytest

from portbench import harness


def _trace(names):
    return {"t0": 0.0, "t1": 1.0, "window_s": 1.0, "busy_s": 0.5,
            "kernels": [(0.01 * i, 0.01 * i + 0.005, n) for i, n in enumerate(names)]}


def test_fused_share_counts_ranges_by_exact_name():
    read = harness.load_by_name("metrics", "ssm_fused_share").read
    layer = ["kernel.ssm_prefill_in", "ssm_prefill_in_kernel", "kernel.ssd_scan",
             "ssd_mma_kernel", "kernel.ssm_prefill_out", "ssm_prefill_out_kernel"]
    assert read({"trace": _trace(layer * 9)}) == pytest.approx(100.0)
    assert read({"trace": _trace(layer * 3 + ["kernel.ssd_scan"] * 3)}) == pytest.approx(50.0)
    eager = ["kernel.ssd_scan", "ssd_mma_kernel", "elementwise_kernel"] * 4  # the parent
    assert read({"trace": _trace(eager)}) is None
    assert read({"trace": None}) is None
    assert read({"trace": _trace(["kernel.ssm_prefill_in"])}) is None


def test_fused_share_entry():
    (entry,) = [m for m in harness.manifest()["per_layer"] if m["name"] == "ssm_fused_share"]
    assert entry["workloads"] == ["mamba2.long_prompts", "granite4h.long_docs"]
    assert entry["layer"] == "launch.steps and models.ssm" and entry["moves"] == "ttft_ms_p90"
    assert entry["source"] == "device_trace" and entry["unit"] == "%"
