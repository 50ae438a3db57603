"""The reader of the in-place decode share, on synthetic records: 100 × the
``decode.inplace`` spans ÷ the ``decode`` spans, both inside ``pull`` spans
that do not overlap the profiled sub-window, and None where the program
records no ``decode.inplace`` span."""
from __future__ import annotations

import pytest

from portbench import harness

PROFILED = {"t0": 100.0, "t1": 101.0, "window_s": 1.0, "busy_s": 0.1}


def _read(records: dict):
    return harness.load_by_name("metrics", "pull_inplace_share").read(records)


def test_pull_inplace_share_counts_decodes_inside_each_pull():
    spans = [
        ("pull", 0.0, 1.0), ("decode", 0.1, 0.2), ("decode.inplace", 0.15, 0.1),
        ("decode", 0.4, 0.3),                                        # through np.load
        ("pull", 2.0, 1.0), ("decode", 2.5, 0.1), ("decode.inplace", 2.52, 0.05),
        ("decode", 3.5, 0.4), ("decode.inplace", 3.55, 0.3),         # outside any pull
        ("pull", 100.2, 0.5), ("decode", 100.3, 0.1),                # profiled: left out
        ("decode.inplace", 100.31, 0.05),
    ]
    records = {"spans": spans, "trace": PROFILED}
    assert _read(records) == pytest.approx(100.0 * 2 / 3)
    records["trace"] = None
    assert _read(records) == pytest.approx(100.0 * 3 / 4)
    # every decode in place
    whole = [("pull", 0.0, 1.0), ("decode", 0.1, 0.2), ("decode.inplace", 0.15, 0.1)]
    assert _read({"spans": whole, "trace": PROFILED}) == 100.0
    # the parent program records decodes and no decode.inplace
    parent = [(n, s, d) for n, s, d in spans if n != "decode.inplace"]
    assert _read({"spans": parent, "trace": PROFILED}) is None
    # in-place decodes, but none inside a pull
    outside = [("pull", 0.0, 1.0), ("decode", 3.5, 0.4), ("decode.inplace", 3.55, 0.3)]
    assert _read({"spans": outside, "trace": PROFILED}) is None


def test_pull_inplace_share_is_listed_for_the_training_cell():
    (entry,) = [m for m in harness.manifest()["per_layer"] if m["name"] == "pull_inplace_share"]
    assert entry["workloads"] == ["resnet18.small_shards"]
    assert entry["layer"] == "core.transport codecs"
    assert entry["moves"] == "train_samples_per_s"
