"""The readers of the program's finer spans, on synthetic records: each reads
its span (or a child found by name and time inside its parent), leaves out
spans that overlap the profiled sub-window, and reads None where the span is
missing, as it is in a program that does not record it."""
from __future__ import annotations

import pytest

from portbench import harness

PROFILED = {"t0": 100.0, "t1": 101.0, "window_s": 1.0, "busy_s": 0.1}

# metric -> the span it averages
MEAN_READERS = {
    "host_copy_ms": "host_copy",
    "aggregate_upload_ms": "aggregate.stack",
    "train_dispatch_ms": "train.step",
    "swap_wait_ms": "serve.swap.wait",
    "swap_write_ms": "serve.swap.write",
    "decode_dispatch_ms": "serve.decode.issue",
    "prefill_dispatch_ms": "serve.prefill.issue",
}


def _read(metric: str, records: dict):
    return harness.load_by_name("metrics", metric).read(records)


@pytest.mark.parametrize("metric,span", sorted(MEAN_READERS.items()))
def test_mean_readers_leave_out_the_profiled_sub_window(metric, span):
    spans = [(span, float(i), 0.010) for i in range(5)]
    spans.append((span, 100.5, 0.9))  # slowed by the profiler
    spans.append(("other", 2.0, 5.0))
    records = {"spans": spans, "trace": PROFILED}
    assert _read(metric, records) == pytest.approx(10.0)
    records["trace"] = None
    assert _read(metric, records) > 10.0
    assert _read(metric, {"spans": [("other", 1.0, 1.0)], "trace": PROFILED}) is None


@pytest.mark.parametrize("metric,parent,child", [("push_encode_ms", "push", "encode"),
                                                 ("pull_decode_ms", "pull", "decode")])
def test_children_are_summed_inside_each_parent(metric, parent, child):
    spans = [
        (parent, 0.0, 1.0), (child, 0.1, 0.2), (child, 0.4, 0.3),  # 500 ms in one
        (parent, 2.0, 1.0), (child, 2.5, 0.1),                      # 100 ms in the next
        (parent, 4.0, 1.0),                                         # none (a skipped pull)
        (child, 3.5, 0.4),                                          # between parents
        (parent, 100.2, 0.5), (child, 100.3, 0.1),                  # profiled: left out
    ]
    records = {"spans": spans, "trace": PROFILED}
    assert _read(metric, records) == pytest.approx(1e3 * (0.5 + 0.1 + 0.0) / 3)
    records["trace"] = None
    assert _read(metric, records) == pytest.approx(1e3 * (0.5 + 0.1 + 0.0 + 0.1) / 4)
    # the parent program records the parent and no child
    assert _read(metric, {"spans": [(parent, 0.0, 1.0)], "trace": PROFILED}) is None
    assert _read(metric, {"spans": [(child, 0.0, 1.0)], "trace": PROFILED}) is None


def test_decode_during_swap_reads_steps_beside_the_watchers_work():
    spans = [
        ("serve.decode", 0.00, 0.030),                              # steady
        ("serve.poll", 1.00, 0.50), ("get", 1.00, 0.01), ("decode", 1.01, 0.45),
        ("serve.decode", 1.10, 0.060),                              # beside the npz decode
        ("serve.swap", 2.00, 1.00), ("serve.swap.write", 2.10, 0.80),
        ("serve.decode", 2.50, 0.040),                              # beside the writes
        ("serve.decode", 3.50, 0.030),                              # steady
        ("decode", 5.00, 0.50), ("serve.decode", 5.10, 0.030),      # a decode outside any poll
        ("serve.swap.write", 100.2, 0.5), ("serve.decode", 100.3, 0.2),  # profiled: left out
    ]
    records = {"spans": spans, "trace": PROFILED}
    assert _read("decode_step_ms.during_swap", records) == pytest.approx(50.0)
    records["trace"] = None
    assert _read("decode_step_ms.during_swap", records) == pytest.approx(1e3 * 0.3 / 3)
    steady = [("serve.decode", 0.0, 0.03), ("serve.swap", 2.0, 1.0)]  # no write span
    assert _read("decode_step_ms.during_swap", {"spans": steady, "trace": PROFILED}) is None


def test_every_new_reader_is_listed_where_its_spans_are_recorded():
    bench = harness.manifest()
    cells = {m["name"]: m["workloads"] for m in bench["per_layer"]}
    training = ["host_copy_ms", "push_encode_ms", "pull_decode_ms", "aggregate_upload_ms",
                "train_dispatch_ms"]
    for metric in training:
        assert cells[metric] == ["resnet18.small_shards"]
    for metric in ("swap_wait_ms", "swap_write_ms", "decode_step_ms.during_swap"):
        assert cells[metric] == ["mamba2.chat_swaps"]
    for metric in ("decode_dispatch_ms", "prefill_dispatch_ms", "ssd_scan_roofline.op"):
        assert cells[metric] == ["mamba2.long_prompts"]


def test_ssd_roofline_through_the_op_range():
    shape = {"B": 8, "S": 8192, "H": 24, "P": 64, "N": 128, "chunk": 256, "itemsize": 2}
    card = "NVIDIA H100 80GB HBM3"
    kernels = []
    for i in range(4):  # each launch and its range, on the same interval
        a = 1.0 + i
        kernels += [(a, a + 0.001, "void ssd_mma_kernel<64, 128>"), (a, a + 0.001, "kernel.ssd_scan"),
                    (a + 0.002, a + 0.003, "elementwise_kernel")]
    records = {"trace": {"kernels": kernels, "t0": 0.0, "t1": 9.0}, "ssd_shape": shape,
               "card": card}
    by_symbol = _read("ssd_scan_roofline", records)
    by_range = _read("ssd_scan_roofline.op", records)
    assert by_range == pytest.approx(by_symbol) and 0 < by_range < 100
    # a kernel renamed: the symbol reader finds nothing, the range still reads
    records["trace"]["kernels"] = [(a, b, "kernel.ssd_scan" if n == "kernel.ssd_scan" else
                                    n.replace("ssd_mma_kernel", "ssd_v2"))
                                   for a, b, n in kernels]
    assert _read("ssd_scan_roofline", records) is None
    assert _read("ssd_scan_roofline.op", records) == pytest.approx(by_range)
    # the program without ranges
    records["trace"]["kernels"] = [k for k in kernels if k[2] != "kernel.ssd_scan"]
    assert _read("ssd_scan_roofline.op", records) is None
    assert _read("ssd_scan_roofline.op", {"trace": None, "ssd_shape": shape, "card": card}) is None
