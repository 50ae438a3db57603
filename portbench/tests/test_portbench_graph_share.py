"""The readers of the decode-graph share, on synthetic records: 100 × the
``serve.decode.replay`` spans ÷ the ``serve.decode`` spans, both outside the
profiled sub-window, and None where the program records no replay span."""
from __future__ import annotations

import pytest

from portbench import harness

PROFILED = {"t0": 100.0, "t1": 101.0, "window_s": 1.0, "busy_s": 0.1}


@pytest.mark.parametrize("metric,cell", [("decode_graph_share", "mamba2.long_prompts"),
                                         ("decode_graph_share.chat", "mamba2.chat_swaps")])
def test_graph_share_counts_replayed_steps(metric, cell):
    read = harness.load_by_name("metrics", metric).read
    spans = []
    for i in range(8):  # 8 steps, 6 replayed
        spans += [("serve.decode", float(i), 0.004), ("serve.decode.issue", float(i), 0.003)]
        if i >= 2:
            spans.append(("serve.decode.replay", i + 0.001, 0.001))
    spans += [("serve.decode", 100.2, 0.004), ("serve.decode.issue", 100.2, 0.003)]  # profiled
    records = {"spans": spans, "trace": PROFILED}
    assert read(records) == pytest.approx(75.0)
    records["trace"] = None
    assert read(records) == pytest.approx(100.0 * 6 / 9)
    eager = [s for s in spans if s[0] != "serve.decode.replay"]  # the parent program
    assert read({"spans": eager, "trace": PROFILED}) is None
    assert read({"spans": [], "trace": None}) is None
    (entry,) = [m for m in harness.manifest()["per_layer"] if m["name"] == metric]
    assert entry["workloads"] == [cell] and entry["layer"] == "launch.steps and models.ssm"
