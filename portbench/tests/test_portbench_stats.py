"""The window's statistics are taken over every sample: a stall put into a
synthetic window moves the rate, the tail and the per-layer readings."""
from __future__ import annotations

from portbench import harness


def _token_times(step_s: float, n: int, stall_at: int | None = None, stall_s: float = 0.0):
    t, out = 0.0, []
    for i in range(n):
        t += step_s + (stall_s if i == stall_at else 0.0)
        out.append(t)
    return out


def test_percentile_takes_every_sample():
    gaps = [20.0] * 990 + [80.0] * 10
    assert harness.percentile(gaps, 50) == 20.0
    assert harness.percentile(gaps, 99.5) > 20.0
    assert harness.percentile([1.0, 3.0], 50) == 2.0


def test_a_stall_moves_the_tail_and_the_rate():
    steady = _token_times(0.025, 1200)
    stalled = _token_times(0.025, 1200, stall_at=600, stall_s=3.0)
    window = 30.0

    def tokens_per_s(times):
        return harness.rate(8 * sum(1 for t in times if t <= window), window)

    def p99(times):
        return harness.percentile([b - a for a, b in zip(times, times[1:]) if b <= window], 99)

    assert tokens_per_s(stalled) < tokens_per_s(steady)
    many_stalls = steady
    for at in range(50, 1200, 50):
        many_stalls = [t + (0.2 if i >= at else 0.0) for i, t in enumerate(many_stalls)]
    assert p99(many_stalls) > 1.5 * p99(steady)


def test_span_readers_leave_out_the_profiled_sub_window():
    spans = [("serve.decode", float(i), 0.02) for i in range(10)]
    spans[5] = ("serve.decode", 5.0, 0.5)  # slowed by the profiler
    records = {"spans": spans, "trace": {"t0": 4.9, "t1": 5.6, "window_s": 0.7, "busy_s": 0.07}}
    assert abs(harness.span_mean_ms(records, "serve.decode") - 20.0) < 1e-9
    assert abs(harness.idle_share(records) - 90.0) < 1e-9
    records["trace"] = None
    assert harness.span_mean_ms(records, "serve.decode") > 20.0


def test_untraced_rate_counts_every_event_outside_the_profile():
    records = {"window_s": 10.0, "sample_events": [(t + 0.5, 64) for t in range(10)],
               "trace": {"t0": 3.0, "t1": 5.0, "window_s": 2.0, "busy_s": 1.0}}
    assert harness.untraced_rate(records, "sample_events") == 64 * 8 / 8.0
    records["trace"] = None
    assert harness.untraced_rate(records, "sample_events") == 64.0


def test_judge_fails_a_missing_or_large_number():
    ok, table = harness.judge({"a": 1e-6, "b": 0.0}, {"a": 1e-5, "b": 0.0})
    assert ok and table["a"] == {"value": 1e-6, "limit": 1e-5}
    assert not harness.judge({"a": 2e-5}, {"a": 1e-5})[0]
    assert not harness.judge({"a": None}, {"a": 1e-5})[0]
    assert not harness.judge({"a": float("nan")}, {"a": 1e-5})[0]


def test_breakdown_names_gaps_by_host_span():
    trace = {"t0": 0.0, "t1": 1.0, "kernels": [(0.1, 0.2, "k1"), (0.6, 0.7, "k2")]}
    spans = [("serve.decode", 0.25, 0.3)]
    out = harness.breakdown(trace, spans)
    assert out["device_ops"][0][0] in ("k1", "k2")
    assert out["idle_gaps"][0][0] == "serve.decode"
    assert abs(sum(s for _, s in out["idle_gaps"]) - 0.8) < 1e-9
