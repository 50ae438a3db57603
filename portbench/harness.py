"""What every driver shares: the manifest and the files found by name, the
clock from process start, the window's statistics, the profiled sub-window
and the checks' table. Imports nothing of the program under test."""
from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(__file__).resolve().parent

# Top-level module names the process that prints a result may not hold.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(name: str) -> tuple[dict, dict, dict]:
    """(cell entry, configuration file, traffic file) of the cell ``name``."""
    bench = manifest()
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return cell, load_json(ROOT / entry["file"]), load_json(PKG / "traffic" / f"{cell['traffic']}.json")


def load_by_name(kind: str, name: str):
    """The module ``portbench/<kind>/<name>.py``, loaded by path: a metric's
    name may hold dots."""
    path = PKG / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_')}",
                                                  path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def process_age_s() -> float:
    """Seconds since this process was started (the kernel's start time, in
    clock ticks since boot, against the uptime)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])  # field 22 of stat(5), counted after the name
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN_MODULES``,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN_MODULES})


def card_power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


# -- statistics over the whole window -----------------------------------------


def percentile(values, q: float) -> float:
    """The q-th percentile (0..100), linear between ranks, of every value."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no samples")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: float, seconds: float) -> float:
    if seconds <= 0:
        raise ValueError("a rate over no time")
    return count / seconds


# -- the profiled sub-window --------------------------------------------------


class Profiled:
    """``torch.profiler`` (host and card) over a sub-window. ``stop()`` ends
    it at once; ``result()``, called once the window has closed (reading the
    trace takes seconds of host time), gives the card's operations on the
    host's ``perf_counter`` clock, the union of them as busy seconds, and the
    sub-window's length."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.t0 = self.t1 = None
        self.mark = None

    @property
    def done(self) -> bool:
        return self.t1 is not None

    def start(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.prof.start()
        self.mark = time.perf_counter()
        with torch.profiler.record_function("portbench.mark"):
            pass
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def result(self) -> dict | None:
        from torch.autograd import DeviceType

        if not self.done:
            return None
        events = self.prof.events()
        mark = next(e for e in events if e.name == "portbench.mark")
        offset = self.mark - mark.time_range.start / 1e6  # profiler us -> perf_counter s
        kernels = sorted((e.time_range.start / 1e6 + offset, e.time_range.end / 1e6 + offset,
                          e.name) for e in events if e.device_type == DeviceType.CUDA)
        if not kernels:
            raise RuntimeError("the profiler traced no operation on the card")
        busy, end = 0.0, float("-inf")
        for a, b, _ in kernels:
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
        return {"kernels": kernels, "busy_s": busy, "window_s": self.t1 - self.t0,
                "t0": self.t0, "t1": self.t1}


def breakdown(trace: dict, spans: list) -> dict:
    """The ten device operations that took most time, and the ten longest
    gaps in which no operation ran, each named by the host span it fell in
    (``spans``: (name, start, seconds) on ``perf_counter``)."""
    by_name: dict[str, float] = {}
    for a, b, name in trace["kernels"]:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps, end = [], trace["t0"]
    for a, b, _ in trace["kernels"] + [(trace["t1"], trace["t1"], "")]:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]

    def host(at: float) -> str:
        inner = [(d, n) for n, s, d in spans if s <= at <= s + d]
        return min(inner)[1] if inner else "outside any span"

    return {"device_ops": [[name[:120], s] for name, s in ops],
            "idle_gaps": [[host((a + b) / 2), b - a] for a, b in gaps]}


def kernel_seconds(trace: dict, symbols) -> tuple[int, float]:
    """(launches, device seconds) of the kernels whose names hold one of
    ``symbols`` in the profiled sub-window."""
    hits = [(b - a) for a, b, name in trace["kernels"] if any(s in name for s in symbols)]
    return len(hits), sum(hits)


# -- the checks ---------------------------------------------------------------


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; ``correct`` when every number
    is finite and at most its limit. A number that could not be read is
    ``None`` and fails."""
    table = {}
    ok = True
    for name, limit in limits.items():
        value = readings.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        table[name] = {"value": value, "limit": limit}
    return ok, table


# -- parameter trees as {'a/b/c': leaf} ----------------------------------------


def nested(flat: dict) -> dict:
    """{'a/b': leaf} -> {'a': {'b': leaf}}."""
    tree: dict = {}
    for path, leaf in flat.items():
        *parents, last = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def flat_paths(tree, prefix: str = "") -> dict:
    """{'a': {'b': leaf}} -> {'a/b': leaf}."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for key in sorted(tree):
        out.update(flat_paths(tree[key], f"{prefix}/{key}" if prefix else key))
    return out


def worst_leaf_gap(program: dict, reference: dict, skip=()) -> tuple[float, str]:
    """(gap, leaf): the max over leaves of | |program leaf| - |reference
    leaf| |, over the larger of the reference leaf's norm and the median
    leaf's norm (2-norms, float64), and the leaf that reads it."""
    import torch

    norms_r = {k: float(torch.linalg.vector_norm(v.double())) for k, v in reference.items()}
    median = sorted(norms_r.values())[len(norms_r) // 2]
    worst, leaf = 0.0, ""
    for k, ref_norm in norms_r.items():
        if k in skip:
            continue
        got = float(torch.linalg.vector_norm(program[k].double()))
        gap = abs(got - ref_norm) / max(ref_norm, median, 1e-30)
        if gap > worst:
            worst, leaf = gap, k
    return worst, leaf


# -- what the per-layer readers share -----------------------------------------------


def span_durations(records: dict, name: str) -> list[float]:
    """Seconds of every ``name`` span of the window that does not overlap the
    profiled sub-window (the profiler slows the host while it runs)."""
    tr = records.get("trace")
    return [d for n, s, d in records["spans"]
            if n == name and not (tr and s < tr["t1"] and s + d > tr["t0"])]


def span_mean_ms(records: dict, name: str) -> float | None:
    xs = span_durations(records, name)
    return 1e3 * sum(xs) / len(xs) if xs else None


def idle_share(records: dict) -> float | None:
    tr = records.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (tr["window_s"] - tr["busy_s"]) / tr["window_s"]


def untraced_rate(records: dict, key: str) -> float | None:
    """Per second of the window outside the profiled sub-window: the events
    ``records[key]`` ((time, amount) pairs) that fall outside it."""
    tr = records.get("trace")
    events = records[key]
    if tr:
        amount = sum(a for t, a in events if not tr["t0"] <= t <= tr["t1"])
        seconds = records["window_s"] - tr["window_s"]
    else:
        amount, seconds = sum(a for _, a in events), records["window_s"]
    return amount / seconds if seconds > 0 else None
