"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the line holds the cell's end-to-end metrics, measured
with the program's telemetry off; with ``--trace 1`` its per-layer metrics,
read from the program's spans, the benchmark's counts and a profiled
sub-window, with the device's busy seconds and a breakdown. Both check what
the window produced against the plain reference and print every compared
number beside its limit, last on standard error and last in the line.

Exits 2 without a result when there is no CUDA card or fewer than the cell
asks for, and 3 when the process holds JAX or the JAX package once the
window has closed.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    """The program under test, ``src/repro_torch``, on the import path."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from portbench import harness

    cell, cfg, mix = harness.workload(args.workload)
    _environment()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    driver = harness.load_by_name("drivers", cfg["driver"])
    result = driver.run(cfg, mix, seed=args.seed, seconds=args.seconds, trace=bool(args.trace))

    leaked = harness.forbidden_loaded()
    if leaked:
        print(f"portbench: the process holds {', '.join(leaked)}", file=sys.stderr)
        return 3
    bench = harness.manifest()
    name = cell["name"]

    def listed(metric: dict) -> bool:
        return name in metric.get("workloads", [name])

    metrics = {}
    if args.trace:
        records = result["records"]
        card = torch.cuda.get_device_name(0)
        records["card"] = card
        for metric in filter(listed, bench["per_layer"]):
            value = harness.load_by_name("metrics", metric["name"]).read(records)
            if value is not None:
                metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    else:
        values = dict(result["metrics"], setup_s=result["setup_s"])
        for metric in filter(listed, bench["end_to_end"]):
            metrics[metric["name"]] = {"value": values[metric["name"]], "unit": metric["unit"]}
    correct, checks = harness.judge(result["readings"], result["limits"])
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": result["memory_peak_bytes"],
              "power_limit": harness.card_power_limit()}
    line = {"correct": correct and result["failed"] == 0, "attempted": result["attempted"],
            "failed": result["failed"], "metrics": metrics, "device": device}
    trace = result["records"].get("trace")
    if args.trace and trace:
        device.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
        line["breakdown"] = harness.breakdown(trace, result["records"]["spans"])
    line["checks"] = checks
    for check, entry in checks.items():
        print(f"check {check}: {entry['value']} (limit {entry['limit']})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
