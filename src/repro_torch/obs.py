"""``python -m repro_torch.obs`` — the serverless observability CLI (the port
of the reference's ``python -m repro.obs``; it reads stores that either
package wrote).

Fleet telemetry lives in the store itself (``obs/<node>/<seq>`` blobs each
node deposits; see ``repro_torch.core.telemetry``), so the dashboard is just a
reader — coordinator-free, runnable from any host that can see the mount,
and adding nothing to the data path::

    python -m repro_torch.obs watch --store /mnt/shared/exp1          # live dashboard
    python -m repro_torch.obs watch --store /mnt/shared/exp1 --once   # one snapshot
    python -m repro_torch.obs trace --store /mnt/shared/exp1 --out trace.json

``watch`` prints a per-node table: round rate, update staleness (the FedAsync
signal), bytes moved, round-phase latencies, and flags stragglers (round rate
under half the fleet median). Serving-tier nodes (``repro_torch.api.serve``)
show up in their own SERVE table — deploys, tokens/sec, rounds-behind-store
staleness, swap-latency percentiles — fed purely from the same store blobs.
``trace`` merges every node's span ring into one Chrome trace-event JSON —
open it at https://ui.perfetto.dev (or chrome://tracing) to see the fleet's
phases on a single timeline: each node a process, each of its recording
threads (trainer, prefetcher, serving watcher) its own track, and each span's
id, parent id and trace id (the round, batch or deployment it belongs to) as
its ``args``. Spans time the host: work the card runs asynchronously shows as
long as the host took to issue it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from repro_torch.core.telemetry import chrome_trace, collect_obs, telemetry_rollups


def render_dashboard(obs_by_node: dict, *, printer=print) -> dict:
    """Print one dashboard frame from collected obs payloads; returns the
    rollups dict it rendered (handy for tests and callers)."""
    rollups = telemetry_rollups(obs_by_node)
    nodes = rollups["nodes"]
    fleet = rollups["fleet"]
    if not nodes:
        printer("[obs] no obs/ blobs found — is telemetry enabled? "
                "(REPRO_OBS=1 or telemetry=True on the node)")
        return rollups
    # Serving nodes report SLOs, not training rounds — split them out so they
    # get their own table and don't drag the straggler median down.
    serving = {n: v for n, v in nodes.items() if v.get("role") == "serve"}
    trainers = {n: v for n, v in nodes.items() if n not in serving}
    rates = sorted(v["rounds_per_sec"] for v in trainers.values()) or [0.0]
    median_rate = rates[len(rates) // 2]
    churn = fleet.get("adoptions", 0)
    printer(f"[obs] {fleet['nodes_reporting']} nodes reporting, "
            f"{fleet.get('rounds_total', 0)} rounds total, "
            f"fleet staleness mean {fleet.get('staleness_mean', 0.0):.2f}"
            + (f", {churn} adopted" if churn else "")
            + (f", {len(serving)} serving" if serving else ""))
    header = (f"{'node':<14} {'rounds':>6} {'r/s':>6} {'stale(mean/p90)':>16} "
              f"{'MB w/r':>12} {'pull':>8} {'push':>8} {'agg':>8} {'train':>8} "
              f"{'churn':>6} flags")
    printer(header)
    stragglers = []
    for node_id, v in trainers.items():
        phase = v["phase_ms"]
        flags = []
        if median_rate > 0 and v["rounds_per_sec"] < 0.5 * median_rate:
            flags.append("STRAGGLER")
            stragglers.append(node_id)
        if v.get("adopted"):
            flags.append("ADOPTED")
        if v["dropped_spans"]:
            flags.append(f"dropped={v['dropped_spans']}")
        # CHURN column: the lease epoch the node runs at — 0 for founding
        # claims, >0 once a surviving worker adopted the slot.
        churn_txt = f"e{v.get('lease_epoch', 0)}" if v.get("adopted") else "-"
        printer(
            f"{node_id:<14} {v['rounds']:>6} {v['rounds_per_sec']:>6.2f} "
            f"{v['staleness_mean']:>8.2f}/{v['staleness_p90']:<7.2f} "
            f"{v['bytes_written'] / 1e6:>5.2f}/{v['bytes_read'] / 1e6:<6.2f} "
            f"{phase.get('pull', 0.0):>6.2f}ms {phase.get('push', 0.0):>6.2f}ms "
            f"{phase.get('aggregate', 0.0):>6.2f}ms {phase.get('train', 0.0):>6.2f}ms "
            f"{churn_txt:>6} {' '.join(flags)}")
    if stragglers:
        printer(f"stragglers (< 0.5x median {median_rate:.2f} r/s): "
                + ", ".join(stragglers))
    if serving:
        printer(f"{'node':<14} {'deploys':>7} {'tok/s':>8} {'stale(mean/max)':>16} "
                f"{'swap p50/p99 ms':>16} flags")
        for node_id, v in serving.items():
            s = v["serve"]
            flags = ["SERVE"]
            if not s.get("deployed"):
                flags.append("WAITING")
            if s.get("skipped_incompatible"):
                flags.append(f"skipped={s['skipped_incompatible']}")
            printer(
                f"{node_id:<14} {s.get('swaps', 0):>7} "
                f"{s.get('tokens_per_sec', 0.0):>8.1f} "
                f"{s.get('staleness_mean', 0.0):>8.2f}/{s.get('staleness_max', 0.0):<7.2f} "
                f"{s.get('swap_ms_p50', 0.0):>7.1f}/{s.get('swap_ms_p99', 0.0):<8.1f} "
                f"{' '.join(flags)}")
    return rollups


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.obs", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="command", required=True)

    p_watch = sub.add_parser("watch", help="read-only fleet metrics dashboard")
    p_watch.add_argument("--store", required=True,
                         help="data-plane folder URI (cache+/shard<G>+ grammar)")
    p_watch.add_argument("--interval", type=float, default=2.0)
    p_watch.add_argument("--timeout", type=float, default=600.0)
    p_watch.add_argument("--once", action="store_true",
                         help="print one snapshot and exit")

    p_trace = sub.add_parser(
        "trace", help="export merged spans as Chrome trace-event JSON")
    p_trace.add_argument("--store", required=True)
    p_trace.add_argument("--out", default="trace.json",
                         help="output path ('-' for stdout)")

    args = ap.parse_args(argv)

    if args.command == "watch":
        deadline = time.monotonic() + args.timeout
        while True:
            rollups = render_dashboard(collect_obs(args.store))
            if args.once:
                return 0 if rollups["nodes"] else 1
            if time.monotonic() >= deadline:
                return 0
            time.sleep(args.interval)

    if args.command == "trace":
        obs = collect_obs(args.store)
        doc = chrome_trace(obs)
        spans = sum(1 for e in doc["traceEvents"] if e["ph"] == "X")
        if args.out == "-":
            json.dump(doc, sys.stdout)
            print()
        else:
            with open(args.out, "w") as f:
                json.dump(doc, f)
            print(f"wrote {args.out}: {spans} spans from {len(obs)} nodes "
                  f"(open at https://ui.perfetto.dev)")
        return 0 if spans else 1

    raise AssertionError(f"unhandled command {args.command!r}")


if __name__ == "__main__":
    raise SystemExit(main())
