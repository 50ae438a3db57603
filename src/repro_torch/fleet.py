"""``python -m repro_torch.fleet`` — multi-host federation launcher + chaos soak
CLI (the port of ``python -m repro.fleet``; either package's workers join one
fleet).

The fleet coordinates *through the shared folder alone* (spec, slot claims,
heartbeats, results are all ``fleet/`` blobs): no coordinator, no parent
process, exactly like the serverless federation it drives.

Single host, two simulated "hosts" (separate worker invocations)::

    python -m repro_torch.fleet init   --store "$TMPDIR/soak" --nodes 8 --rounds 8 --chaos-kills 2
    python -m repro_torch.fleet worker --store "$TMPDIR/soak" --worker-id hostA --max-slots 4 &
    python -m repro_torch.fleet worker --store "$TMPDIR/soak" --worker-id hostB --max-slots 4
    python -m repro_torch.fleet report --store "$TMPDIR/soak" --assert-passed

Multiple real hosts: point ``--store`` at a shared mount (NFS / gcsfuse /
s3fs) and run ``worker`` once per machine — nothing else changes. ``launch``
is the one-command local convenience (init + N in-process workers + report);
``watch`` tails progress read-only from any host.

``worker`` and ``launch`` run their nodes on the card unless ``--device cpu``
is given; the device is each host's choice and never part of the spec.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.core.fleet import (
    ChaosSpec,
    FleetSpec,
    assemble_report,
    control_folder,
    read_spec,
    run_fleet_local,
    run_worker,
    watch,
    write_spec,
)


def _add_spec_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--strategy", default="fedavg")
    ap.add_argument("--transport", default=None,
                    help="pipeline spec string, e.g. 'delta(chain=4)|npz'")
    ap.add_argument("--runner", choices=("process", "thread"), default="process")
    ap.add_argument("--param-size", type=int, default=256)
    ap.add_argument("--round-sleep", type=float, default=0.05)
    ap.add_argument("--settle", type=float, default=1.0)
    ap.add_argument("--result-timeout", type=float, default=180.0)
    ap.add_argument("--name", default="soak")
    ap.add_argument("--seed", type=int, default=0, help="chaos schedule seed")
    ap.add_argument("--chaos-kills", type=int, default=0,
                    help="SIGKILL-then-restart victims (seeded, randomized)")
    ap.add_argument("--chaos-stalls", type=int, default=0,
                    help="slow-node stall victims (seeded, randomized)")
    ap.add_argument("--chaos-kill-workers", type=int, default=0,
                    help="whole-WORKER kill victims: the drawn worker dies "
                         "(SIGKILL, no cleanup) and survivors must adopt its "
                         "stranded slot leases")
    ap.add_argument("--lease-ttl", type=float, default=15.0,
                    help="slot-lease freshness window in seconds; a worker "
                         "silent this long forfeits its slots to adoption")
    ap.add_argument("--stall-duration", type=float, default=1.0)
    ap.add_argument("--restart-after", type=float, default=0.5)
    ap.add_argument("--kill-grace", type=float, default=30.0)


def _spec_from_args(args: argparse.Namespace) -> FleetSpec:
    return FleetSpec(
        store_uri=args.store,
        name=args.name,
        num_nodes=args.nodes,
        rounds=args.rounds,
        strategy=args.strategy,
        transport=args.transport,
        runner=args.runner,
        param_size=args.param_size,
        round_sleep=args.round_sleep,
        settle=args.settle,
        result_timeout=args.result_timeout,
        lease_ttl=args.lease_ttl,
        chaos=ChaosSpec(
            seed=args.seed,
            kills=args.chaos_kills,
            stalls=args.chaos_stalls,
            stall_duration=args.stall_duration,
            restart_after=args.restart_after,
            kill_grace=args.kill_grace,
            kill_workers=args.chaos_kill_workers,
        ),
    )


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.fleet", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="command", required=True)

    p_init = sub.add_parser("init", help="serialize a FleetSpec into the shared folder")
    p_init.add_argument("--store", required=True,
                        help="data-plane folder URI (cache+/shard<G>+ grammar)")
    _add_spec_args(p_init)

    p_worker = sub.add_parser("worker", help="claim slots and run this host's nodes")
    p_worker.add_argument("--store", required=True)
    p_worker.add_argument("--worker-id", default=None)
    p_worker.add_argument("--max-slots", type=int, default=None)
    p_worker.add_argument("--timeout", type=float, default=None)
    p_worker.add_argument("--spec-timeout", type=float, default=60.0,
                          help="how long to poll for the spec blob")
    p_worker.add_argument("--device", default="cuda",
                          help="where this host's nodes train and aggregate")

    p_watch = sub.add_parser("watch", help="tail fleet progress (read-only)")
    p_watch.add_argument("--store", required=True)
    p_watch.add_argument("--interval", type=float, default=2.0)
    p_watch.add_argument("--timeout", type=float, default=600.0)

    p_report = sub.add_parser("report", help="assemble + print the SoakReport")
    p_report.add_argument("--store", required=True)
    p_report.add_argument("--json", action="store_true", dest="as_json")
    p_report.add_argument("--assert-passed", action="store_true",
                          help="exit 1 unless the soak passed (CI gate)")

    p_launch = sub.add_parser(
        "launch", help="init + N local workers + report, in one command")
    p_launch.add_argument("--store", required=True)
    p_launch.add_argument("--workers", type=int, default=2)
    p_launch.add_argument("--timeout", type=float, default=None)
    p_launch.add_argument("--assert-passed", action="store_true")
    p_launch.add_argument("--device", default="cuda",
                          help="where the local workers' nodes train and aggregate")
    _add_spec_args(p_launch)

    args = ap.parse_args(argv)

    if args.command == "init":
        spec = _spec_from_args(args)
        write_spec(control_folder(spec.store_uri), spec)
        print(f"fleet spec written to {spec.store_uri!r}: "
              f"{spec.num_nodes} nodes x {spec.rounds} rounds, "
              f"chaos kills={spec.chaos.kills} stalls={spec.chaos.stalls} "
              f"seed={spec.chaos.seed}")
        return 0

    if args.command == "worker":
        # The CLI worker is its own OS process, so worker-kill chaos can be
        # the real thing: a drawn victim SIGKILLs itself (exit 137) and its
        # node children — survivors must adopt the lapsed leases.
        report = run_worker(args.store, worker_id=args.worker_id,
                            max_slots=args.max_slots, timeout=args.timeout,
                            spec_timeout=args.spec_timeout,
                            worker_kill_mode="sigkill", device=args.device)
        print(f"worker {report.worker_id}: slots={report.slots} "
              f"crashes_injected={report.crashes_injected} "
              f"restarts={report.restarts} "
              f"adoptions={sorted(report.adoptions)} "
              f"fleet_state_hash={report.fleet_state_hash} "
              f"all_results_seen={report.all_results_seen}")
        return 0 if report.all_results_seen else 1

    if args.command == "watch":
        report = watch(args.store, interval=args.interval, timeout=args.timeout)
        print(report.summary())
        return 0 if report.passed else 1

    if args.command == "report":
        control = control_folder(args.store)
        report = assemble_report(control, read_spec(control))
        if args.as_json:
            print(json.dumps(report.to_dict(), indent=2, sort_keys=True, default=str))
        else:
            print(report.summary())
        if args.assert_passed and not report.passed:
            print("soak FAILED acceptance (see summary above)", file=sys.stderr)
            return 1
        return 0

    if args.command == "launch":
        spec = _spec_from_args(args)
        report = run_fleet_local(spec, num_workers=args.workers,
                                 timeout=args.timeout, device=args.device)
        print(report.summary())
        if args.assert_passed and not report.passed:
            print("soak FAILED acceptance (see summary above)", file=sys.stderr)
            return 1
        return 0

    raise AssertionError(f"unhandled command {args.command!r}")


if __name__ == "__main__":
    raise SystemExit(main())
