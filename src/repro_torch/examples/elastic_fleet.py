"""Elastic fleet membership — workers leave (crash) and join mid-soak (the
torch twin of ``examples/elastic_fleet.py``).

Fleet workers don't own their slots forever: each claim is a **lease**
(``fleet/lease/<node>/<epoch>`` blob carrying the worker id and a
heartbeat-refreshed deadline). A worker that goes silent past
``FleetSpec.lease_ttl`` forfeits its slots — any live worker adopts the
lapsed lease with one atomic ``put_if_absent`` at the next epoch and resumes
the node from its own ``latest/`` deposits. Membership is therefore
*elastic*: workers can be SIGKILLed whole, and fresh workers can join a
soak that is already running. Every worker's nodes hold their models on the
card and aggregate there (``fed_agg``) unless ``--device cpu`` is given.

This script demos both directions in one process:

1. two founding workers claim the fleet; ``ChaosSpec(kill_workers=1)``
   deterministically draws one of them and kills it whole mid-soak
   (its nodes stop pushing, its leases go stale);
2. a **late-joining rescuer** worker starts *after* the soak is underway
   with ``max_slots=0`` — it claims nothing, finds the stranded leases,
   adopts them at epoch 1, and finishes the dead worker's nodes.

Run it::

    PYTHONPATH=src python -m repro_torch.examples.elastic_fleet [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.elastic_fleet --nodes 12 --rounds 8

Across real terminals/machines the same flow is the CLI (the rescuer can
start any time, even after the victim is long dead)::

    PYTHONPATH=src python -m repro_torch.fleet init --store /mnt/shared/soak \\
        --nodes 9 --rounds 6 --chaos-kill-workers 1 --lease-ttl 2
    PYTHONPATH=src python -m repro_torch.fleet worker --store /mnt/shared/soak \\
        --worker-id hostA --max-slots 5 &        # one of these self-SIGKILLs
    PYTHONPATH=src python -m repro_torch.fleet worker --store /mnt/shared/soak \\
        --worker-id hostB --max-slots 4 &
    PYTHONPATH=src python -m repro_torch.fleet worker --store /mnt/shared/soak \\
        --worker-id rescuer --max-slots 0        # joins late, adopts strays

The soak passes only if every node finished, the survivors agree on one
fleet-wide ``state_hash``, at least one founding worker was lost, and every
stranded node reports ``adopted=True`` — the acceptance ``repro_torch.fleet
report --assert-passed`` checks. A run in which the surviving founder wins
every adoption passes too: adoption is a CAS, any live worker may win.
``main`` returns 0 on a pass and 1 otherwise; ``elastic`` returns the
report's numbers and the adoption latencies.
"""
from __future__ import annotations

import argparse
import tempfile
import threading
import time

import torch

from repro_torch.core import (
    ChaosSpec,
    FleetSpec,
    assemble_report,
    collect_obs,
    kernel_launches,
    run_worker,
)
from repro_torch.core.fleet import control_folder, read_spec, write_spec
from repro_torch.kernels import resolve_device


def elastic(*, store: str | None = None, nodes: int = 8, rounds: int = 6, seed: int = 5,
            lease_ttl: float = 1.0, device: "str | torch.device" = "cuda",
            timeout: float | None = None) -> dict:
    """Two founders, one killed whole, and a late rescuer; prints and returns
    the report (``SoakReport.to_dict()``), the rescuer's adoptions, each
    stranded node's adoption latency and the nodes' launches. ``timeout``
    bounds each worker (default: ``default_worker_timeout``)."""
    dev = str(resolve_device(device))
    store = store or tempfile.mkdtemp(prefix="elastic_fleet_")
    spec = FleetSpec(
        store_uri=store,
        num_nodes=nodes,
        rounds=rounds,
        runner="thread",
        round_sleep=0.05,
        settle=1.0,
        lease_ttl=lease_ttl,
        chaos=ChaosSpec(seed=seed, kill_workers=1,
                        kill_workers_after=(1, 3)),
    )
    write_spec(control_folder(store), spec)
    print(f"soaking {spec.num_nodes} nodes x {spec.rounds} rounds over "
          f"{store!r}: 2 founding workers, kill_workers=1, "
          f"lease_ttl={spec.lease_ttl}s")

    # Two founding workers split the fleet. The seeded worker-kill chaos
    # draws one of them; mid-soak it stops dead (threads aborted, leases
    # left to go stale) — exactly what a SIGKILLed host looks like from the
    # store's point of view.
    founders = [
        threading.Thread(
            target=run_worker, args=(store,),
            kwargs=dict(worker_id=f"founder{i}",
                        max_slots=(spec.num_nodes + 1) // 2, timeout=timeout,
                        device=dev),
            daemon=True)
        for i in range(2)
    ]
    for t in founders:
        t.start()

    # The rescuer joins while the soak is running. max_slots=0 means it
    # claims no founding slots at all — its only job is the adoption sweep:
    # wait for leases to lapse, CAS each one at epoch+1, resume the node
    # from latest/, and deposit the missing results.
    time.sleep(1.0)
    print("rescuer joining the running soak (max_slots=0, adoption only)...")
    rescue = run_worker(store, worker_id="rescuer", max_slots=0, timeout=timeout,
                        device=dev)
    for t in founders:
        t.join(timeout=30.0)

    control = control_folder(store)
    report = assemble_report(control, read_spec(control))
    print()
    print(report.summary())
    if rescue.adoptions:
        print(f"  rescuer adopted: {sorted(rescue.adoptions)}")
    else:
        print("  (the surviving founder won the adoption race this run — "
              "adoption is a CAS, any live worker may win)")
    for node, latency in sorted(report.adoption_latency.items()):
        print(f"  {node}: lease lapsed -> adopted push in {latency:.2f}s")
    launched = kernel_launches(collect_obs(store))  # by the nodes, wherever they ran
    return {"store": store, "report": report.to_dict(), "summary": report.summary(),
            "passed": report.passed, "rescuer_adopted": sorted(rescue.adoptions),
            "adoption_latency_s": dict(report.adoption_latency),
            "launches": {"fed_agg": launched.get("fed_agg", 0)}}


def main(argv: list[str] | None = None, *, timeout: float | None = None,
         record: dict | None = None) -> int:
    """0 if the soak passed (or, with ``--join``, once the rescuer is done),
    else 1. ``timeout`` bounds each worker; ``record``, when given, receives
    the numbers."""
    ap = argparse.ArgumentParser(prog="repro_torch.examples.elastic_fleet", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--store", default=None,
                    help="shared folder URI (default: fresh temp dir)")
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--lease-ttl", type=float, default=1.0,
                    help="lease freshness window; a worker silent this long "
                         "forfeits its slots to adoption")
    ap.add_argument("--join", action="store_true",
                    help="skip init: act only as a late-joining rescuer "
                         "against a soak already running at --store")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.join:
        if not args.store:
            ap.error("--join needs --store pointing at the running soak")
        report = run_worker(args.store, worker_id="rescuer", max_slots=0, timeout=timeout,
                            device=args.device)
        print(f"rescuer adopted: {sorted(report.adoptions)}")
        if record is not None:
            record.update({"rescuer_adopted": sorted(report.adoptions)})
        return 0

    out = elastic(store=args.store, nodes=args.nodes, rounds=args.rounds, seed=args.seed,
                  lease_ttl=args.lease_ttl, device=args.device, timeout=timeout)
    if record is not None:
        record.update(out)
    return 0 if out["passed"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
