"""Fleet chaos soak — the multi-host launcher, from laptop to shared mount
(the torch twin of ``examples/fleet_soak.py``).

The same ``FleetSpec`` drives all three deployments; nothing but the store
path changes, because the fleet coordinates *through the folder alone*
(spec, slot claims, heartbeats, results are all ``fleet/`` blobs — no
coordinator in the data path). Every node holds its model on the card and
aggregates there (``fed_agg``) unless ``--device cpu`` is given:

1. **Single host, one command** (this script, or ``repro_torch.fleet
   launch``): two in-process workers partition the fleet, chaos kills +
   restarts included::

       PYTHONPATH=src python -m repro_torch.examples.fleet_soak [--device cpu]
       PYTHONPATH=src python -m repro_torch.examples.fleet_soak --nodes 16 --kills 3 --runner process

2. **Two terminals = two "hosts"**::

       # terminal 1
       PYTHONPATH=src python -m repro_torch.fleet init --store /tmp/soak \\
           --nodes 8 --rounds 8 --chaos-kills 2 --seed 7
       PYTHONPATH=src python -m repro_torch.fleet worker --store /tmp/soak \\
           --worker-id hostA --max-slots 4
       # terminal 2
       PYTHONPATH=src python -m repro_torch.fleet worker --store /tmp/soak \\
           --worker-id hostB --max-slots 4
       # either terminal (or a third, read-only)
       PYTHONPATH=src python -m repro_torch.fleet report --store /tmp/soak --assert-passed

3. **Real machines**: point ``--store`` at a shared mount — NFS, gcsfuse,
   s3fs — and run ``worker`` once per machine. Slot claims use link(2)-based
   atomic creates (atomic on NFS), workers never talk to each other, and any
   host can run ``watch``/``report``. Sharded stores compose:
   ``--store "shard16+/mnt/shared/soak"`` keeps per-push scans O(group) at
   10³+ nodes while the control blobs land in the base directory.

The soak passes only if every node finished its rounds, every SIGKILLed
node's restarted incarnation reports ``resumed=True`` (counter + params +
strategy state recovered from its own deposits), and every worker
independently computed the same fleet-wide ``state_hash``. ``main`` returns
0 on a pass and 1 otherwise; ``soak`` returns the report's numbers.
"""
from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch.core import ChaosSpec, FleetSpec, collect_obs, kernel_launches, run_fleet_local
from repro_torch.kernels import resolve_device


def soak(*, store: str | None = None, nodes: int = 8, rounds: int = 8, workers: int = 2,
         kills: int = 2, stalls: int = 1, seed: int = 7, runner: str = "thread",
         transport: str | None = None, device: "str | torch.device" = "cuda",
         timeout: float | None = None) -> dict:
    """Run the seeded chaos soak and print its report; returns the report
    (``SoakReport.to_dict()``), its summary and the nodes' launches.
    ``timeout`` bounds each worker (default: ``default_worker_timeout``)."""
    dev = resolve_device(device)
    store = store or tempfile.mkdtemp(prefix="fleet_soak_")
    spec = FleetSpec(
        store_uri=store,
        num_nodes=nodes,
        rounds=rounds,
        runner=runner,
        transport=transport,
        round_sleep=0.02 if runner == "thread" else 0.05,
        chaos=ChaosSpec(seed=seed, kills=kills, stalls=stalls,
                        restart_after=0.3, stall_duration=0.3),
    )
    print(f"soaking {spec.num_nodes} nodes x {spec.rounds} rounds over {store!r} "
          f"({workers} workers, runner={spec.runner}, "
          f"kills={kills}, stalls={stalls}, seed={seed})")
    report = run_fleet_local(spec, num_workers=workers, timeout=timeout, device=dev)
    print()
    print(report.summary())
    if report.recovery_latency:
        for node, latency in sorted(report.recovery_latency.items()):
            print(f"  {node}: SIGKILL -> resumed push in {latency:.2f}s")
    launched = kernel_launches(collect_obs(store))  # by the nodes, wherever they ran
    return {"store": store, "report": report.to_dict(), "summary": report.summary(),
            "passed": report.passed, "launches": {"fed_agg": launched.get("fed_agg", 0)}}


def main(argv: list[str] | None = None, *, timeout: float | None = None,
         record: dict | None = None) -> int:
    """0 if the soak passed, else 1. ``timeout`` bounds each worker;
    ``record``, when given, receives ``soak``'s numbers."""
    ap = argparse.ArgumentParser(prog="repro_torch.examples.fleet_soak", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--store", default=None,
                    help="shared folder URI (default: fresh temp dir); "
                         "cache+/shard<G>+ wrappers compose")
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--kills", type=int, default=2,
                    help="seeded SIGKILL-then-restart victims")
    ap.add_argument("--stalls", type=int, default=1,
                    help="seeded slow-node stall victims")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--runner", choices=("thread", "process"), default="thread",
                    help="'process' = one OS process per node (real SIGKILLs); "
                         "'thread' = in-process soak (fast, 10^2-node scale)")
    ap.add_argument("--transport", default=None,
                    help="pipeline spec, e.g. 'delta(chain=4)|npz'")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = soak(store=args.store, nodes=args.nodes, rounds=args.rounds, workers=args.workers,
               kills=args.kills, stalls=args.stalls, seed=args.seed, runner=args.runner,
               transport=args.transport, device=args.device, timeout=timeout)
    if record is not None:
        record.update(out)
    return 0 if out["passed"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
