"""Sharded gossip federation — O(group) scans instead of O(fleet) (the torch
twin of ``examples/sharded_federation.py``).

The fleet is partitioned into node-groups via a ``shard<G>+<uri>`` store URI;
each group owns its own folder, and cross-group information travels as gossip
summaries (one aggregate blob per group, forwarded along a ring). A node's
per-step ``state_hash``/``pull`` touch only its home group's folder, so scan
cost is flat in fleet size at fixed group size. Every client holds its model
on the card and aggregates its home peers and the ``group:`` pseudo-peers
there (``fed_agg``), unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.examples.sharded_federation [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.sharded_federation --nodes 24 --groups 6
    PYTHONPATH=src python -m repro_torch.examples.sharded_federation --processes

The default run federates threaded clients over a sharded temp-dir store and
then prints a flat-vs-sharded scan-cost comparison on simulated fleets (host
work). ``main`` returns the exit code; ``threaded_demo``, ``scan_cost_demo``
and ``process_demo`` return the numbers they print.
"""
from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.core import (
    AsyncFederatedNode,
    InMemoryFolder,
    NodeUpdate,
    ShardedFolders,
    ShardedWeightStore,
    WeightStore,
    balanced_groups,
    make_folder,
    run_multiprocess,
    run_threaded,
)
from repro_torch.core.gossip import GROUP_PEER_PREFIX
from repro_torch.core.strategies import FedAvg
from repro_torch.kernels import resolve_device

SCAN_FLEETS, SCAN_GROUP_SIZE = (200, 2000), 50


def threaded_demo(num_nodes: int, num_groups: int, epochs: int, *,
                  device: "str | torch.device" = "cuda") -> dict:
    """Threaded clients on a ``shard<G>+`` temp dir; returns each node's
    group, final value and the ``group:`` pseudo-peers it pulled, and the
    strategies' ``fed_agg`` launches."""
    dev = resolve_device(device)
    shared_dir = tempfile.mkdtemp(prefix="flwr_serverless_shard_")
    uri = f"shard{num_groups}+{shared_dir}"
    print(f"weight store: {uri}")
    node_ids = [f"client{i}" for i in range(num_nodes)]
    mapping = balanced_groups(node_ids, num_groups)  # explicit: no empty group
    targets = {nid: float(i) for i, nid in enumerate(node_ids)}
    finals, launches = {}, {}

    def client(nid):
        store = ShardedWeightStore(make_folder(uri), group_of=mapping)
        node = AsyncFederatedNode(strategy=FedAvg(device=dev), store=store, node_id=nid)
        w = torch.zeros((8,), dtype=torch.float32, device=dev)
        pseudo_peers = set()
        for _ in range(epochs):
            w = w + 0.3 * (targets[nid] - w)  # local step
            aggregated = node.update_parameters({"w": w}, num_examples=10)
            if aggregated is not None:
                w = aggregated["w"]
            pseudo_peers.update(
                u.node_id for u in store.pull(exclude=nid)
                if u.node_id.startswith(GROUP_PEER_PREFIX)
            )
            time.sleep(0.02)
        finals[nid] = (float(w.mean()), sorted(pseudo_peers))
        launches[nid] = node.strategy.launches["fed_agg"]
        return node.num_aggregations

    results = run_threaded([lambda n=n: client(n) for n in node_ids])
    errors = [r for r in results if r.error is not None]
    assert not errors, [r.traceback for r in errors]
    values = [v for v, _ in finals.values()]
    print(f"{num_nodes} clients in {num_groups} groups, {epochs} epochs:")
    for nid in node_ids[:4]:
        v, peers = finals[nid]
        print(f"  {nid} (group {mapping[nid]}): final={v:.2f} gossip peers={peers}")
    print(f"  ... consensus spread {max(values) - min(values):.2f} "
          f"(targets spanned {max(targets.values()) - min(targets.values()):.1f})")
    return {"store": uri, "nodes": {nid: {"group": mapping[nid], "final": finals[nid][0],
                                          "gossip_peers": finals[nid][1],
                                          "aggregations": r.result}
                                    for nid, r in zip(node_ids, results)},
            "targets": targets, "spread": max(values) - min(values),
            "launches": {"fed_agg": sum(launches.values())}}


def scan_cost_demo(fleets=SCAN_FLEETS, group_size: int = SCAN_GROUP_SIZE) -> dict:
    """Per-step scan cost (state_hash + pull): flat store vs sharded store,
    at each fleet size (host work on the memory backend); returns the ms."""
    params = {"w": np.zeros((16,), np.float32)}
    print("\nper-step scan cost, group size fixed at "
          f"{group_size} (simulated deposits, memory backend):")
    rows = []
    for fleet in fleets:
        num_groups = max(1, fleet // group_size)
        flat = WeightStore(InMemoryFolder(), decode_cache_entries=fleet)
        sharded = ShardedWeightStore(
            ShardedFolders(num_groups, factory=lambda g: InMemoryFolder()),
            group_of=lambda nid, g=num_groups: int(nid[1:]) % g,
        )
        for store in (flat, sharded):
            for i in range(fleet):
                store.push(NodeUpdate(params, num_examples=1, node_id=f"n{i}"))

        def step_cost(store):
            store.state_hash(exclude_node="n0"); store.pull(exclude="n0")  # warm
            t0 = time.time()
            for _ in range(3):
                store.state_hash(exclude_node="n0")
                store.pull(exclude="n0")
            return (time.time() - t0) / 3

        flat_ms, sharded_ms = step_cost(flat) * 1e3, step_cost(sharded) * 1e3
        print(f"  fleet {fleet:5d}: flat {flat_ms:7.2f} ms   "
              f"sharded({num_groups} groups) {sharded_ms:7.2f} ms")
        rows.append({"fleet": fleet, "groups": num_groups, "flat_ms": flat_ms,
                     "sharded_ms": sharded_ms})
    return {"group_size": group_size, "fleets": rows}


def _proc_client(shared_dir, nid, mapping, num_groups, target, epochs, device="cuda"):
    """Module-level so the spawn start method can pickle it by name."""
    dev = resolve_device(device)
    store = ShardedWeightStore(f"shard{num_groups}+{shared_dir}", group_of=mapping)
    node = AsyncFederatedNode(strategy=FedAvg(device=dev), store=store, node_id=nid)
    w = torch.zeros((8,), dtype=torch.float32, device=dev)
    peers = set()
    for _ in range(epochs):
        w = w + 0.3 * (target - w)
        aggregated = node.update_parameters({"w": w}, num_examples=10)
        if aggregated is not None:
            w = aggregated["w"]
        peers.update(u.node_id for u in store.pull(exclude=nid))
        time.sleep(0.05)
    return {"final": float(w.mean()), "peers": sorted(peers),
            "aggregations": node.num_aggregations, "launches": dict(node.strategy.launches)}


def process_demo(num_nodes: int, num_groups: int, epochs: int, *,
                 device: "str | torch.device" = "cuda", join_timeout: float = 300.0) -> dict:
    """The same federation across real OS processes; returns each node's
    group and record (or error) and the children's ``fed_agg`` launches."""
    device = str(resolve_device(device))
    shared_dir = tempfile.mkdtemp(prefix="flwr_serverless_shard_mp_")
    node_ids = [f"n{i}" for i in range(num_nodes)]
    mapping = balanced_groups(node_ids, num_groups)
    clients = [
        (_proc_client, (shared_dir, nid, mapping, num_groups, float(i), epochs),
         {"device": device})
        for i, nid in enumerate(node_ids)
    ]
    results = run_multiprocess(clients, names=node_ids, join_timeout=join_timeout)
    nodes = {}
    for r in results:
        if r.error is None:
            print(f"  {r.node_id}: final={r.result['final']:.2f} "
                  f"peers={r.result['peers']}")
            nodes[r.node_id] = {"group": mapping[r.node_id], **r.result}
        else:
            print(f"  {r.node_id}: {r.error}")
            nodes[r.node_id] = {"group": mapping[r.node_id], "error": str(r.error)}
    launches = sum(n["launches"]["fed_agg"] for n in nodes.values() if "launches" in n)
    return {"store": f"shard{num_groups}+{shared_dir}", "nodes": nodes,
            "targets": {nid: float(i) for i, nid in enumerate(node_ids)},
            "launches": {"fed_agg": launches}}


def main(argv: list[str] | None = None, *, fleets=SCAN_FLEETS, join_timeout: float = 300.0,
         record: dict | None = None) -> int:
    """``fleets`` are the scan-cost demo's fleet sizes, ``join_timeout``
    bounds the ``--processes`` run; ``record``, when given, receives the
    demos' numbers."""
    ap = argparse.ArgumentParser(prog="repro_torch.examples.sharded_federation",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--nodes", type=int, default=12)
    ap.add_argument("--groups", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--processes", action="store_true",
                    help="run clients as real OS processes instead of threads")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.processes:
        out = {"processes": process_demo(args.nodes, args.groups, args.epochs, device=dev,
                                           join_timeout=join_timeout)}
    else:
        out = {"threads": threaded_demo(args.nodes, args.groups, args.epochs, device=dev),
               "scan_cost": scan_cost_demo(fleets)}
    out["launches"] = out["processes" if args.processes else "threads"]["launches"]
    if record is not None:
        record.update(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
