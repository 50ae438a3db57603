"""Hierarchical gossip — a 2-level summary tree over a ``shard<G>x<L>`` store
(the torch twin of ``examples/hierarchical_gossip.py``).

A single-tier ring (``shard<G>+``) keeps per-step scans O(group), but every
folder still collects one summary per foreign group: O(G) keys, and a pull's
bounded rotating sample needs O(G) pulls to cover the fleet. ``shard<G>x2+``
folds level-0 group summaries into super-summaries along deterministically
elected aggregator groups (stable hash of ``(level, origin)`` — no
coordinator, every node derives the same election), forwarded on a ring that
is ``⌈√G⌉``× shorter and down-copied back into every member folder. Per-push
work and the staleness window then scale with the branching factor, not G.

    PYTHONPATH=src python -m repro_torch.examples.hierarchical_gossip [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.hierarchical_gossip --nodes 36 --groups 9 --levels 2

The demo federates threaded clients over a 2-level in-process store (each
client's model on the card, aggregated there with ``fed_agg``), prints the
derived tree (segments, elected aggregators, per-level rings), the per-level
gossip telemetry spans, and the exact-coverage accounting of one pull (home
peers + level-0 summaries + supers = fleet, nothing twice). ``main`` returns
the exit code; ``print_tree`` and ``federate`` return the numbers they print.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import (
    AsyncFederatedNode,
    GossipHierarchy,
    InMemoryFolder,
    ShardedFolders,
    ShardedWeightStore,
    Telemetry,
    balanced_groups,
    run_threaded,
)
from repro_torch.core.gossip import GROUP_PEER_PREFIX
from repro_torch.core.strategies import FedAvg
from repro_torch.kernels import resolve_device


def print_tree(hier: GossipHierarchy) -> dict:
    """Print the tree; returns each level's elected holders and group 0's
    pull scope."""
    print(f"summary tree: {hier.num_groups} groups, {hier.levels} levels, "
          f"branching {hier.branching}, diameter {hier.diameter()} rounds")
    holders = {}
    for level in range(1, hier.levels):
        holders[level] = {o: hier.holder(level, o) for o in range(hier.counts[level])}
        print(f"  level {level}: {hier.counts[level]} origins, elected "
              f"aggregator groups {holders[level]}")
    scope = {lvl: sorted(origins) for lvl, origins in hier.scope(0).items()}
    print(f"  group 0 pull scope (level -> foreign origins): {scope}")
    return {"branching": hier.branching, "diameter": hier.diameter(), "holders": holders,
            "scope": scope}


def federate(*, nodes: int = 18, groups: int = 9, levels: int = 2, epochs: int = 8,
             device: "str | torch.device" = "cuda") -> dict:
    """The threaded fleet, the settle rounds, the spans and the coverage
    check (raises if one pull counts any deposit twice or misses one)."""
    dev = resolve_device(device)
    folders = ShardedFolders(groups, levels=levels, factory=lambda g: InMemoryFolder())
    node_ids = [f"client{i}" for i in range(nodes)]
    mapping = balanced_groups(node_ids, groups)
    targets = {nid: float(i) for i, nid in enumerate(node_ids)}
    print(f"weight store: shard{groups}x{levels}+memory://")
    tree = print_tree(GossipHierarchy(groups, levels))

    # one store shared by the threaded clients (exactly what a fleet of
    # processes would reconstruct per-node from the URI), with telemetry on
    # so the per-level gossip phases show up as named spans
    tel = Telemetry("hierarchical_gossip", enabled=True)
    store = ShardedWeightStore(folders, group_of=mapping)
    store.attach_telemetry(tel)
    finals, fleet = {}, {}

    def client(nid):
        node = AsyncFederatedNode(strategy=FedAvg(device=dev), store=store, node_id=nid)
        fleet[nid] = node
        w = torch.zeros((8,), dtype=torch.float32, device=dev)
        for _ in range(epochs):
            w = w + 0.3 * (targets[nid] - w)  # local step
            aggregated = node.update_parameters({"w": w}, num_examples=10)
            if aggregated is not None:
                w = aggregated["w"]
            time.sleep(0.01)
        finals[nid] = (float(w.mean()), w)

    results = run_threaded([lambda n=n: client(n) for n in node_ids])
    errors = [r for r in results if r.error is not None]
    assert not errors, [r.traceback for r in errors]

    # settle: ring-order re-pushes (one member per group, same weights, same
    # example counts) carry the last epoch's summaries up the tree, around
    # the shorter rings, and back down — ``diameter()`` rounds bound it
    hier = store.hierarchy
    rep = {}
    for nid in node_ids:
        rep.setdefault(mapping[nid], nid)
    for _ in range(hier.diameter()):
        for g in sorted(rep):
            nid = rep[g]
            fleet[nid].update_parameters({"w": finals[nid][1]}, num_examples=10)

    values = [v for v, _ in finals.values()]
    spread = max(values) - min(values)
    print(f"\n{nodes} clients, {epochs} epochs: consensus spread "
          f"{spread:.2f} (targets spanned "
          f"{max(targets.values()) - min(targets.values()):.1f})")
    print(f"summary refreshes={store.num_summary_refreshes} "
          f"forwards={store.num_summary_forwards} "
          f"super_folds={store.num_super_folds}")

    spans = {name: st for name, st in tel.recorder.phase_stats().items()
             if name.startswith("gossip")}
    print("\nper-level gossip spans (count, total ms):")
    for name in sorted(spans):
        st = spans[name]
        print(f"  {name:20s} n={st['count']:5d} "
              f"total={st['total_s'] * 1e3:8.1f}ms")

    # exact coverage: one pull weighs the foreign fleet exactly once —
    # home peers as real updates, segment siblings as level-0 summaries,
    # the rest as supers
    probe = node_ids[0]
    pulled = store.pull(exclude=probe)
    home = [u for u in pulled if not u.node_id.startswith(GROUP_PEER_PREFIX)]
    l0 = [u for u in pulled if u.node_id.startswith(GROUP_PEER_PREFIX)
          and not u.node_id.startswith(f"{GROUP_PEER_PREFIX}L")]
    supers = [u for u in pulled if u.node_id.startswith(f"{GROUP_PEER_PREFIX}L")]
    total = sum(u.num_examples for u in pulled)
    expect = 10 * (nodes - 1)  # every client deposited 10 examples
    print(f"\npull coverage for {probe}: {len(home)} home peers + "
          f"{len(l0)} level-0 summaries + {len(supers)} supers "
          f"= {total} examples (10 x (fleet - self) = {expect})")
    assert total == expect, "coverage must be exact — no double counting"
    return {"tree": tree, "spread": spread, "finals": {n: v for n, (v, _) in finals.items()},
            "summary_refreshes": store.num_summary_refreshes,
            "summary_forwards": store.num_summary_forwards,
            "super_folds": store.num_super_folds,
            "spans": {n: {"count": st["count"], "total_s": st["total_s"]}
                      for n, st in spans.items()},
            "coverage": {"probe": probe, "home": len(home), "level0": len(l0),
                         "supers": len(supers), "examples": total, "expected": expect},
            "launches": {"fed_agg": sum(n.strategy.launches["fed_agg"]
                                        for n in fleet.values())}}


def main(argv: list[str] | None = None, *, record: dict | None = None) -> int:
    """``record``, when given, receives ``federate``'s numbers."""
    ap = argparse.ArgumentParser(prog="repro_torch.examples.hierarchical_gossip",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--nodes", type=int, default=18)
    ap.add_argument("--groups", type=int, default=9)
    ap.add_argument("--levels", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = federate(nodes=args.nodes, groups=args.groups, levels=args.levels,
                   epochs=args.epochs, device=args.device)
    if record is not None:
        record.update(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
