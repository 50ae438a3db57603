"""An observed fleet — the serverless telemetry plane, end to end (the torch
twin of ``examples/observed_fleet.py``).

Serverless federation has no coordinator to scrape, so the telemetry rides
the same store as the weights: each node keeps a lightweight flight recorder
(``Telemetry`` — monotonic-clock spans over pull/decode/aggregate/encode/
push/train, staleness distributions, transport byte counters) and
periodically deposits a snapshot as an ``obs/<node>/<seq>`` blob. The blobs
are excluded from every federation ``state_hash`` (like the ``fleet/``
control plane), survive delta-transport GC, and any host that can see the
mount becomes a dashboard. The blobs are the same wire as the JAX package's,
so either package's reader renders either package's fleet::

    PYTHONPATH=src python -m repro_torch.examples.observed_fleet [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.observed_fleet --store /tmp/obs_demo

    # meanwhile, from ANY terminal/host that sees the store (or after):
    PYTHONPATH=src python -m repro_torch.obs watch --store /tmp/obs_demo --once
    PYTHONPATH=src python -m repro_torch.obs trace --store /tmp/obs_demo --out trace.json
    # open trace.json at https://ui.perfetto.dev — every node's round
    # phases on one timeline, wall-clock aligned across nodes.

Each node holds its ``--size`` f32 vector on the card, perturbs it there
each round, and aggregates its peers' ``delta`` deposits there (``fed_agg``);
``--device cpu`` runs it all on the CPU.

Three ways to switch telemetry on (default is OFF, and the disabled path is
a shared no-op context manager — nanoseconds per call):

1. per node: ``AsyncFederatedNode(..., telemetry=True)`` or pass a
   configured ``Telemetry(flush_every=5, obs_keep=16)`` instance;
2. fleet-wide: ``repro_torch.fleet`` soak clients always deposit telemetry,
   and ``SoakReport.summary()`` folds the rollups in;
3. environment: ``REPRO_OBS=1`` flips the default for every node in the
   process (handy for scripts you can't edit).

Debug logging is a separate knob: ``REPRO_LOG=debug`` (or
``REPRO_LOG=debug:fleet`` for one subtree) attaches a stderr handler to the
``repro_torch.*`` logger hierarchy, which is silent by default.

``main`` returns the exit code; ``observe`` returns the fleet rollup.
"""
from __future__ import annotations

import argparse
import functools
import tempfile

import numpy as np
import torch

from repro_torch.core import AsyncFederatedNode, Telemetry, make_folder, run_threaded
from repro_torch.core.telemetry import collect_obs, telemetry_rollups
from repro_torch.kernels import resolve_device
from repro_torch.obs import render_dashboard


def client(node_id: str, store_uri: str, rounds: int, size: int, seed: int,
           device: "str | torch.device" = "cuda") -> dict:
    """One node: a ``size``-entry f32 vector on ``device`` (drawn with numpy
    from ``seed``), nudged by N(0, 0.01) noise drawn on the device each
    round, federated through the ``delta`` transport. Returns its counter and
    its strategy's launches."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    node = AsyncFederatedNode(
        shared_folder=make_folder(store_uri),
        node_id=node_id,
        transport="delta",
        # flush_every=1: deposit an obs/ snapshot after every round so even
        # short demo runs produce a trace; real soaks use a larger cadence.
        telemetry=Telemetry(enabled=True, flush_every=1),
        device=dev,
    )
    w = torch.from_numpy(rng.standard_normal(size).astype(np.float32)).to(dev)
    for _ in range(rounds):
        w = w + 0.01 * torch.randn(size, generator=gen, device=dev)
        merged = node.update_parameters({"w": w}, num_examples=1)
        if merged is not None:
            w = merged["w"]
    return {"counter": node.counter, "launches": dict(node.strategy.launches)}


def observe(store: str, *, nodes: int = 4, rounds: int = 6, size: int = 50_000,
            device: "str | torch.device" = "cuda") -> dict:
    """Federate the fleet on ``store``, then render the dashboard from its
    ``obs/`` blobs; returns the fleet rollup and the nodes' launches."""
    dev = resolve_device(device)
    print(f"federating {nodes} nodes x {rounds} rounds over {store!r}\n")
    results = run_threaded([
        functools.partial(client, f"n{i}", store, rounds, size, i, dev)
        for i in range(nodes)
    ], names=[f"n{i}" for i in range(nodes)])
    for r in results:
        if r.error is not None:
            raise RuntimeError(f"{r.node_id} failed:\n{r.traceback}")

    # The dashboard is just a store reader — same thing `repro_torch.obs
    # watch` renders, assembled from the obs/ blobs alone:
    obs = collect_obs(store)
    render_dashboard(obs)

    rollups = telemetry_rollups(obs)
    fleet = rollups["fleet"]
    print(f"\nfleet rollup: {fleet['nodes_reporting']} nodes, "
          f"{fleet['rounds_total']} rounds, "
          f"staleness mean {fleet['staleness_mean']:.2f}, "
          f"{fleet['bytes_written'] / 1e6:.2f}MB written")
    print(f"\nnext: PYTHONPATH=src python -m repro_torch.obs trace --store {store} "
          "--out trace.json   # then open it at https://ui.perfetto.dev")
    return {"store": store, "size": size, "fleet": fleet,
            "counters": {r.node_id: r.result["counter"] for r in results},
            "launches": {"fed_agg": sum(r.result["launches"]["fed_agg"] for r in results)}}


def main(argv: list[str] | None = None, *, record: dict | None = None) -> int:
    """``record``, when given, receives ``observe``'s numbers."""
    ap = argparse.ArgumentParser(prog="repro_torch.examples.observed_fleet",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--store", default=None,
                    help="shared folder URI (default: fresh temp dir); "
                         "cache+/shard<G>+ wrappers compose")
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--size", type=int, default=50_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    store = args.store or tempfile.mkdtemp(prefix="observed_fleet_")
    out = observe(store, nodes=args.nodes, rounds=args.rounds, size=args.size, device=dev)
    if record is not None:
        record.update(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
