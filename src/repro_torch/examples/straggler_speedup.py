"""Straggler & failure robustness demo — the paper's core operational claims
(the torch twin of ``examples/straggler_speedup.py``).

Part 1 (exact, virtual clock): wall-clock of sync vs async federation as one
node gets progressively slower, and under a mid-training node crash.

Part 2 (real threads): two MNIST-CNN clients, one slowed 3×; measures actual
wall time of sync (barrier) vs async (no waiting) federation. The clients
train and aggregate on the card unless ``--device cpu`` is given. Both modes
join both clients, so both wait for the slow one: the wall ratio sits near 1.

    PYTHONPATH=src python -m repro_torch.examples.straggler_speedup [--device cpu]

``main`` returns the exit code; ``virtual_clock`` and ``thread_demo`` return
the numbers they print.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import (
    AsyncFederatedNode,
    FederatedCallback,
    InMemoryFolder,
    SyncFederatedNode,
    run_threaded,
    simulate_timeline,
    straggler_speedup,
)
from repro_torch.core.partition import partition_dataset
from repro_torch.core.strategies import FedAvg
from repro_torch.data import batch_iterator, make_synthetic_mnist
from repro_torch.kernels import resolve_device
from repro_torch.models.cnn import MnistCNN
from repro_torch.optim import adam
from repro_torch.training import Trainer

RATIOS = (1.0, 1.5, 2.0, 4.0, 8.0)


def virtual_clock() -> dict:
    """Async-over-sync speedups per straggler ratio (12 epochs a node, seeded
    jitter), and the walls of both modes when node 2 crashes at epoch 3."""
    print("== virtual-clock model (exact) ==")
    rng = np.random.default_rng(0)
    speedups = {}
    for ratio in RATIOS:
        durations = [[1.0 + 0.2 * rng.random() for _ in range(12)],
                     [ratio * (1.0 + 0.2 * rng.random()) for _ in range(12)]]
        speedups[ratio] = straggler_speedup(durations)
        print(f"  straggler ×{ratio:>3}: async is {speedups[ratio]:.2f}× faster than sync")
    tl_sync = simulate_timeline([[1.0] * 6] * 3, mode="sync", failures={2: 3})
    tl_async = simulate_timeline([[1.0] * 6] * 3, mode="async", failures={2: 3})
    print(f"  node crash at epoch 3: sync wall={tl_sync.wall_clock} (hung), "
          f"async wall={tl_async.wall_clock} (survivors finish)")
    return {"speedups": speedups, "crash_sync_wall": tl_sync.wall_clock,
            "crash_async_wall": tl_async.wall_clock}


def run(mode: str, shards, *, device: torch.device, epochs: int = 3,
        steps: int = 15) -> dict:
    """Two MnistCNN clients federating ``mode`` ("sync" or "async") through
    one in-memory folder, client 1 sleeping 0.03 s a step; returns the wall
    seconds and the strategies' ``fed_agg`` launches."""
    folder = InMemoryFolder()
    nodes = []

    def client(i: int) -> Trainer:
        model = MnistCNN()
        trainer = Trainer(loss_fn=lambda p, b, r: model.loss(p, b), optimizer=adam(1e-3),
                          init_params=model.init(0, device=device), seed=i,
                          name=f"{mode}{i}", slowdown=0.0 if i == 0 else 0.03, device=device)
        if mode == "sync":
            node = SyncFederatedNode(strategy=FedAvg(device=device), shared_folder=folder,
                                     node_id=f"n{i}", num_nodes=2, timeout=300)
        else:
            node = AsyncFederatedNode(strategy=FedAvg(device=device), shared_folder=folder,
                                      node_id=f"n{i}")
        nodes.append(node)
        cb = FederatedCallback(node, num_examples_per_epoch=steps * 32)
        x, y = shards[i]
        trainer.fit(lambda e: batch_iterator(x, y, batch_size=32, seed=i, epoch=e),
                    epochs=epochs, steps_per_epoch=steps, callbacks=[cb])
        return trainer

    t0 = time.time()
    res = run_threaded([lambda i=i: client(i) for i in range(2)])
    for r in res:
        if r.error is not None:
            raise RuntimeError(f"{mode} client {r.node_id} failed:\n{r.traceback}")
    wall = time.time() - t0
    return {"wall_s": wall, "aggregations": [n.num_aggregations for n in nodes],
            "launches": {"fed_agg": sum(n.strategy.launches["fed_agg"] for n in nodes)}}


def thread_demo(*, device: "str | torch.device" = "cuda", epochs: int = 3, steps: int = 15,
                num_train: int = 1500, num_test: int = 300) -> dict:
    """Sync, then async, on the same shards; returns both walls and their
    ratio (recorded, not asserted: both modes wait for the slow client)."""
    dev = resolve_device(device)
    print("== real threads (MNIST CNN, node1 slowed 3×) ==")
    data = make_synthetic_mnist(num_train=num_train, num_test=num_test)
    shards = partition_dataset(data.x_train, data.y_train, 2, 0.5)
    sync = run("sync", shards, device=dev, epochs=epochs, steps=steps)
    asyn = run("async", shards, device=dev, epochs=epochs, steps=steps)
    ratio = sync["wall_s"] / asyn["wall_s"]
    print(f"  sync wall: {sync['wall_s']:.1f}s   async wall: {asyn['wall_s']:.1f}s   "
          f"→ async {ratio:.2f}× faster")
    return {"sync": sync, "async": asyn, "ratio": ratio,
            "launches": {"fed_agg": sync["launches"]["fed_agg"] + asyn["launches"]["fed_agg"]}}


def main(argv: list[str] | None = None, *, record: dict | None = None) -> int:
    """Runs both parts; ``record``, when given, receives their numbers."""
    ap = argparse.ArgumentParser(prog="repro_torch.examples.straggler_speedup",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {"virtual_clock": virtual_clock(), "threads": thread_demo(device=dev)}
    out["launches"] = out["threads"]["launches"]
    if record is not None:
        record.update(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
