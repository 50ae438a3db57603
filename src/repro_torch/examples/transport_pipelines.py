"""Walkthrough of the composable transport pipeline (the wire layer) — the
torch twin of ``examples/transport_pipelines.py``.

Every deposit a federated node makes flows through a ``TransportPipeline``
built from one spec string — ``"delta(chain=4)|npz"``, ``"topk(adaptive)"``,
``"quantized|zstd"`` — and every wire counter (bytes written/read, chain
depths, residual norms, prefetch activity) lands on that pipeline's stats.

This script pushes the same sparse-local-step schedule through several
pipelines and prints what each one moved, then demonstrates the two runtime
features: background prefetch and strategy-state recovery. The wire demos are
host work on numpy arrays; the recovery demo's FedAvgM nodes hold their
weights and momentum on the card (``--device cpu`` to run it on the CPU).

    PYTHONPATH=src python -m repro_torch.examples.transport_pipelines [--device cpu]

``main`` returns the exit code; ``compare_pipelines``, ``prefetch_demo`` and
``recovery_demo`` return the numbers they print.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import (
    AsyncFederatedNode,
    InMemoryFolder,
    NodeUpdate,
    WeightStore,
    normalize_transport,
)
from repro_torch.core.serialize import _zstd_module
from repro_torch.core.strategies import FedAvgM
from repro_torch.kernels import resolve_device


def sparse_steps(n_params=200_000, pushes=12, fraction=0.005, seed=0):
    """A partial-fine-tuning-style schedule: each step perturbs a small
    fraction of entries — the regime delta transports are built for."""
    rng = np.random.default_rng(seed)
    cur = (np.arange(n_params, dtype=np.float32) % 997) * np.float32(1e-3)
    for _ in range(pushes):
        cur = cur.copy()
        idx = rng.integers(0, n_params, size=int(fraction * n_params))
        cur[idx] += rng.normal(size=idx.size).astype(np.float32)
        yield {"w": cur}


def compare_pipelines(*, n_params: int = 200_000, pushes: int = 12) -> dict:
    """One writer and one reader per spec over the same schedule; returns the
    envelope chosen and each pipeline's wire counters."""
    envelope = "zstd" if _zstd_module() is not None else "npz"
    specs = ["full", "quantized", "delta", f"delta(chain=4)|{envelope}",
             "topk(adaptive)"]
    print(f"pipeline comparison ({envelope} envelope available)\n")
    print(f"{'spec':<22}{'wire MB':>9}{'rebases':>9}{'re-anchors':>11}"
          f"{'max depth':>11}")
    rows = []
    for spec in specs:
        folder = InMemoryFolder()
        writer = WeightStore(folder, transport=spec)
        reader = WeightStore(folder)
        for ctr, params in enumerate(sparse_steps(n_params, pushes)):
            writer.push(NodeUpdate(params, num_examples=1, node_id="n",
                                   counter=ctr))
            reader.pull_node("n")
        s = writer.transport_stats()
        wire = (s["bytes_written"] + reader.bytes_read) / 1e6
        print(f"{writer.transport:<22}{wire:>9.2f}{s['rebases']:>9}"
              f"{s['reanchors']:>11}{s['max_chain_depth']:>11}")
        rows.append({"spec": spec, "pipeline": writer.transport, "wire_mb": wire,
                     "bytes_written": s["bytes_written"], "bytes_read": reader.bytes_read,
                     "rebases": s["rebases"], "reanchors": s["reanchors"],
                     "max_chain_depth": s["max_chain_depth"]})
    legacy = {name: normalize_transport(name) for name in ("delta_q", "topk|delta")}
    print("\nlegacy names map onto the same grammar:",
          f"delta_q -> {legacy['delta_q']},",
          f"topk|delta -> {legacy['topk|delta']}")
    return {"envelope": envelope, "pipelines": rows, "legacy": legacy}


def prefetch_demo() -> dict:
    """Warm a reader's decode cache, then pull: returns the prefetch counts."""
    print("\nbackground prefetch")
    folder = InMemoryFolder()
    writer = WeightStore(folder)
    reader = WeightStore(folder)
    for i in range(5):
        writer.push(NodeUpdate({"w": np.full((4096,), float(i), np.float32)},
                               num_examples=1, node_id=f"peer{i}", counter=0))
    reader.warm_cache()          # what the prefetch thread runs periodically
    reader.pull()                # the federation step itself: all cache hits
    s = reader.transport_stats()
    fresh = s["decode_misses"] - s["prefetched"]
    print(f"  warmed {s['prefetched']} peers ahead of time; "
          f"the pull paid {s['decode_hits']} cache hits, "
          f"{fresh} fresh decodes")
    return {"prefetched": s["prefetched"], "decode_hits": s["decode_hits"],
            "decode_misses": s["decode_misses"], "fresh_decodes": fresh}


def recovery_demo(*, device: "str | torch.device" = "cuda") -> dict:
    """Two FedAvgM nodes persisting their strategy state; node ``a``
    restarts and must find its momentum where it left it. Returns |momentum|
    before and after, whether the restored buffer is bit-equal, and the
    strategies' ``fed_agg`` launches."""
    dev = resolve_device(device)
    print("\nstrategy-state recovery (FedAvgM momentum survives a restart)")
    folder = InMemoryFolder()
    a = AsyncFederatedNode(strategy=FedAvgM(device=dev), shared_folder=folder,
                           node_id="a", persist_strategy_state=True)
    b = AsyncFederatedNode(strategy=FedAvgM(device=dev), shared_folder=folder,
                           node_id="b", persist_strategy_state=True)
    rng = np.random.default_rng(0)
    pa = {"w": torch.from_numpy(rng.normal(size=(512,)).astype(np.float32)).to(dev)}
    pb = {"w": torch.from_numpy(rng.normal(size=(512,)).astype(np.float32)).to(dev)}
    a.update_parameters(pa, num_examples=1)
    b.update_parameters(pb, num_examples=1)
    a.update_parameters(pa, num_examples=1)         # aggregates + persists
    momentum = float(a.strategy.buf.abs().sum())
    a2 = AsyncFederatedNode(strategy=FedAvgM(device=dev), shared_folder=folder,
                            node_id="a", persist_strategy_state=True)
    buf = a2.strategy.buf
    restored = float(buf.abs().sum()) if buf is not None else 0.0
    bit_equal = buf is not None and torch.equal(buf, a.strategy.buf)
    print(f"  |momentum| before crash = {momentum:.4f}, "
          f"after restart = {restored:.4f} "
          f"({'restored' if restored == momentum else 'LOST'})")
    launches = {k: a.strategy.launches[k] + b.strategy.launches[k] for k in a.strategy.launches}
    return {"momentum": momentum, "restored": restored, "bit_equal": bit_equal,
            "launches": launches}


def main(argv: list[str] | None = None, *, record: dict | None = None) -> int:
    """Runs the three demos; ``record``, when given, receives their numbers."""
    ap = argparse.ArgumentParser(prog="repro_torch.examples.transport_pipelines",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {"pipelines": compare_pipelines(), "prefetch": prefetch_demo(),
           "recovery": recovery_demo(device=dev)}
    out["launches"] = out["recovery"]["launches"]
    if record is not None:
        record.update(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
