"""Serving + per-client strategy heterogeneity demo — the torch twin of
``examples/serve_and_strategies.py``.

1. Serve a (reduced) Mamba2 model with batched greedy decode — the SSM decode
   path whose O(1) state makes long_500k feasible. The bulk prefill runs the
   ``ssd_scan`` kernel once per layer on the card.
2. The serverless design lets EVERY CLIENT RUN A DIFFERENT AGGREGATION
   STRATEGY (a property the paper calls out): one FedAvg node, one
   staleness-aware FedAsync node, one FedAvgM node, all sharing a store and
   each aggregating on the card (``fed_agg``).

    PYTHONPATH=src python -m repro_torch.examples.serve_and_strategies [--device cpu]

``main`` returns the exit code; ``serve_demo`` returns the prompts and the
served tokens (on the device), ``strategies_demo`` each round's values.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.api import connect
from repro_torch.configs import get_config
from repro_torch.core import AsyncFederatedNode
from repro_torch.core.strategies import FedAsync, FedAvg, FedAvgM
from repro_torch.kernels import resolve_device
from repro_torch.launch.serve import serve_batch
from repro_torch.models import build_model

STORE_URI = "memory://strategies-demo"


def serve_demo(cfg=None, *, device: "str | torch.device" = "cuda", batch: int = 4,
               prompt: int = 12, new_tokens: int = 12, seed: int = 0, params=None) -> dict:
    """Greedy-serve ``batch`` prompts of ``prompt`` tokens (drawn with numpy
    from ``seed``) for ``new_tokens`` tokens. ``cfg`` defaults to the reduced
    mamba2-130m; ``params`` to the model's init from ``seed`` on ``device``."""
    if cfg is None:
        cfg = get_config("mamba2-130m").reduced()
    dev = resolve_device(device)
    print(f"== batched serving ({cfg.name}) ==")
    if params is None:
        params = build_model(cfg).init(seed, device=dev)
    prompts = np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, prompt),
                                                   dtype=np.int32)
    out = serve_batch(cfg, params, prompts, new_tokens=new_tokens)
    sample = out[0].tolist()
    print(f"  served batch of {out.shape[0]}, {out.shape[1]} new tokens each")
    print(f"  sample continuation: {sample}")
    return {"config": cfg.name, "prompts": prompts, "tokens": out, "sample": sample}


def strategies_demo(*, device: "str | torch.device" = "cuda", rounds: int = 3,
                    uri: str = STORE_URI) -> dict:
    """Three nodes, three aggregation rules, one store; returns each round's
    values and the strategies' ``fed_agg`` launches."""
    dev = resolve_device(device)
    print("== heterogeneous per-client strategies ==")
    # named memory:// URIs share one in-process folder, so each client can open
    # its own store through the facade — same shape as a disk/S3 deployment
    nodes = {
        "avg": AsyncFederatedNode(strategy=FedAvg(device=dev), store=connect(uri),
                                  node_id="avg"),
        "asy": AsyncFederatedNode(strategy=FedAsync(alpha=0.5, device=dev),
                                  store=connect(uri), node_id="asy"),
        "mom": AsyncFederatedNode(strategy=FedAvgM(momentum=0.5, device=dev),
                                  store=connect(uri), node_id="mom"),
    }
    vals = {"avg": 0.0, "asy": 3.0, "mom": 6.0}
    history = []
    for round_ in range(rounds):
        for name, node in nodes.items():
            w = torch.full((4,), vals[name], dtype=torch.float32, device=dev)
            new = node.update_parameters({"w": w}, 100)
            if new is not None:
                vals[name] = float(new["w"][0])
        history.append(dict(vals))
        print(f"  round {round_}: " + "  ".join(f"{n}={vals[n]:.3f}" for n in nodes))
    print("  (three different aggregation rules, one store, zero servers)")
    launches = {"fed_agg": sum(n.strategy.launches["fed_agg"] for n in nodes.values())}
    return {"rounds": history, "launches": launches}


def main(argv: list[str] | None = None, *, record: dict | None = None) -> int:
    """Runs both demos; ``record``, when given, receives their numbers."""
    ap = argparse.ArgumentParser(prog="repro_torch.examples.serve_and_strategies",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {"serve": serve_demo(device=dev), "strategies": strategies_demo(device=dev)}
    out["launches"] = out["strategies"]["launches"]
    if record is not None:
        record.update(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
