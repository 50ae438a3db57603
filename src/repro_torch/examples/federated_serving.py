"""Serving tier demo: federated weights flow straight into live traffic — the
torch twin of ``examples/federated_serving.py``.

Two async trainer nodes federate a small decoder LM (pythia-14m) through one
store while a read-only ``ServingNode`` (``repro_torch.api.serve``) rides the
same store: it deploys the freshest aggregated weights, hot-swaps with
zero-downtime double buffering as new rounds land, and keeps serving batched
greedy decode throughout. No server, no publish step — the store IS the
deployment pipeline.

    python -m repro_torch.examples.federated_serving          # ~14M params
    python -m repro_torch.examples.federated_serving --smoke  # the reduced config
    python -m repro_torch.examples.federated_serving --smoke --device cpu

Prints per-batch throughput plus the serving SLOs (rounds-behind-store
staleness, swap-latency percentiles) and finishes with the fleet dashboard —
the SERVE row is fed purely from ``obs/`` blobs in the store. Trainers and
the server share one device (the card unless ``--device cpu`` is given) from
their threads. ``main`` returns a record: the batches served (tokens/s, the
weights' source and counter), the node's stats, the first deploy's delay,
the trainers' results and the dashboard's rows.
"""
from __future__ import annotations

import argparse
import threading
import time
import uuid

import numpy as np

from repro_torch.api import connect, serve
from repro_torch.configs import get_config
from repro_torch.core import AsyncFederatedNode, FederatedCallback, collect_obs, run_threaded
from repro_torch.core.strategies import FedAvg
from repro_torch.data import lm_batch_iterator, make_synthetic_wikitext
from repro_torch.kernels import resolve_device
from repro_torch.models import build_model
from repro_torch.obs import render_dashboard
from repro_torch.optim import adamw, chain_clip
from repro_torch.training import Trainer

SEQ, BATCH = 64, 8
PROMPTS, PROMPT_LEN, NEW_TOKENS = 4, 16, 16  # each served batch
FIRST_DEPLOY_S = 120.0  # how long the server waits for the trainers' first push


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="repro_torch.examples.federated_serving",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--new-tokens", type=int, default=NEW_TOKENS)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    cfg = get_config("pythia-14m")
    if args.smoke:
        cfg = cfg.reduced()
    epochs, steps = (2, 8) if args.smoke else (4, 15)
    dev = resolve_device(args.device)
    # a named memory:// folder is one in-process folder shared by every
    # connect() below (fresh per run); point this at a disk/NFS path or an
    # s3:// bucket for a real deployment
    uri = f"memory://federated-serving-demo-{uuid.uuid4().hex[:8]}"

    model = build_model(cfg)
    init_params = model.init(0, device=dev)  # common init
    data = make_synthetic_wikitext(vocab_size=cfg.vocab_size, train_tokens=60_000, seed=0)

    def trainer(i: int) -> dict:
        node = AsyncFederatedNode(strategy=FedAvg(device=dev), store=connect(uri),
                                  node_id=f"trainer{i}", telemetry=True)
        cb = FederatedCallback(node, num_examples_per_epoch=steps * BATCH)
        t = Trainer(loss_fn=lambda p, b, r: model.loss(p, b),
                    optimizer=chain_clip(adamw(3e-4), 1.0), init_params=init_params, seed=i,
                    name=f"trainer{i}", device=dev)
        t.fit(lambda e: lm_batch_iterator(data.train_tokens, batch_size=BATCH, seq_len=SEQ,
                                          seed=i, epoch=e),
              epochs=epochs, steps_per_epoch=steps, callbacks=[cb], verbose=False)
        # short runs end between flush cadences — deposit one final obs snapshot
        payload = node.telemetry.snapshot(node.transport_stats())
        node.store.push_obs(node.node_id, payload["seq"], payload)
        return {"node": f"trainer{i}", "pushes": node.num_pushes,
                "aggregations": node.num_aggregations}

    # serving node first: it joins the (still empty) store read-only and waits
    node = serve(connect(uri), cfg, poll_interval=0.2, telemetry=True, device=dev)
    results = []
    fleet = threading.Thread(target=lambda: results.extend(run_threaded(
        [lambda i=i: trainer(i) for i in range(2)], names=["trainer0", "trainer1"])))
    t_start = time.monotonic()
    fleet.start()
    try:
        if not node.wait_until_deployed(FIRST_DEPLOY_S):
            raise RuntimeError(f"no weights reached the store within {FIRST_DEPLOY_S} s")
        first_deploy_s = time.monotonic() - t_start
        print(f"first deploy: {node.stats()['source']}@{node.stats()['counter']}")

        rng = np.random.default_rng(0)
        batches = []
        while fleet.is_alive() or not batches:
            prompts = rng.integers(0, cfg.vocab_size, (PROMPTS, PROMPT_LEN), dtype=np.int32)
            t0 = time.monotonic()
            out, meta = node.generate(prompts, new_tokens=args.new_tokens)
            dt = time.monotonic() - t0
            batches.append({"tokens_per_s": out.size / dt, "source": meta["source"],
                            "counter": meta["counter"], "swaps": node.stats()["swaps"]})
            print(f"  batch {len(batches)}: {out.size / dt:7.1f} tok/s  "
                  f"weights={meta['source']}@{meta['counter']}  "
                  f"swaps={node.stats()['swaps']}")
        fleet.join()

        stats = node.stats()
        print(f"served {len(batches)} batches across {stats['swaps']} hot swaps")
        print(f"staleness (rounds behind store): mean={stats['staleness_mean']:.2f} "
              f"max={stats['staleness_max']:.0f}")
        print(f"swap latency: p50={stats['swap_ms_p50']:.1f}ms "
              f"p99={stats['swap_ms_p99']:.1f}ms")
        if stats["swaps"] < 1:
            raise RuntimeError("serving node never deployed")
        for r in results:
            if r.error is not None:
                raise RuntimeError(f"{r.node_id} failed:\n{r.traceback}")
            print(r.result)
    finally:
        node.stop()  # flushes the node's last obs snapshot
    print()
    rows = render_dashboard(collect_obs(uri))
    return {"first_deploy_s": first_deploy_s, "batches": batches, "stats": stats,
            "trainers": [r.result for r in results], "dashboard": rows}


if __name__ == "__main__":
    main()
