"""End-to-end example: federated training of a decoder language model with
LoRA adapters — the torch twin of ``examples/federated_llm.py``.

Serverless async nodes train a 12-layer / d512 decoder LM (Pythia-style,
with LoRA adapters on the attention q-projections: 63,681,024 parameters
with the embeddings tied, of which 98,304 are adapters; the reference's
docstring says ≈95M) on disjoint shards of a synthetic WikiText stream,
federating through a real weight store (delta-chain transport by default)
after every epoch — the paper's §4.4 experiment scaled to a fleet of
affordable compute nodes.

    python -m repro_torch.examples.federated_llm                 # 63.68M, 300 steps a node
    python -m repro_torch.examples.federated_llm --smoke         # the small version
    python -m repro_torch.examples.federated_llm --adapters-only # LoRA federation
    python -m repro_torch.examples.federated_llm --smoke --device cpu

``--adapters-only`` federates only the ``adapters`` leaf family
(``family(adapters=full)`` transport + ``PartialFedAvg(families=...)``): each
round moves ~2 orders of magnitude fewer bytes while every other weight stays
node-local. Training, aggregation and evaluation run on the card unless
``--device cpu`` is given. ``main`` returns one record per node (eval loss and
next-token accuracy, aggregations, megabytes written and read, the bytes of
each push, and the node's ``train`` and ``aggregate`` span statistics).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.core import (
    AsyncFederatedNode, Callback, FederatedCallback, make_folder, run_threaded,
)
from repro_torch.core.partition import partition_sequence_dataset
from repro_torch.core.strategies import FedAvg
from repro_torch.core.tree import LeafSpec
from repro_torch.data import lm_batch_iterator, make_synthetic_wikitext
from repro_torch.kernels import resolve_device
from repro_torch.models import ModelConfig, build_model
from repro_torch.optim import adamw, chain_clip
from repro_torch.training import Trainer

CFG = ModelConfig(
    name="fedlm-95m",
    n_layers=12, d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048,
    vocab_size=50304, activation="gelu", dtype="float32", lora_rank=8,
    source="Pythia-style ~100M (arXiv:2304.01373) + LoRA (arXiv:2106.09685)",
)
SMOKE = dict(n_layers=4, d_model=256, d_ff=1024, vocab_size=2048)
SEQ, BATCH = 128, 8


class PushBytes(Callback):
    """The bytes each epoch's push wrote: the node's write counter read at
    every epoch end, after the federation callback has pushed."""

    def __init__(self, node: AsyncFederatedNode):
        self.node, self.total, self.per_push = node, 0, []

    def on_epoch_end(self, trainer, epoch, logs) -> None:
        written = self.node.transport_stats()["bytes_written"]
        self.per_push.append(written - self.total)
        self.total = written


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="repro_torch.examples.federated_llm", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--nodes", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--transport", default="delta(chain=4)",
                    help="weight-store pipeline spec, e.g. full, delta(chain=4), "
                         "'family(adapters=full,norms=delta)'")
    ap.add_argument("--adapters-only", action="store_true",
                    help="LoRA-style federation: ship + aggregate only the "
                         "adapters leaf family; all other weights stay local")
    ap.add_argument("--store", default="memory://",
                    help="folder URI of the shared store (default: a fresh in-memory folder)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> list[dict]:
    args = parse_args(argv)
    cfg = CFG.replace(**SMOKE) if args.smoke else CFG
    epochs = args.epochs or (2 if args.smoke else 10)
    steps = 10 if args.smoke else 30  # per epoch per node
    dev = resolve_device(args.device)

    model = build_model(cfg)
    n_params = LeafSpec.of(model.abstract()).num_params
    print(f"model: {cfg.name}  params={n_params / 1e6:.2f}M  nodes={args.nodes}  "
          f"steps/node={epochs * steps}  "
          f"wire={'family(adapters=full)' if args.adapters_only else args.transport}")

    data = make_synthetic_wikitext(vocab_size=cfg.vocab_size, train_tokens=400_000, seed=0)
    shards = partition_sequence_dataset(data.train_tokens, args.nodes)
    folder = make_folder(args.store)
    init_params = model.init(0, device=dev)  # common init

    @torch.no_grad()
    def evaluate(params):
        accs, losses = [], []
        for i, batch in enumerate(lm_batch_iterator(data.test_tokens, batch_size=8,
                                                    seq_len=SEQ, seed=9)):
            if i >= 4:
                break
            loss, m = model.loss(params, {k: torch.from_numpy(v).to(dev)
                                          for k, v in batch.items()})
            losses.append(float(loss))
            accs.append(float(m["accuracy"]))
        return float(np.mean(losses)), float(np.mean(accs))

    def client(i: int) -> dict:
        if args.adapters_only:
            # families= wires both halves of subset federation: the node's
            # store ships family(adapters=full) blobs, and the default strategy
            # becomes PartialFedAvg(families=...) so non-adapter leaves stay
            # personal.
            node = AsyncFederatedNode(shared_folder=folder, node_id=f"node{i}",
                                      families=("adapters",), telemetry=True, device=dev)
        else:
            node = AsyncFederatedNode(strategy=FedAvg(device=dev), shared_folder=folder,
                                      node_id=f"node{i}", transport=args.transport,
                                      telemetry=True)
        trainer = Trainer(loss_fn=lambda p, b, r: model.loss(p, b),
                          optimizer=chain_clip(adamw(3e-4), 1.0), init_params=init_params,
                          seed=i, name=f"node{i}", device=dev, telemetry=node.telemetry)
        cb = FederatedCallback(node, num_examples_per_epoch=steps * BATCH)
        meter = PushBytes(node)
        trainer.fit(lambda e: lm_batch_iterator(shards[i], batch_size=BATCH, seq_len=SEQ,
                                                seed=i, epoch=e),
                    epochs=epochs, steps_per_epoch=steps, callbacks=[cb, meter],
                    verbose=(i == 0))
        loss, acc = evaluate(trainer.params)
        stats = node.transport_stats()
        spans = node.telemetry.recorder.phase_stats()
        return {"node": f"node{i}", "eval_loss": round(loss, 4), "next_token_acc": round(acc, 4),
                "aggregations": node.num_aggregations, "pushes": node.num_pushes,
                "mb_written": round(stats["bytes_written"] / 1e6, 2),
                "mb_read": round(stats["bytes_read"] / 1e6, 2),
                "push_bytes": meter.per_push,
                "train_loss": [log["loss"] for log in trainer.log],
                "spans": {k: spans[k] for k in ("train", "aggregate") if k in spans}}

    t0 = time.time()
    results = run_threaded([lambda i=i: client(i) for i in range(args.nodes)],
                           names=[f"node{i}" for i in range(args.nodes)])
    for r in results:
        if r.error is not None:
            raise RuntimeError(f"{r.node_id} failed:\n{r.traceback}")
        print(json.dumps(r.result))
    print(f"wall time: {time.time() - t0:.1f}s (no federation server was ever started)")
    return [r.result for r in results]


if __name__ == "__main__":
    main()
