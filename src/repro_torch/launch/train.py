"""Federated LM training launcher — the port of ``python -m repro.launch.train``.

Each federated *silo* is one process; silos share only a weight-store folder
(a DiskFolder on a shared mount in production, an InMemoryFolder under
--simulate threading). This is the paper's serverless workflow (§4.4,
pythia-14m on WikiText):

    # two real silos on two machines, shared mount:
    python -m repro_torch.launch.train --arch pythia-14m --node-id silo0 --num-nodes 2 \\
        --store /mnt/shared/exp1 --mode async --strategy fedavg
    python -m repro_torch.launch.train ... --node-id silo1 ...

    # single-process simulation of N silos (paper's setup):
    python -m repro_torch.launch.train --arch pythia-14m --simulate 3 --mode async

    # on the CPU, at the reduced config:
    python -m repro_torch.launch.train --simulate 2 --reduced --device cpu

Runs on the card unless ``--device cpu`` is given. Each node's result is one
JSON line: the reference's keys (node, pushes, aggregations, eval_loss,
eval_accuracy), the mean training loss of each epoch, and, with telemetry on
(``REPRO_OBS=1``), the node's span statistics (``train`` per epoch,
``push``, ``pull``, ``aggregate``). The exit code is 1 if a node failed.
"""
from __future__ import annotations

import argparse
import json
import zlib

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import (
    AsyncFederatedNode,
    FederatedCallback,
    InMemoryFolder,
    SyncFederatedNode,
    get_strategy,
    make_folder,
    run_threaded,
)
from repro_torch.core.partition import partition_sequence_dataset
from repro_torch.core.tree import tree_leaves
from repro_torch.data import lm_batch_iterator, make_synthetic_wikitext
from repro_torch.models import build_model
from repro_torch.optim import adamw, with_accumulation
from repro_torch.training import Trainer


def node_seed(seed: int, node_id: str) -> int:
    """A node's seed: ``seed`` plus a stable function of its id. (The
    reference adds ``hash(node_id) % 1000``, which Python salts per process,
    so its nodes draw other data and weights in every run.)"""
    return seed + zlib.crc32(node_id.encode()) % 1000


def make_lm_trainer(cfg, tokens, *, seq_len, batch_size, seed, lr, accum=1, slowdown=0.0,
                    name="node", device="cuda", telemetry=None):
    model = build_model(cfg)
    params = model.init(seed, device=device)
    opt = with_accumulation(adamw(lr), accum)

    def loss_fn(p, batch, rng):
        return model.loss(p, batch)

    trainer = Trainer(loss_fn=loss_fn, optimizer=opt, init_params=params, seed=seed,
                      slowdown=slowdown, name=name, device=device, telemetry=telemetry)

    def data_fn(epoch):
        return lm_batch_iterator(tokens, batch_size=batch_size, seq_len=seq_len,
                                 seed=seed, epoch=epoch)

    return trainer, data_fn


@torch.no_grad()
def evaluate_lm(cfg, params, tokens, *, seq_len, batch_size=8, max_batches=8):
    model = build_model(cfg)
    device = tree_leaves(params)[0].device
    accs, losses = [], []
    for i, batch in enumerate(
        lm_batch_iterator(tokens, batch_size=batch_size, seq_len=seq_len, seed=999)
    ):
        if i >= max_batches:
            break
        loss, metrics = model.loss(params, {k: torch.from_numpy(v).to(device)
                                            for k, v in batch.items()})
        losses.append(float(loss))
        accs.append(float(metrics["accuracy"]))
    return {"eval_loss": float(np.mean(losses)), "eval_accuracy": float(np.mean(accs))}


def run_client(cfg, node_id, folder, args, tokens_shard, eval_tokens):
    strategy = get_strategy(args.strategy, device=args.device)
    if args.mode == "sync":
        node = SyncFederatedNode(strategy=strategy, shared_folder=folder, node_id=node_id,
                                 num_nodes=args.num_nodes, timeout=args.timeout,
                                 device=args.device)
    else:
        node = AsyncFederatedNode(strategy=strategy, shared_folder=folder, node_id=node_id,
                                  device=args.device)
    trainer, data_fn = make_lm_trainer(
        cfg, tokens_shard, seq_len=args.seq_len, batch_size=args.batch_size,
        seed=node_seed(args.seed, node_id), lr=args.lr, accum=args.accum,
        name=node_id, device=args.device, telemetry=node.telemetry,
    )
    steps = args.steps_per_epoch
    num_examples = steps * args.batch_size
    cb = FederatedCallback(node, num_examples_per_epoch=num_examples)
    trainer.fit(data_fn, epochs=args.epochs, steps_per_epoch=steps, callbacks=[cb],
                verbose=args.verbose)
    metrics = evaluate_lm(cfg, trainer.params, eval_tokens, seq_len=args.seq_len)
    result = {"node": node_id, "pushes": node.num_pushes, "aggregations": node.num_aggregations,
              **metrics, "train_loss": [log["loss"] for log in trainer.log]}
    if node.telemetry.enabled:
        result["spans"] = node.telemetry.recorder.phase_stats()
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="pythia-14m")
    ap.add_argument("--mode", default="async", choices=["async", "sync"])
    ap.add_argument("--strategy", default="fedavg")
    ap.add_argument("--store", default="memory://")
    ap.add_argument("--node-id", default=None, help="run as ONE real silo (production)")
    ap.add_argument("--num-nodes", type=int, default=2)
    ap.add_argument("--simulate", type=int, default=0, help="simulate N silos via threads")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--steps-per-epoch", type=int, default=50)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--lr", type=float, default=2e-5)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true", help="use the reduced config")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", default="cuda", help="where weights, training and aggregation run")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = cfg.replace(vocab_size=min(cfg.vocab_size, args.vocab))

    data = make_synthetic_wikitext(vocab_size=cfg.vocab_size, seed=args.seed)
    num_nodes = args.simulate or args.num_nodes
    shards = partition_sequence_dataset(data.train_tokens, num_nodes)

    if args.simulate:
        folder = InMemoryFolder() if args.store == "memory://" else make_folder(args.store)
        args.num_nodes = num_nodes
        fns = [
            (lambda i=i: run_client(cfg, f"node{i}", folder, args, shards[i], data.test_tokens))
            for i in range(num_nodes)
        ]
        results = run_threaded(fns, names=[f"node{i}" for i in range(num_nodes)])
        for r in results:
            if r.error:
                print(f"[{r.node_id}] FAILED: {r.error}\n{r.traceback}")
            else:
                print(json.dumps(r.result))
        return 1 if any(r.error for r in results) else 0

    if args.node_id is None:
        ap.error("need --node-id (production) or --simulate N")
    idx = int(args.node_id[-1]) if args.node_id[-1].isdigit() else 0
    folder = make_folder(args.store)
    result = run_client(cfg, args.node_id, folder, args, shards[idx % num_nodes], data.test_tokens)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
