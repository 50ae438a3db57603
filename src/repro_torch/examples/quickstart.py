"""Quickstart — the paper's usage pattern, end to end (the torch twin of
``examples/quickstart.py``).

Two clients train the paper's MNIST CNN on disjoint label partitions and
federate asynchronously through a shared folder (here: a temp dir on disk —
point it at an NFS/S3 mount in production). No server anywhere. The clients
train and aggregate on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch.api import connect
from repro_torch.core import AsyncFederatedNode, FederatedCallback, run_threaded
from repro_torch.core.partition import partition_dataset
from repro_torch.core.strategies import FedAvg
from repro_torch.data import batch_iterator, make_synthetic_mnist
from repro_torch.kernels import resolve_device
from repro_torch.models.cnn import MnistCNN
from repro_torch.optim import adam
from repro_torch.training import Trainer

EPOCHS, STEPS, BATCH = 5, 20, 32


def run(shared_dir: str, *, device: "str | torch.device" = "cuda", epochs: int = EPOCHS,
        steps: int = STEPS, batch: int = BATCH, num_train: int = 2000, num_test: int = 500,
        verbose: bool = True) -> list[float]:
    """Two federated MnistCNN clients on ``shared_dir``; returns each
    client's test accuracy."""
    dev = resolve_device(device)
    data = make_synthetic_mnist(num_train=num_train, num_test=num_test)
    shards = partition_dataset(data.x_train, data.y_train, num_nodes=2, skew=0.9)

    def client(i: int) -> float:
        model = MnistCNN()
        trainer = Trainer(
            loss_fn=lambda p, b, r: model.loss(p, b),
            optimizer=adam(1e-3),
            init_params=model.init(0, device=dev),  # common init
            seed=i,
            name=f"client{i}",
            device=dev,
        )
        # --- the paper's three-line federation setup -------------------------
        node = AsyncFederatedNode(strategy=FedAvg(device=dev), store=connect(shared_dir),
                                  node_id=f"client{i}")
        callback = FederatedCallback(node, num_examples_per_epoch=steps * batch)
        # ----------------------------------------------------------------------
        x, y = shards[i]
        trainer.fit(lambda e: batch_iterator(x, y, batch_size=batch, seed=i, epoch=e),
                    epochs=epochs, steps_per_epoch=steps, callbacks=[callback], verbose=verbose)
        with torch.no_grad():
            logits = model.apply(trainer.params, torch.from_numpy(data.x_test).to(dev))
        acc = float((logits.argmax(-1).cpu() == torch.from_numpy(data.y_test)).float().mean())
        if verbose:
            print(f"client{i}: test accuracy {acc:.3f} "
                  f"(pushes={node.num_pushes}, aggregations={node.num_aggregations})")
        return acc

    results = run_threaded([lambda: client(0), lambda: client(1)])
    for r in results:
        if r.error is not None:
            raise RuntimeError(f"{r.node_id} failed:\n{r.traceback}")
    return [r.result for r in results]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.examples.quickstart", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    shared_dir = tempfile.mkdtemp(prefix="flwr_serverless_")
    print(f"weight store: {shared_dir}")
    run(shared_dir, device=args.device)
    print("done — no server was harmed (or started) in this experiment.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
