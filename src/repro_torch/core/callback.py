"""Federated callback — the paper's `FlwrFederatedCallback` equivalent.

The paper hooks federation into the ML framework's callback mechanism
(Keras `on_epoch_end`). The port's trainer (`repro_torch.training.Trainer`)
exposes the same hook; this callback pushes/pulls/aggregates via the node and, when the
node returns aggregated weights, swaps them into the training loop.

A callback-based design keeps the paper's "minimal modification" principle:
federation is one line added to an existing training script.
"""
from __future__ import annotations

from collections import deque
from typing import Any

from .node import AsyncFederatedNode, SyncFederatedNode
from .tree import PyTree


class Callback:
    """Trainer callback protocol (duck-typed; see repro_torch.training.Trainer)."""

    def on_train_begin(self, trainer) -> None: ...

    def on_epoch_begin(self, trainer, epoch: int) -> None: ...

    def on_epoch_end(self, trainer, epoch: int, logs: dict[str, Any]) -> None: ...

    def on_train_end(self, trainer) -> None: ...


class FederatedCallback(Callback):
    """Federate at the end of every local epoch (paper: 'model federation
    happened at the end of each epoch')."""

    def __init__(
        self,
        node: AsyncFederatedNode | SyncFederatedNode,
        *,
        num_examples_per_epoch: int,
        federate_every: int = 1,
        sample_prob: float = 1.0,
        history_limit: int | None = 10_000,
    ):
        self.node = node
        self.num_examples_per_epoch = num_examples_per_epoch
        self.federate_every = federate_every  # paper limitation #4: frequency knob
        self.sample_prob = sample_prob  # Algorithm 1's C: client sampling prob
        # Bounded: a million-epoch soak must not grow memory linearly. The
        # deque keeps the most recent entries; None means unbounded (legacy).
        self.history: "deque[dict[str, Any]]" = deque(maxlen=history_limit)

    def on_epoch_end(self, trainer, epoch: int, logs: dict[str, Any]) -> None:
        if (epoch + 1) % self.federate_every != 0:
            return
        if self.sample_prob < 1.0 and trainer.rng_py.random() >= self.sample_prob:
            # Non-sampled clients keep training without the WeightUpdate step
            # (one of the two sampling semantics described in the paper).
            self.history.append({"epoch": epoch, "federated": False, "sampled": False})
            return
        # the device-to-host copy of the parameters, in its own span
        with self.node.telemetry.span("host_copy"):
            params = trainer.host_params()
        new_params: PyTree | None = self.node.update_parameters(
            params, num_examples=self.num_examples_per_epoch, metrics=dict(logs)
        )
        if new_params is not None:
            trainer.set_params(new_params)
        self.history.append(
            {"epoch": epoch, "federated": new_params is not None, "sampled": True}
        )

    def on_train_end(self, trainer) -> None:
        # Trainer.fit runs this via try/finally, so a crashed fit cannot leak
        # the store's background prefetcher thread.
        self.node.store.stop_prefetch()
