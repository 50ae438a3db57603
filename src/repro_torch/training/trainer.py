"""Local training loop with callback hooks (the Keras-fit analogue) — the
port of ``repro.training.trainer``.

The federated layer (``repro_torch.core.FederatedCallback``) plugs into
``on_epoch_end`` exactly as the paper plugs its FlwrFederatedCallback into
Keras. Parameters are a dict of tensors on the trainer's device; a step takes
gradients of the loss with respect to every leaf with ``torch.autograd.grad``
(``value_and_grad``) and updates the tensors in place. ``make_train_step``
is the same step as a plain function, the reference's (params, opt_state,
batch, rng) → (params, opt_state, metrics).
"""
from __future__ import annotations

import random as _random
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Sequence

import numpy as np
import torch

from repro_torch.core.telemetry import Telemetry
from repro_torch.core.tree import (
    PyTree, as_tensor, torch_dtype, tree_flatten_with_path, tree_leaves, tree_map,
    tree_structure, tree_to_numpy, tree_unflatten,
)
from repro_torch.kernels import resolve_device
from repro_torch.optim import Optimizer, apply_updates

# loss_fn(params, batch, generator) -> (loss, metrics dict of 0-d tensors)
LossFn = Callable[[PyTree, Any, torch.Generator], tuple[torch.Tensor, dict]]

_NO_TELEMETRY = Telemetry(enabled=False)  # every span() the shared no-op


@dataclass
class TrainState:
    params: PyTree
    opt_state: PyTree
    step: int = 0


def value_and_grad(loss_fn: Callable, params: PyTree, *args) -> tuple[tuple, PyTree]:
    """((loss, metrics), grads as a tree like ``params``) of
    ``loss_fn(params, *args)`` → (loss, metrics), as ``jax.value_and_grad(...,
    has_aux=True)``. The leaves track gradients only inside this call; a leaf
    the loss does not use gets a zero gradient, as under ``jax.grad``. The
    loss comes back detached."""
    leaves_with_paths, treedef = tree_flatten_with_path(params)
    leaves = [leaf for _, leaf in leaves_with_paths]
    for leaf in leaves:
        leaf.requires_grad_(True)
    try:
        loss, metrics = loss_fn(params, *args)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    finally:
        for leaf in leaves:
            leaf.requires_grad_(False)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_unflatten(treedef, grads)


def make_train_step(loss_fn: LossFn, optimizer: Optimizer, telemetry: Telemetry | None = None):
    """(params, opt_state, batch, rng) -> (params, opt_state, metrics). The
    parameter and moment tensors are updated in place and returned. With a
    ``telemetry``, the gradient and the update are spans ``train.grad`` and
    ``train.update``; on the card each times how long the host takes to issue
    its work (no span waits for the card)."""
    if telemetry is None:
        telemetry = _NO_TELEMETRY

    def train_step(params, opt_state, batch, rng):
        with telemetry.span("train.grad"):
            (loss, metrics), grads = value_and_grad(loss_fn, params, batch, rng)
        with telemetry.span("train.update"):
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = apply_updates(params, updates)
        return params, opt_state, {**metrics, "loss": loss}

    return train_step


def _owned(leaf, device: torch.device) -> torch.Tensor:
    """A fresh tensor on ``device`` with the leaf's dtype (never shared)."""
    dtype = leaf.dtype if isinstance(leaf, torch.Tensor) else torch_dtype(np.asarray(leaf).dtype)
    return as_tensor(leaf).to(device=device, dtype=dtype, copy=True)


class Trainer:
    def __init__(
        self,
        *,
        loss_fn: LossFn,
        optimizer: Optimizer,
        init_params: PyTree,
        eval_fn: Callable[[PyTree, Any], dict] | None = None,
        seed: int = 0,
        slowdown: float = 0.0,
        name: str = "trainer",
        telemetry=None,
        device: "str | torch.device" = "cuda",
    ):
        """``init_params`` (tensors or numpy, e.g. another package's weights)
        are copied onto ``device``: the trainer owns its parameter tensors.

        ``slowdown``: artificial seconds of sleep per step (straggler
        experiments). ``telemetry``: an optional ``Telemetry``; each
        ``run_epoch`` then records a ``train`` span, ended by the epoch's
        single host sync, with a ``train.step`` child a step (children
        ``train.input``, ``train.grad``, ``train.update``). A step's spans
        time the host issuing its work: on the card they end before it does."""
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.telemetry = telemetry
        self.eval_fn = eval_fn
        self.params = tree_map(lambda x: _owned(x, self.device), init_params)
        self.opt_state = optimizer.init(self.params)
        self.step = 0
        self.name = name
        self.slowdown = slowdown
        self.rng = torch.Generator().manual_seed(seed)  # handed to loss_fn
        self.rng_py = _random.Random(seed)
        self._train_step = make_train_step(loss_fn, optimizer, telemetry)
        self.log: list[dict] = []
        self.crashed = False

    # -- params plumbing for federation --------------------------------------
    def host_params(self) -> PyTree:
        return tree_to_numpy(self.params)

    @torch.no_grad()
    def set_params(self, params: PyTree) -> None:
        """Copy ``params`` into the trainer's own tensors, keeping their
        dtypes. Never adopts the given storage: an aggregate's leaves are
        views of the strategy's output buffer."""
        if tree_structure(params) != tree_structure(self.params):
            raise ValueError("set_params: tree structure differs from the trainer's")
        for own, new in zip(tree_leaves(self.params), tree_leaves(params)):
            own.copy_(as_tensor(new))

    def _to_device(self, batch: dict) -> dict:
        if self.device.type != "cuda":
            return {k: as_tensor(v).to(self.device) for k, v in batch.items()}
        # A copy from pageable memory would wait for the previous step's
        # kernels (a host sync per step); staged through pinned memory it is
        # asynchronous.
        return {k: as_tensor(v).pin_memory().to(self.device, non_blocking=True)
                for k, v in batch.items()}

    # -- core loop ------------------------------------------------------------
    def run_epoch(self, batches: Iterable, steps: int | None = None) -> dict:
        tel = self.telemetry
        if tel is None or not tel.enabled:
            return self._run_epoch(batches, steps, _NO_TELEMETRY)[0]
        with tel.span("train") as span:  # closed after the epoch's host sync
            logs, count = self._run_epoch(batches, steps, tel)
        tel.note_train(count, span.dur)
        return logs

    def _run_epoch(self, batches: Iterable, steps: int | None, tel: Telemetry) -> tuple[dict, int]:
        # Metrics stay on the device for the whole epoch: a per-step
        # float(v) would wait on each step. One host copy at the end.
        step_metrics: list[torch.Tensor] = []
        names: list[str] = []
        for i, batch in enumerate(batches):
            if steps is not None and i >= steps:
                break
            with tel.span("train.step"):
                with tel.span("train.input"):
                    batch = self._to_device(batch)
                self.params, self.opt_state, metrics = self._train_step(
                    self.params, self.opt_state, batch, self.rng)
            if self.slowdown:
                time.sleep(self.slowdown)
            self.step += 1
            names = list(metrics)
            step_metrics.append(torch.stack([metrics[k].float() for k in names]))
        count = len(step_metrics)
        sums = (torch.stack(step_metrics).cpu().double().sum(0).tolist()
                if step_metrics else [])
        return {k: v / max(1, count) for k, v in zip(names, sums)}, count

    def fit(
        self,
        data_fn: Callable[[int], Iterable] | Iterable,
        *,
        epochs: int,
        steps_per_epoch: int | None = None,
        callbacks: Sequence = (),
        crash_at_epoch: int | None = None,
        verbose: bool = False,
    ) -> list[dict]:
        """Run local training with end-of-epoch callback hooks.

        ``data_fn`` is either a callable epoch→iterable (fresh shuffling per
        epoch) or a single reusable iterable. ``crash_at_epoch`` injects a
        failure for the robustness experiments.
        """
        for cb in callbacks:
            cb.on_train_begin(self)
        try:
            for epoch in range(epochs):
                if crash_at_epoch is not None and epoch >= crash_at_epoch:
                    self.crashed = True
                    raise RuntimeError(f"{self.name}: injected crash at epoch {epoch}")
                for cb in callbacks:
                    cb.on_epoch_begin(self, epoch)
                batches = data_fn(epoch) if callable(data_fn) else data_fn
                logs = self.run_epoch(batches, steps_per_epoch)
                if self.eval_fn is not None:
                    logs.update(self.eval_fn(self.params, None))
                logs["epoch"] = epoch
                self.log.append(logs)
                if verbose:
                    print(f"[{self.name}] epoch {epoch}: " + ", ".join(
                        f"{k}={v:.4f}" for k, v in logs.items() if isinstance(v, float)))
                for cb in callbacks:
                    cb.on_epoch_end(self, epoch, logs)
        finally:
            # Teardown even on an injected crash: a FederatedCallback must
            # get the chance to stop its node's prefetcher thread.
            for cb in callbacks:
                cb.on_train_end(self)
        return self.log
