"""Batching pipeline: host-side numpy batches, identical to ``repro``'s for
the same seeds, plus ``shard_batch`` to place a global batch on a
``DeviceMesh``."""
from __future__ import annotations

from typing import Iterator

import math

import numpy as np
import torch
from torch.distributed.tensor import distribute_tensor

from repro_torch.core.tree import tree_map


def batch_iterator(
    x: np.ndarray,
    y: np.ndarray,
    *,
    batch_size: int,
    seed: int = 0,
    epoch: int = 0,
    drop_remainder: bool = True,
) -> Iterator[dict]:
    """Shuffled minibatches; reshuffles deterministically per epoch."""
    n = x.shape[0]
    rng = np.random.default_rng(seed * 100003 + epoch)
    perm = rng.permutation(n)
    end = (n // batch_size) * batch_size if drop_remainder else n
    for i in range(0, end, batch_size):
        idx = perm[i : i + batch_size]
        yield {"x": x[idx], "y": y[idx]}


def lm_batch_iterator(
    tokens: np.ndarray,
    *,
    batch_size: int,
    seq_len: int,
    seed: int = 0,
    epoch: int = 0,
) -> Iterator[dict]:
    """Random contiguous windows; targets are inputs shifted by one."""
    n = tokens.shape[0] - seq_len - 1
    if n < 0:
        raise ValueError(f"token stream too short: {tokens.shape[0]} for seq_len {seq_len}")
    rng = np.random.default_rng(seed * 100003 + epoch + 17)
    num_batches = max(1, n // (batch_size * seq_len))
    for _ in range(num_batches):
        # valid window starts are 0..n inclusive: start n reads tokens[n:n+S]
        # with labels tokens[n+1:n+S+1] ending on the final token
        starts = rng.integers(0, n + 1, size=batch_size)
        xs = np.stack([tokens[s : s + seq_len] for s in starts])
        ys = np.stack([tokens[s + 1 : s + seq_len + 1] for s in starts])
        yield {"tokens": xs.astype(np.int32), "labels": ys.astype(np.int32)}


def shard_batch(batch: dict, mesh, *, batch_axes: tuple[str, ...] = ("data",)) -> dict:
    """Place a host batch (numpy arrays or tensors, whole on every rank) on
    ``mesh`` as DTensors, the batch dim sharded over ``batch_axes`` (pod
    outer) and replicated when it does not divide. Each rank keeps its own
    shard: nothing is sent."""
    from repro_torch.launch.sharding import P, placements

    size = math.prod(mesh.shape[mesh.mesh_dim_names.index(a)] for a in batch_axes)

    def place(arr):
        t = arr if isinstance(arr, torch.Tensor) else torch.as_tensor(np.asarray(arr))
        spec = P(batch_axes) if t.shape[0] % size == 0 else P()
        return distribute_tensor(t, mesh, placements(spec, mesh.mesh_dim_names),
                                 src_data_rank=None)

    return tree_map(place, batch)
