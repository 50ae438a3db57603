"""Label-skew data partitioning (paper §4.1).

Procedure, verbatim from the paper:
  1. partition training examples into n mutually exclusive subsets by label
     (n = number of federated nodes); e.g. n=2 on MNIST → digits 0-4 vs 5-9.
  2. with probability ``s`` (the skew) an example is assigned to the node
     owning its label partition; with probability 1-s it goes to a uniformly
     random node.

s=0 → random split (iid); s=1 → full skew (no label overlap across nodes).
"""
from __future__ import annotations

import numpy as np


def label_partitions(labels: np.ndarray, num_nodes: int, num_classes: int) -> np.ndarray:
    """Map each class to its owning node: contiguous blocks of classes."""
    classes_per_node = num_classes / num_nodes
    owners = np.minimum((np.arange(num_classes) / classes_per_node).astype(np.int64), num_nodes - 1)
    return owners[labels]


def skewed_assignment(
    labels: np.ndarray,
    num_nodes: int,
    skew: float,
    *,
    num_classes: int | None = None,
    seed: int = 0,
) -> np.ndarray:
    """Node index per example under the paper's skew-s sampling."""
    if not 0.0 <= skew <= 1.0:
        raise ValueError(f"skew must be in [0,1], got {skew}")
    labels = np.asarray(labels)
    if num_classes is None:
        num_classes = int(labels.max()) + 1
    rng = np.random.default_rng(seed)
    owner = label_partitions(labels, num_nodes, num_classes)
    random_node = rng.integers(0, num_nodes, size=labels.shape[0])
    use_owner = rng.random(labels.shape[0]) < skew
    return np.where(use_owner, owner, random_node)


def partition_dataset(
    inputs: np.ndarray,
    labels: np.ndarray,
    num_nodes: int,
    skew: float,
    *,
    num_classes: int | None = None,
    seed: int = 0,
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Split (inputs, labels) into per-node shards under label skew."""
    assign = skewed_assignment(labels, num_nodes, skew, num_classes=num_classes, seed=seed)
    shards = []
    for node in range(num_nodes):
        idx = np.nonzero(assign == node)[0]
        shards.append((inputs[idx], labels[idx]))
    return shards


def partition_sequence_dataset(
    token_stream: np.ndarray, num_nodes: int, *, seed: int = 0
) -> list[np.ndarray]:
    """Contiguous document-level split for LM data (paper §4.4 splits the
    WikiText training set across nodes)."""
    n = token_stream.shape[0]
    bounds = np.linspace(0, n, num_nodes + 1).astype(np.int64)
    return [token_stream[bounds[i] : bounds[i + 1]] for i in range(num_nodes)]
