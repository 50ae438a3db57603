"""Checkpointing: pytree ↔ npz files (the port of ``repro.checkpoint``).

Same wire format as the weight store (key-path keyed npz), so a federated
node can bootstrap directly from a checkpoint, a checkpoint can be deposited
into a store, and either package loads the other's files. Writes are atomic
(tmp + rename) and keep a bounded number of retained steps.
"""
from __future__ import annotations

import os
import re
import tempfile

import numpy as np
import torch

from repro_torch.core.serialize import deserialize_params, serialize_params
from repro_torch.core.tree import PyTree, tree_map
from repro_torch.kernels import resolve_device

_CKPT_RE = re.compile(r"^step_(\d+)\.npz$")


def save_checkpoint(directory: str, step: int, params: PyTree, *, extra: dict | None = None,
                    keep: int = 3) -> str:
    """Write ``params`` (tensors on any device, or numpy) as
    ``step_<step>.npz`` and drop all but the newest ``keep`` steps."""
    os.makedirs(directory, exist_ok=True)
    blob = serialize_params(params, meta={"step": int(step), **(extra or {})})
    path = os.path.join(directory, f"step_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)
    _gc(directory, keep)
    return path


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for name in os.listdir(directory) if (m := _CKPT_RE.match(name))]
    return max(steps) if steps else None


def load_checkpoint(directory: str, step: int | None = None, *,
                    device: "str | torch.device | None" = None) -> tuple[PyTree, dict]:
    """-> (params, meta) of ``step`` (default: the newest). Leaves are CPU
    tensors, or tensors on ``device`` when it is given."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:08d}.npz")
    with open(path, "rb") as f:
        tree, meta = deserialize_params(f.read())

    dev = None if device is None else resolve_device(device)

    def leaf(x):
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
        return t if dev is None else t.to(dev)

    return tree_map(leaf, tree), meta


def _gc(directory: str, keep: int) -> None:
    names = sorted(n for n in os.listdir(directory) if _CKPT_RE.match(n))
    for name in names[:-keep] if keep > 0 else []:
        os.unlink(os.path.join(directory, name))
