"""Child-process targets of the port's process tests (tests/test_torch_processes.py,
tests/test_torch_fleet.py).

Spawn pickles a target by its module and name, and each child imports that
module afresh, so the targets live here: a module that imports neither JAX
nor the JAX package at top level (a child of the torch side never pays for
JAX's import). The one JAX child imports ``repro`` inside its function.
"""
import time

import numpy as np


def returns_value(x):
    return x * 2


def raises():
    raise ValueError("injected failure")


def hangs_forever():
    while True:
        time.sleep(0.1)


def sleeps_then_returns(delay, value):
    time.sleep(delay)
    return value


def resumable_client(directory, node_id, epochs, die_after_pushes=None):
    """Crash-and-restart torch client (CPU): reports whether it bootstrapped
    from its own latest/ blob and where its counter started. With
    ``die_after_pushes`` it parks mid-training so the SIGKILL lands
    deterministically."""
    import torch

    from repro_torch.core import AsyncFederatedNode, DiskFolder
    from repro_torch.core.strategies import FedAvg

    node = AsyncFederatedNode(strategy=FedAvg(device="cpu"), shared_folder=DiskFolder(directory),
                              node_id=node_id)
    start_counter = node.counter
    resumed_from = None if node.resumed is None else float(node.resumed.params["w"][0])
    w = (torch.as_tensor(np.asarray(node.resumed.params["w"])) if node.resumed is not None
         else torch.zeros(4))
    for _ in range(epochs):
        w = w + 1.0  # local "training": counts total progress
        aggregated = node.update_parameters({"w": w}, num_examples=5)
        if aggregated is not None:
            w = aggregated["w"]
        if die_after_pushes is not None and node.num_pushes >= die_after_pushes:
            while True:  # park mid-training until the SIGKILL arrives
                time.sleep(0.05)
    return {"start_counter": start_counter, "resumed_from": resumed_from,
            "final_counter": node.counter, "w0": float(w[0])}


def sync_client(package, directory, node_id, target, num_nodes, rounds):
    """A quadratic-consensus ``SyncFederatedNode`` of either package on a
    ``DiskFolder``: local step toward ``target``, then the barrier round.
    Returns the final weights."""
    if package == "jax":
        from repro.core import DiskFolder, SyncFederatedNode
        from repro.core.strategies import FedAvg

        strategy = FedAvg()
    else:
        from repro_torch.core import DiskFolder, SyncFederatedNode
        from repro_torch.core.strategies import FedAvg

        strategy = FedAvg(device="cpu")
    return sync_rounds(SyncFederatedNode(num_nodes=num_nodes, timeout=120.0, strategy=strategy,
                                         shared_folder=DiskFolder(directory), node_id=node_id),
                       target, rounds)


def sync_rounds(node, target, rounds):
    w = np.zeros(6, np.float32)
    for r in range(rounds):
        w = w + np.float32(0.3) * (np.float32(target) - w)
        out = node.update_parameters({"w": w}, num_examples=2 + r)
        w = np.array(out["w"], np.float32)  # a jax array or a CPU tensor
    return w.tolist()
