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


def mesh_serving_rank(rank, world, model_axis, root, archs, new_tokens):
    """One rank of a gloo ``(world // model_axis, model_axis)`` mesh. For each
    arch: serve the reference's weights, pushed to ``root/<arch>/store``,
    through ``ServingNode(mesh=)`` and through ``serve_batch`` on DTensor
    weights loaded from ``root/<arch>/params.npz``; write the tokens and the
    prefill logits (whole, as every rank sees them) to
    ``root/<arch>/rank<r>.npz``. Also records ``shard_batch``'s placements and
    whether a DTensor handed to a kernel op raised."""
    import json

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import DiskFolder
    from repro_torch.core.store import WeightStore
    from repro_torch.core.tree import LeafSpec, tree_unflatten
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch.mesh import data_axes, make_host_mesh, start_group
    from repro_torch.launch.serve import serve_batch
    from repro_torch.launch.sharding import distribute, param_shardings, serve_cache_shardings
    from repro_torch.models import build_model
    from repro_torch.models.common import load_jax_params
    from repro_torch.models.sharded import serving_mode
    from repro_torch.serving import ServingNode

    torch.set_num_threads(1)
    start_group(f"{root}/pg", rank=rank, world_size=world, device="cpu")
    try:
        mesh = make_host_mesh(model_axis, device_type="cpu")
        for arch in archs:
            d = f"{root}/{arch}"
            cfg = get_config(arch).reduced()
            model = build_model(cfg)
            prompts = np.load(f"{d}/prompts.npy")
            node = ServingNode(WeightStore(DiskFolder(f"{d}/store")), cfg, mesh=mesh,
                               device="cpu")
            assert node.poll_once()
            node_tokens, _ = node.generate(prompts, new_tokens=new_tokens)
            with np.load(f"{d}/params.npz") as z:
                leaves = [z[f"arr_{i}"] for i in range(len(z.files))]
            tree = tree_unflatten(LeafSpec.of(model.abstract()).treedef, leaves)
            params = load_jax_params(model, tree, device="cpu")
            dparams = distribute(params, param_shardings(params, mesh))
            batch_tokens = serve_batch(cfg, dparams, prompts, new_tokens=new_tokens).numpy()
            B, S = prompts.shape
            cache = model.init_cache(B, S + 1, device="cpu")
            cache = distribute(cache, serve_cache_shardings(cache, mesh))
            toks = shard_batch({"t": prompts}, mesh, batch_axes=data_axes(mesh))["t"]
            with serving_mode(dparams):
                logits, _ = model.prefill(dparams, toks, cache)
            np.savez(f"{d}/rank{rank}.npz", node=node_tokens, batch=batch_tokens,
                     logits=logits.full_tensor().numpy())
        # shard_batch: the batch dim over the data axes where it divides
        odd = shard_batch({"even": np.zeros((2 * mesh.size(0), 3), np.int32),
                           "odd": np.zeros((2 * mesh.size(0) + 1, 3), np.int32)}, mesh)
        placed = {k: [str(p) for p in v.placements] for k, v in odd.items()}
        # a DTensor handed to a kernel op outside local_map
        q = distribute({"q": torch.zeros(2, 4, 2, 1, 32)}, param_shardings(
            {"q": torch.zeros(2, 4, 2, 1, 32)}, mesh))["q"]
        raised = {}
        for name, call in (("flash_attention", lambda: flash_ops.flash_attention(q, q[:, :, :, 0],
                                                                                  q[:, :, :, 0])),
                           ("decode_attention", lambda: dec_ops.decode_attention(
                               q[:, :1], q[:, :, :, 0], q[:, :, :, 0], torch.ones(4, dtype=bool))),
                           ("ssd_scan", lambda: ssd_ops.ssd(q[..., 0, :], q[..., 0, 0],
                                                            q[:, :, 0, 0], q[:, :, 0, 0]))):
            try:
                call()
                raised[name] = False
            except TypeError as e:
                raised[name] = "local_map" in str(e)
        with open(f"{root}/extra{rank}.json", "w") as f:
            json.dump({"mesh": list(mesh.shape), "shard_batch": placed, "raised": raised}, f)
    finally:
        dist.destroy_process_group()


def mesh_cuda_rank(rank, root, arch):
    """The one rank of a world-1 NCCL mesh on the card: serve ``arch``'s
    reduced config (bf16 weights from a seed, pushed to a memory store)
    through ``ServingNode(mesh=)`` and without a mesh; write both token sets
    and the mesh run's kernel launches to ``root/mesh_cuda.json``."""
    import json

    import torch
    import torch.distributed as dist

    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.core.serialize import NodeUpdate
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.launch.mesh import make_host_mesh, start_group
    from repro_torch.models import build_model

    start_group(f"{root}/pg", rank=rank, world_size=1, device="cuda")
    try:
        cfg = get_config(arch).reduced().replace(dtype="bfloat16")
        params = build_model(cfg).init(0, device="cuda")
        store = api.connect(f"memory://mesh-cuda-{arch}")
        store.push(NodeUpdate(params=params, num_examples=1, node_id="t", counter=0))
        prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 40), dtype=np.int32)
        new = 8
        plain = api.serve(store, cfg, start=False)
        assert plain.poll_once()
        meshless, _ = plain.generate(prompts, new_tokens=new)
        node = api.serve(store, cfg, mesh=make_host_mesh(), start=False)
        assert node.poll_once()
        for k in (fk, dk, sk):
            k.reset_launches()
        tokens, _ = node.generate(prompts, new_tokens=new)
        torch.cuda.synchronize()
        launches = {**fk.LAUNCHES, **dk.LAUNCHES, **sk.LAUNCHES}
        L = cfg.n_layers
        want = ({"flash_attention": 0, "decode_attention": 0, "ssd_scan": L} if cfg.ssm_state
                else {"flash_attention": L, "decode_attention": L * (new - 1), "ssd_scan": 0})
        with open(f"{root}/mesh_cuda.json", "w") as f:
            json.dump({"tokens": tokens.tolist(), "meshless_tokens": meshless.tolist(),
                       "launches": launches, "want_launches": want}, f)
    finally:
        dist.destroy_process_group()


def mesh_decode_rank(rank, root):
    """The one rank of a world-1 gloo mesh: serve mamba2-130m ``reduced()``
    through ``ServingNode(mesh=)`` on the CPU and write whether the node
    could replay a decode graph, the graphs it holds, its span names and its
    counters to ``root/mesh_decode.json``."""
    import json

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import Telemetry
    from repro_torch.core.serialize import NodeUpdate
    from repro_torch.core.store import InMemoryFolder, WeightStore
    from repro_torch.launch.mesh import make_host_mesh, start_group
    from repro_torch.models import build_model
    from repro_torch.serving import ServingNode

    start_group(f"{root}/pg", rank=rank, world_size=1, device="cpu")
    try:
        cfg = get_config("mamba2-130m").reduced()
        store = WeightStore(InMemoryFolder())
        store.push(NodeUpdate(params=build_model(cfg).init(0, device="cpu"), num_examples=1,
                              node_id="t", counter=0))
        tel = Telemetry("server", enabled=True, flush_every=10**9)
        node = ServingNode(store, cfg, mesh=make_host_mesh(device_type="cpu"), telemetry=tel,
                           device="cpu")
        assert node.poll_once()
        prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 9), dtype=np.int32)
        node.generate(prompts, new_tokens=4)
        with open(f"{root}/mesh_decode.json", "w") as f:
            json.dump({"graphable": node._graphable, "graphs": len(node._graphs),
                       "spans": sorted({r.name for r in tel.recorder.drain_records()}),
                       "counters": tel.snapshot()["counters"]}, f)
    finally:
        dist.destroy_process_group()
