"""Serving on a device mesh, on the CPU: gloo worlds of 2 and 4 spawned
processes (a ``FileStore`` under ``tmp_path``; no network), meshes (1, 2),
(2, 1) and (2, 2).

granite-3-2b and mamba2-130m ``reduced()`` (4 heads, 4 KV heads) serve the
reference's weights on every rank through ``ServingNode(mesh=)`` and through
``serve_batch`` on DTensor weights. Their greedy tokens must equal the
one-process port's and the reference's ``serve_batch``, and their prefill
logits the one-process port's within 1e-5 of the largest. Each child also
reports ``shard_batch``'s placements and whether a DTensor handed to a kernel
op outside ``local_map`` raised. Children are torch only (JAX stays here).
"""
import json
import time

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp

import _torch_children as kids
from repro.configs import get_config as jget_config
from repro.core import store as jstore
from repro.core.serialize import NodeUpdate as JNodeUpdate
from repro.launch.serve import serve_batch as jserve_batch
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.launch.serve import serve_batch
from repro_torch.models import build_model, load_jax_params

from _torch_parity import np_params

ARCHS = ("granite-3-2b", "mamba2-130m")
NEW_TOKENS = 6
CHILD_TIMEOUT_S = 240


def _spawn(world: int, model_axis: int, root: str) -> None:
    ctx = tmp.start_processes(kids.mesh_serving_rank,
                              args=(world, model_axis, root, ARCHS, NEW_TOKENS),
                              nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + CHILD_TIMEOUT_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"mesh children still running after {CHILD_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)


@pytest.mark.parametrize("world,model_axis", [(2, 2), (2, 1), (4, 2)],
                         ids=["mesh1x2", "mesh2x1", "mesh2x2"])
def test_mesh_serving_matches_one_process_and_reference(tmp_path, world, model_axis):
    root = str(tmp_path)
    want = {}
    for i, arch in enumerate(ARCHS):
        d = tmp_path / arch
        d.mkdir()
        jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
        params = np_params(jbuild_model(jcfg), i)
        prompts = np.random.default_rng(i + 1).integers(0, cfg.vocab_size, (4, 12),
                                                        dtype=np.int32)
        np.save(d / "prompts.npy", prompts)
        np.savez(d / "params.npz", *jax.tree.leaves(params))
        jstore.WeightStore(jstore.DiskFolder(str(d / "store"))).push(
            JNodeUpdate(params, 1, "jax-trainer", counter=0, timestamp=time.time()))
        model = build_model(cfg)
        port_params = load_jax_params(model, params, device="cpu")
        tokens = serve_batch(cfg, port_params, prompts, new_tokens=NEW_TOKENS).numpy()
        ref = np.asarray(jserve_batch(jcfg, params, prompts, new_tokens=NEW_TOKENS))
        np.testing.assert_array_equal(tokens, ref)
        with torch.inference_mode():
            cache = model.init_cache(prompts.shape[0], prompts.shape[1] + 1, device="cpu")
            logits, _ = model.prefill(port_params, torch.from_numpy(prompts), cache)
        want[arch] = tokens, logits.numpy()

    _spawn(world, model_axis, root)

    for arch, (tokens, logits) in want.items():
        for r in range(world):
            with np.load(tmp_path / arch / f"rank{r}.npz") as z:
                np.testing.assert_array_equal(z["node"], tokens, err_msg=f"{arch} rank {r}")
                np.testing.assert_array_equal(z["batch"], tokens, err_msg=f"{arch} rank {r}")
                err = np.abs(z["logits"] - logits).max() / np.abs(logits).max()
                assert err <= 1e-5, (arch, r, err)
    data = world // model_axis
    for r in range(world):
        extra = json.loads((tmp_path / f"extra{r}.json").read_text())
        assert extra["mesh"] == [data, model_axis]
        shard0 = "S(0)"
        assert extra["shard_batch"]["even"] == [shard0, "R"]
        assert extra["shard_batch"]["odd"] == ["R" if data > 1 else shard0,
                                               "R"]
        assert extra["raised"] == {"flash_attention": True, "decode_attention": True,
                                   "ssd_scan": True}
