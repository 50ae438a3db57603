"""The port's LM and serving tier against the reference.

Configs, parameter layouts (``LeafSpec.key`` at full size, no allocation),
prefill/decode logits and greedy tokens of the port's ``DecoderLM`` are held
against ``repro``'s on reduced f32 configs, with the reference's weights
carried across by ``load_jax_params``. The serving tier is checked as the
reference's own tests check it (hot swap without a torn read, restart resume,
incompatible updates skipped, stats keys, the ``api.serve`` facade), and as a
mixed fleet: a JAX node pushes to a disk folder and the port's and the
reference's serving nodes serve the same tokens from it. Everything runs on
the CPU (``device="cpu"``), where the attention ops take their plain versions.
"""
import dataclasses
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import store as jstore
from repro.core.serialize import NodeUpdate as JNodeUpdate
from repro.core.tree import LeafSpec as JLeafSpec
from repro.launch.serve import serve_batch as jserve_batch
from repro.models import build_model as jbuild_model
from repro.serving import ServingNode as JServingNode
from repro_torch import api
from repro_torch.configs import ARCH_IDS, PAPER_IDS, get_config
from repro_torch.core.serialize import NodeUpdate
from repro_torch.core.store import DiskFolder, InMemoryFolder, WeightStore
from repro_torch.core.tree import LeafSpec, tree_leaves, tree_map
from repro_torch.launch.serve import serve_batch, serve_batch_loop
from repro_torch.models import build_model, load_jax_params
from repro_torch.serving import ServingNode, StoreWatcher

from _torch_parity import np_params

PORTED = ["granite-3-2b", "pythia-14m", "mamba2-130m", "recurrentgemma-9b", "minicpm3-4b",
          "llama4-scout-17b-a16e", "grok-1-314b", "internvl2-1b", "seamless-m4t-medium"]
# the enc-dec takes frames besides tokens: its logits and tokens are held in
# tests/test_torch_encdec.py
DECODERS = [arch for arch in PORTED if arch != "seamless-m4t-medium"]


def _push(store, params, *, counter, node_id="trainer-0"):
    store.push(NodeUpdate(params=params, num_examples=1, node_id=node_id,
                          counter=counter, timestamp=time.time()))


def _pair(arch: str, seed: int = 0, dtype: str | None = None):
    """(jax cfg, port cfg, numpy params in the reference's layout, port params)."""
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    params = np_params(jbuild_model(jcfg), seed)
    if dtype:
        jcfg, cfg = jcfg.replace(dtype=dtype), cfg.replace(dtype=dtype)
        params = jax.tree.map(lambda x: np.asarray(jnp.asarray(x, dtype)), params)
    return jcfg, cfg, params, load_jax_params(build_model(cfg), params, device="cpu")


def _prompts(cfg, seed=1, shape=(2, 8)):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape, dtype=np.int32)


# ---------------------------------------------------------------------------
# configs and layouts
# ---------------------------------------------------------------------------


# the port's own fields (granite-4.0-h's NoPE and multipliers), which the
# reference's ModelConfig lacks: every shared config holds them at their defaults
PORT_FIELDS = {"position_embedding": "rope", "embedding_multiplier": 0.0,
               "attention_multiplier": 0.0, "residual_multiplier": 1.0, "logits_scaling": 1.0}


def _shared_fields(port) -> dict:
    d = dataclasses.asdict(port)
    assert {k: d.pop(k) for k in PORT_FIELDS} == PORT_FIELDS
    return d


@pytest.mark.parametrize("arch", ARCH_IDS + PAPER_IDS)
def test_configs_match_reference(arch):
    port, ref = get_config(arch), jget_config(arch)
    assert _shared_fields(port) == dataclasses.asdict(ref)
    assert _shared_fields(port.reduced()) == dataclasses.asdict(ref.reduced())
    assert (port.head_dim_, port.padded_vocab, port.pattern) == (ref.head_dim_, ref.padded_vocab,
                                                                 ref.pattern)


@pytest.mark.parametrize("arch", PORTED)
def test_leafspec_key_matches_reference_at_full_size(arch):
    """The full-size layout, bf16 leaves included, from meta tensors and
    ``jax.eval_shape``: no weights are allocated."""
    jmodel = jbuild_model(jget_config(arch))
    ref = JLeafSpec.of(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0)))
    port = LeafSpec.of(build_model(get_config(arch)).abstract())
    assert port.paths == ref.paths and port.shapes == ref.shapes
    assert list(port.dtypes) == [d.name for d in ref.dtypes]
    assert port.key == ref.key and port.num_params == ref.num_params


def test_random_init_has_the_reference_layout():
    cfg = get_config("granite-3-2b").reduced()
    model = build_model(cfg)
    params = model.init(3, device="cpu")
    assert LeafSpec.of(params).key == LeafSpec.of(model.abstract()).key
    again = model.init(3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params), tree_leaves(again)))


# ---------------------------------------------------------------------------
# the model: logits and tokens
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_and_decode_logits_match_reference(arch):
    jcfg, cfg, params, tparams = _pair(arch)
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    prompts = _prompts(cfg)
    B, S = prompts.shape
    jlogits, _ = jmodel.apply(params, jnp.asarray(prompts))
    tlogits, _ = model.apply(tparams, torch.from_numpy(prompts))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)

    jl, jcache = jmodel.prefill(params, jnp.asarray(prompts), jmodel.init_cache(B, S + 3))
    tl, tcache = model.prefill(tparams, torch.from_numpy(prompts),
                               model.init_cache(B, S + 3, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    for step in range(3):
        tok = np.array(jnp.argmax(jl[:, : cfg.vocab_size], axis=-1), np.int32)
        jl, jcache = jmodel.decode_step(params, jnp.asarray(tok), jcache, jnp.int32(S + step))
        tl, tcache = model.decode_step(tparams, torch.from_numpy(tok), tcache, S + step)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4,
                                   err_msg=f"decode step {step}")


@pytest.mark.parametrize("arch", DECODERS)
def test_serve_batch_matches_loop_and_reference(arch):
    jcfg, cfg, params, tparams = _pair(arch, seed=2)
    prompts = _prompts(cfg, seed=3)
    fast = serve_batch(cfg, tparams, prompts, new_tokens=6).numpy()
    slow = serve_batch_loop(cfg, tparams, prompts, new_tokens=6).numpy()
    ref = np.asarray(jserve_batch(jcfg, params, jnp.asarray(prompts), new_tokens=6))
    assert fast.dtype == np.int32 and fast.shape == (2, 6)
    np.testing.assert_array_equal(fast, slow)
    np.testing.assert_array_equal(fast, ref)


# ---------------------------------------------------------------------------
# ServingNode: a mixed fleet, bf16 without ml_dtypes, hot swap, restart
# ---------------------------------------------------------------------------


def test_mixed_fleet_serves_the_reference_nodes_tokens(tmp_path):
    """A JAX trainer pushes to a disk folder; the port's ServingNode and the
    reference's serve identical tokens from it, before and after an update."""
    jcfg, cfg, params, _ = _pair("granite-3-2b", seed=4)
    writer = jstore.WeightStore(jstore.DiskFolder(str(tmp_path)))
    writer.push(JNodeUpdate(params, 1, "jax-trainer", counter=0, timestamp=time.time()))
    port = ServingNode(WeightStore(DiskFolder(str(tmp_path))), cfg, device="cpu")
    ref = JServingNode(jstore.WeightStore(jstore.DiskFolder(str(tmp_path))), jcfg)
    prompts = _prompts(cfg, seed=5, shape=(3, 10))
    for counter in (0, 1):
        if counter:
            params = jax.tree.map(lambda x: -x, params)
            writer.push(JNodeUpdate(params, 1, "jax-trainer", counter=1, timestamp=time.time()))
        assert port.poll_once() and ref.poll_once()
        got, meta = port.generate(prompts, new_tokens=5)
        want, jmeta = ref.generate(prompts, new_tokens=5)
        np.testing.assert_array_equal(got, want)
        assert meta["counter"] == jmeta["counter"] == counter
        assert meta["source"] == "jax-trainer"


def test_bf16_push_deploys_without_ml_dtypes(tmp_path, monkeypatch):
    """A JAX node's bf16 weights deploy in the port with ``ml_dtypes`` hidden
    from it (the card's machine has none), and a port node's bf16 push reads
    back in the reference."""
    _, cfg, jparams, _ = _pair("granite-3-2b", seed=6, dtype="bfloat16")
    jstore.WeightStore(jstore.DiskFolder(str(tmp_path))).push(
        JNodeUpdate(jparams, 1, "jax", counter=0, timestamp=time.time()))
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "ml_dtypes", None)
        node = ServingNode(WeightStore(DiskFolder(str(tmp_path))), cfg, device="cpu")
        assert node.poll_once()
        deployed = node._deployed.params
        assert deployed["embed"]["table"].dtype == torch.bfloat16
        for got, want in zip(jax.tree.leaves(deployed), jax.tree.leaves(jparams)):
            np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))
        out, meta = node.generate(_prompts(cfg), new_tokens=3)
        assert out.shape == (2, 3) and ((out >= 0) & (out < cfg.vocab_size)).all()
        _push(WeightStore(DiskFolder(str(tmp_path))), tree_map(lambda t: -t, deployed),
              counter=1, node_id="torch")
    back = {u.node_id: u for u in jstore.WeightStore(jstore.DiskFolder(str(tmp_path))).pull()}
    assert back["torch"].spec.key == JLeafSpec.of(jparams).key == node.spec.key
    np.testing.assert_array_equal(back["torch"].flat, -back["jax"].flat)


@pytest.fixture(scope="module")
def smoke():
    """pythia-14m reduced: the reference's serving smoke config."""
    _, cfg, _, tparams = _pair("pythia-14m", seed=0)
    return cfg, tparams


def test_hot_swap_no_torn_read(smoke):
    """A swap landing mid-batch must not affect that batch (snapshot
    semantics), and the NEXT batch must run on the new weights."""
    cfg, params_a = smoke
    params_b = tree_map(lambda x: -x, params_a)
    store = WeightStore(InMemoryFolder())
    _push(store, params_a, counter=0)
    node = ServingNode(store, cfg, device="cpu")  # no watcher thread: manual polls
    assert node.poll_once()
    prompts = _prompts(cfg)
    expected_a, _ = node.generate(prompts, new_tokens=6)

    def swap_mid_batch(t):
        if t == 2:
            _push(store, params_b, counter=1)
            assert node.poll_once()

    mid, meta = node.generate(prompts, new_tokens=6, on_token=swap_mid_batch)
    assert node.stats()["swaps"] == 2
    assert meta["counter"] == 0  # the batch kept its snapshot
    np.testing.assert_array_equal(mid, expected_a)

    after, meta = node.generate(prompts, new_tokens=6)
    assert meta["counter"] == 1
    expected_b = serve_batch(cfg, params_b, prompts, new_tokens=6).numpy()
    np.testing.assert_array_equal(after, expected_b)
    assert not np.array_equal(expected_a, expected_b)
    # a third swap reuses the first buffer's device leaves, in place
    leaves = node._dev_leaves[0]
    _push(store, params_a, counter=2)
    assert node.poll_once() and node._dev_leaves[0] is leaves
    np.testing.assert_array_equal(node.generate(prompts, new_tokens=6)[0], expected_a)


def test_restart_resumes_from_latest(smoke):
    cfg, params = smoke
    folder = InMemoryFolder()
    _push(WeightStore(folder), params, counter=7)
    node1 = ServingNode(WeightStore(folder), cfg, device="cpu")
    assert node1.poll_once()
    assert node1.stats()["counter"] == 7
    # a fresh node against the same folder deploys from latest/ with no new
    # pushes — serving restarts are stateless
    node2 = ServingNode(WeightStore(folder), cfg, device="cpu")
    assert node2.poll_once()
    assert node2.stats()["counter"] == 7 and node2.stats()["deployed"]


def test_incompatible_updates_skipped(smoke):
    cfg, _ = smoke
    other = np_params(jbuild_model(jget_config("mamba2-130m").reduced()), 0)
    store = WeightStore(InMemoryFolder())
    _push(store, other, counter=3)
    node = ServingNode(store, cfg, device="cpu")
    assert not node.poll_once()
    assert not node.stats()["deployed"]
    assert node.watcher.skipped_incompatible >= 1
    # incompatible counters still drive the staleness reference
    assert node.watcher.last_max_counter == 3
    with pytest.raises(RuntimeError, match="no weights deployed"):
        node.generate(np.zeros((1, 4), np.int32), new_tokens=2)


def test_watcher_picks_freshest_and_dedups(smoke):
    cfg, params = smoke
    store = WeightStore(InMemoryFolder())
    _push(store, params, counter=0, node_id="a")
    _push(store, params, counter=5, node_id="b")
    watcher = StoreWatcher(store, spec=LeafSpec.of(build_model(cfg).abstract()))
    dep = watcher.poll()
    assert dep is not None and dep.source == "b" and dep.counter == 5
    assert watcher.poll() is None  # unchanged store -> no redeploy
    _push(store, params, counter=6, node_id="a")
    dep = watcher.poll()
    assert dep is not None and dep.source == "a" and dep.counter == 6


def test_serving_node_rejects_encdec():
    with pytest.raises(ValueError, match="decoder-only"):
        ServingNode(WeightStore(InMemoryFolder()), "seamless-m4t-medium", reduced=True,
                    device="cpu")


def test_stats_keys(smoke):
    cfg, _ = smoke
    node = ServingNode(WeightStore(InMemoryFolder()), cfg, device="cpu")
    ref = JServingNode(jstore.WeightStore(jstore.InMemoryFolder()), jget_config("pythia-14m"),
                       reduced=True)
    stats = node.stats()
    assert stats.keys() == ref.stats().keys()
    assert not stats["deployed"] and stats["counter"] == -1


def test_api_serve_facade(smoke):
    cfg, params = smoke
    _push(api.connect("memory://t-torch-serve-facade"), params, counter=0)
    node = api.serve("memory://t-torch-serve-facade", cfg, poll_interval=0.02, wait=30.0,
                     device="cpu")
    try:
        assert node.stats()["deployed"]
        out, meta = node.generate(np.zeros((1, 4), np.int32), new_tokens=3)
        assert out.shape == (1, 3) and meta["counter"] == 0
    finally:
        node.stop()
