"""The port's encoder-decoder (seamless-m4t-medium) against the reference.

``repro_torch.models.encdec.EncDecLM`` is held against ``repro.models.encdec``
at ``reduced()`` in f32, with the reference's parameter layout drawn with
numpy (``np_params``) and carried across by ``load_jax_params``, and frames
and tokens from numpy seeds: the encoder memory, the teacher-forced logits,
the loss and every gradient leaf (with and without ``remat``), the decode
cache (cross K/V and the self-attention ring), bulk prefill and decode
steps, greedy serving (bulk == token-at-a-time loop), the cache-less prefill
probe, and the wire in both directions. Outputs are held at 1e-4 of their
largest magnitude, the reference's own f32 tolerance. Everything runs on the
CPU, where the attention ops take their plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import store as jstore
from repro.core.serialize import NodeUpdate as JNodeUpdate
from repro.launch.serve import serve_batch as jserve_batch
from repro.launch.steps import make_prefill_step as jmake_prefill_step
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.core import store as tstore
from repro_torch.core.serialize import NodeUpdate
from repro_torch.core.tree import as_numpy, tree_leaves
from repro_torch.launch import serve as tserve
from repro_torch.launch.serve import serve_batch, serve_batch_loop
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import EncDecLM, build_model, load_jax_params
from repro_torch.serving import ServingNode
from repro_torch.training import value_and_grad

from _torch_parity import assert_rel_close, np_params

ARCH = "seamless-m4t-medium"


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The tensors here are small: two intra-op threads do the work, and
    the suite's other workers keep the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _pair(seed=0):
    """(jax cfg, port cfg, numpy params in the reference's layout, port params)."""
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    params = np_params(jbuild_model(jcfg), seed)
    return jcfg, cfg, params, load_jax_params(build_model(cfg), params, device="cpu")


def _frames(cfg, B, T, seed=1):
    return (np.random.default_rng(seed).normal(size=(B, T, cfg.d_model)) * 0.5).astype(np.float32)


def _tokens(cfg, shape, seed=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape, dtype=np.int32)


def test_build_model_returns_the_encdec():
    cfg = get_config(ARCH)
    assert cfg.is_encdec and isinstance(build_model(cfg), EncDecLM)
    assert isinstance(build_model(cfg.reduced()), EncDecLM)


def test_encode_and_apply_match_reference():
    """The encoder memory (bidirectional: the last frame moves the first
    one's memory) and the teacher-forced logits at S = 16 over 24 frames."""
    jcfg, cfg, params, tparams = _pair()
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    frames, tokens = _frames(cfg, 2, 24), _tokens(cfg, (2, 16))
    jmem = jmodel.encode(params, jnp.asarray(frames))
    mem = model.encode(tparams, torch.from_numpy(frames))
    assert_rel_close(mem, jmem, "memory")
    moved = frames.copy()
    moved[:, -1] += 1.0
    assert not np.allclose(model.encode(tparams, torch.from_numpy(moved))[:, 0].numpy(),
                           mem[:, 0].numpy())
    jlogits, jaux = jmodel.apply(params, jnp.asarray(tokens), jnp.asarray(frames))
    logits, aux = model.apply(tparams, torch.from_numpy(tokens), torch.from_numpy(frames))
    assert logits.shape == (2, 16, cfg.padded_vocab)
    assert_rel_close(logits, jlogits, "logits")
    assert float(aux) == float(jaux) == 0.0


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_every_gradient_match_reference(remat):
    """``loss`` (CE over the valid vocab, accuracy) and every gradient leaf at
    1e-4 of its largest entry, with each layer recomputed under ``remat``."""
    jcfg, cfg, params, tparams = _pair(seed=1)
    toks = _tokens(cfg, (2, 17), seed=3)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "frames": _frames(cfg, 2, 12, seed=4)}
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    fn = jax.jit(jax.value_and_grad(lambda p, b: jmodel.loss(p, b, remat=remat), has_aux=True))
    (jl, jm), jg = fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    (tl, tm), tg = value_and_grad(lambda p, b: model.loss(p, b, remat=remat), tparams,
                                  {k: torch.from_numpy(v) for k, v in batch.items()})
    assert_rel_close(tl, jl, "loss")
    for key in ("ce", "accuracy"):
        assert_rel_close(tm[key], jm[key], key)
    leaves = jax.tree_util.tree_leaves_with_path(jg)
    assert len(leaves) == len(tree_leaves(tg))
    for (path, a), b in zip(leaves, tree_leaves(tg)):
        assert_rel_close(b, a, jax.tree_util.keystr(path))


def test_init_cache_prefill_and_decode_match_reference():
    """``init_cache``'s cross K/V and empty ring, the bulk prefill's logits
    and filled ring, then three decode steps."""
    jcfg, cfg, params, tparams = _pair(seed=2)
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    frames, prompts = _frames(cfg, 2, 20, seed=5), _tokens(cfg, (2, 10), seed=6)
    B, S = prompts.shape
    jcache = jmodel.init_cache(params, jnp.asarray(frames), capacity=S + 3)
    cache = model.init_cache(tparams, torch.from_numpy(frames), capacity=S + 3)
    assert cache["cross_k"].shape == (cfg.n_layers, B, 20, cfg.n_kv_heads, cfg.head_dim_)
    for key in ("cross_k", "cross_v"):
        assert_rel_close(cache[key], jcache[key], key)
    for key in ("k", "v", "slot_pos"):
        np.testing.assert_array_equal(cache["self"][key].numpy(), np.asarray(jcache["self"][key]))
    jl, jcache = jmodel.prefill(params, jnp.asarray(prompts), jcache)
    tl, cache = model.prefill(tparams, torch.from_numpy(prompts), cache)
    assert_rel_close(tl, jl, "prefill logits")
    for key in ("k", "v"):
        assert_rel_close(cache["self"][key], jcache["self"][key], f"self {key}")
    np.testing.assert_array_equal(cache["self"]["slot_pos"].numpy(),
                                  np.asarray(jcache["self"]["slot_pos"]))
    for step in range(3):
        tok = np.array(jnp.argmax(jl[:, : cfg.vocab_size], axis=-1), np.int32)
        jl, jcache = jmodel.decode_step(params, jnp.asarray(tok), jcache, jnp.int32(S + step))
        tl, cache = model.decode_step(tparams, torch.from_numpy(tok), cache, S + step)
        assert_rel_close(tl, jl, f"decode step {step}")


def test_decode_matches_apply_per_position_and_reference():
    """The twin of the reference's decode-vs-forward smoke test: 16 decode
    steps over 8 frames against ``apply`` at each position (its rtol = atol
    = 2e-2), and against the reference's own ``decode_step`` at 1e-4."""
    jcfg, cfg, params, tparams = _pair(seed=3)
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    frames, tokens = _frames(cfg, 2, 8, seed=7), _tokens(cfg, (2, 16), seed=8)
    full, _ = model.apply(tparams, torch.from_numpy(tokens), torch.from_numpy(frames))
    cache = model.init_cache(tparams, torch.from_numpy(frames), capacity=16)
    jcache = jmodel.init_cache(params, jnp.asarray(frames), capacity=16)
    for t in range(16):
        logits, cache = model.decode_step(tparams, torch.from_numpy(tokens[:, t]), cache, t)
        jlogits, jcache = jmodel.decode_step(params, jnp.asarray(tokens[:, t]), jcache,
                                             jnp.int32(t))
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(), rtol=2e-2, atol=2e-2,
                                   err_msg=f"step {t}")
        assert_rel_close(logits, jlogits, f"step {t} vs reference")


def test_serve_batch_matches_loop_and_reference():
    """Greedy continuations: the bulk prefill equals the token-at-a-time
    loop (the twin of the reference's enc-dec bulk-vs-loop case) and the
    reference's ``serve_batch``."""
    jcfg, cfg, params, tparams = _pair(seed=4)
    prompts, frames = _tokens(cfg, (2, 8), seed=9), _frames(cfg, 2, 16, seed=10)
    fast = serve_batch(cfg, tparams, prompts, new_tokens=6, frames=frames).numpy()
    slow = serve_batch_loop(cfg, tparams, prompts, new_tokens=6, frames=frames).numpy()
    ref = np.asarray(jserve_batch(jcfg, params, jnp.asarray(prompts), new_tokens=6,
                                  frames=jnp.asarray(frames)))
    assert fast.dtype == np.int32 and fast.shape == (2, 6)
    np.testing.assert_array_equal(fast, slow)
    np.testing.assert_array_equal(fast, ref)


def test_prefill_step_probe_matches_reference():
    """The cache-less probe: next token and last-position logits."""
    jcfg, cfg, params, tparams = _pair(seed=5)
    batch = {"tokens": _tokens(cfg, (2, 12), seed=11), "frames": _frames(cfg, 2, 10, seed=12)}
    jtok, jlast = jmake_prefill_step(jcfg)(params, {k: jnp.asarray(v) for k, v in batch.items()})
    tok, last = make_prefill_step(cfg)(tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert_rel_close(last, jlast, "last logits")
    assert tok.dtype == torch.int32
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


def test_blobs_cross_packages_both_ways(tmp_path):
    """A torch node's enc-dec deposit decodes in a JAX store to the same
    values and ``LeafSpec.key``, and the reverse holds too."""
    _, cfg, _, tparams = _pair(seed=6)
    jparams = np_params(jbuild_model(jget_config(ARCH).reduced()), 7)
    tstore_ = tstore.WeightStore(tstore.DiskFolder(str(tmp_path)))
    jstore_ = jstore.WeightStore(jstore.DiskFolder(str(tmp_path)))
    tstore_.push(NodeUpdate(tparams, 3, "torch", counter=1))
    jstore_.push(JNodeUpdate(jparams, 5, "jax", counter=2))
    j_pulled = {u.node_id: u for u in jstore_.pull()}
    t_pulled = {u.node_id: u for u in tstore_.pull()}
    for node in ("torch", "jax"):
        a, b = j_pulled[node], t_pulled[node]
        assert a.spec.key == b.spec.key and a.spec.paths == b.spec.paths
        np.testing.assert_array_equal(a.flat, b.flat)
        assert (a.num_examples, a.counter) == (b.num_examples, b.counter)
    np.testing.assert_array_equal(
        j_pulled["torch"].flat,
        np.concatenate([as_numpy(t).ravel() for t in tree_leaves(tparams)]))
    np.testing.assert_array_equal(
        t_pulled["jax"].flat, np.concatenate([a.ravel() for a in jax.tree.leaves(jparams)]))
    back = load_jax_params(build_model(cfg), t_pulled["jax"].params, device="cpu")
    for got, want in zip(tree_leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(got.numpy(), want)


def test_serving_node_rejects_the_encdec_by_the_references_design():
    with pytest.raises(ValueError, match="reference's design"):
        ServingNode(tstore.WeightStore(tstore.InMemoryFolder()), get_config(ARCH).reduced(),
                    device="cpu")


def test_serve_main_feeds_the_encdec_stub_frames(capsys):
    """``python -m repro_torch.launch.serve --arch seamless-m4t-medium`` on
    the CPU: 64 stub frames per prompt, greedy continuations printed."""
    argv = ["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len", "4",
            "--new-tokens", "3", "--device", "cpu"]
    assert tserve.main(argv) == 0
    out = capsys.readouterr().out
    assert f"arch={ARCH}-reduced batch=2" in out and "continuations:" in out
