"""The port's VLM prefix path (internvl2-1b) and modality frontends against
the reference.

``DecoderLM`` with ``extra_embeds`` (stub patch embeddings in front of the
token embeddings) is held against ``repro.models.transformer`` at
``reduced()`` in f32 (16 patches), with the reference's parameter layout
drawn with numpy and carried across by ``load_jax_params``: logits of the
text positions only, the loss and every gradient leaf, the bulk prefill over
prefix + prompt and the decode steps past it, greedy serving with
``embeds=``, and the cache-less prefill probe; at 1e-4 of the largest
magnitude. The frontend stubs (``models.frontends``) give the reference's
shapes and dtypes, a 0.02 scale, and the same draw for the same seed.
Everything runs on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch.serve import serve_batch as jserve_batch
from repro.launch.steps import make_prefill_step as jmake_prefill_step
from repro.models import build_model as jbuild_model
from repro.models import frontends as jfrontends
from repro_torch.configs import get_config
from repro_torch.core.tree import tree_leaves
from repro_torch.launch.serve import serve_batch
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import build_model, frontends, load_jax_params
from repro_torch.training import value_and_grad

from _torch_parity import assert_rel_close, np_params

ARCH = "internvl2-1b"


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _pair(seed=0):
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    params = np_params(jbuild_model(jcfg), seed)
    return jcfg, cfg, params, load_jax_params(build_model(cfg), params, device="cpu")


def _embeds(cfg, B, seed=1):
    """(B, frontend_tokens, d_model) patch embeddings at a visible scale."""
    shape = (B, cfg.frontend_tokens, cfg.d_model)
    return (np.random.default_rng(seed).normal(size=shape) * 0.5).astype(np.float32)


def _tokens(cfg, shape, seed=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape, dtype=np.int32)


def test_apply_gives_the_text_positions_logits_as_reference():
    """16 patches + 12 tokens: logits for the 12 text positions, and the
    prefix moves them."""
    jcfg, cfg, params, tparams = _pair()
    assert cfg.frontend_tokens == 16
    embeds, tokens = _embeds(cfg, 2), _tokens(cfg, (2, 12))
    jlogits, _ = jbuild_model(jcfg).apply(params, jnp.asarray(tokens), jnp.asarray(embeds))
    logits, _ = build_model(cfg).apply(tparams, torch.from_numpy(tokens), torch.from_numpy(embeds))
    assert logits.shape == (2, 12, cfg.padded_vocab)
    assert_rel_close(logits, jlogits, "logits")
    bare, _ = build_model(cfg).apply(tparams, torch.from_numpy(tokens))
    assert not torch.allclose(bare, logits)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_every_gradient_match_reference(remat):
    """``loss`` over ``batch["embeds"]`` and every gradient leaf at 1e-4 of
    its largest entry."""
    jcfg, cfg, params, tparams = _pair(seed=1)
    toks = _tokens(cfg, (2, 21), seed=3)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "embeds": _embeds(cfg, 2, seed=4)}
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


def test_prefill_with_a_prefix_and_decode_past_it_match_reference():
    """``prefill(extra_embeds)`` fills positions 0…P+S−1 of the ring (logits
    and cache as the reference's, the last equal to ``apply``'s last text
    position); three decode steps then start at P + S."""
    jcfg, cfg, params, tparams = _pair(seed=2)
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    embeds, prompts = _embeds(cfg, 2, seed=5), _tokens(cfg, (2, 10), seed=6)
    (B, S), P = prompts.shape, cfg.frontend_tokens
    jl, jcache = jmodel.prefill(params, jnp.asarray(prompts), jmodel.init_cache(B, P + S + 3),
                                jnp.asarray(embeds))
    tl, cache = model.prefill(tparams, torch.from_numpy(prompts),
                              model.init_cache(B, P + S + 3, device="cpu"),
                              torch.from_numpy(embeds))
    assert_rel_close(tl, jl, "prefill logits")
    full, _ = model.apply(tparams, torch.from_numpy(prompts), torch.from_numpy(embeds))
    assert_rel_close(tl, full[:, -1].numpy(), "prefill vs apply")
    jleaves = jax.tree_util.tree_leaves_with_path(jcache)
    assert len(jleaves) == len(tree_leaves(cache))
    for (path, a), b in zip(jleaves, tree_leaves(cache)):
        if b.dtype == torch.int32:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        else:
            assert_rel_close(b, a, jax.tree_util.keystr(path))
    assert int(cache["u0_attn"]["slot_pos"].max()) == P + S - 1
    for step in range(3):
        tok = np.array(jnp.argmax(jl[:, : cfg.vocab_size], axis=-1), np.int32)
        jl, jcache = jmodel.decode_step(params, jnp.asarray(tok), jcache, jnp.int32(P + S + step))
        tl, cache = model.decode_step(tparams, torch.from_numpy(tok), cache, P + S + step)
        assert_rel_close(tl, jl, f"decode step {step}")


def test_serve_batch_with_embeds_matches_reference():
    jcfg, cfg, params, tparams = _pair(seed=3)
    prompts, embeds = _tokens(cfg, (2, 8), seed=7), _embeds(cfg, 2, seed=8)
    got = serve_batch(cfg, tparams, prompts, new_tokens=6, embeds=embeds).numpy()
    want = np.asarray(jserve_batch(jcfg, params, jnp.asarray(prompts), new_tokens=6,
                                   embeds=jnp.asarray(embeds)))
    assert got.dtype == np.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got, want)


def test_prefill_step_probe_with_embeds_matches_reference():
    jcfg, cfg, params, tparams = _pair(seed=4)
    batch = {"tokens": _tokens(cfg, (2, 12), seed=9), "embeds": _embeds(cfg, 2, seed=10)}
    jtok, jlast = jmake_prefill_step(jcfg)(params, {k: jnp.asarray(v) for k, v in batch.items()})
    tok, last = make_prefill_step(cfg)(tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert_rel_close(last, jlast, "last logits")
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


# ---------------------------------------------------------------------------
# frontend stubs
# ---------------------------------------------------------------------------

STUBS = [("stub_patch_embeddings", "internvl2-1b", ()),
         ("stub_audio_frames", "seamless-m4t-medium", ()),
         ("stub_audio_frames", "seamless-m4t-medium", (64,))]


@pytest.mark.parametrize("name,arch,extra", STUBS)
@pytest.mark.parametrize("reduced", [False, True])
def test_stub_shapes_and_dtypes_match_reference(name, arch, extra, reduced):
    cfg, jcfg = get_config(arch), jget_config(arch)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    got = getattr(frontends, name)(0, cfg, 2, *extra, device="cpu")
    want = jax.eval_shape(lambda k: getattr(jfrontends, name)(k, jcfg, 2, *extra),
                          jax.random.PRNGKey(0))
    assert tuple(got.shape) == want.shape
    assert str(got.dtype).removeprefix("torch.") == want.dtype.name


@pytest.mark.parametrize("name,arch,extra", STUBS)
def test_stub_scale_and_seeded_draws(name, arch, extra):
    """N(0, 1) · 0.02: the draws' std is 0.02 within 2% at these sizes; the
    same seed (or a generator seeded alike) gives the same draw, another
    seed another."""
    cfg = get_config(arch)
    stub = getattr(frontends, name)
    x = stub(5, cfg, 2, *extra, device="cpu")
    assert abs(float(x.float().std()) / 0.02 - 1) < 0.02
    assert abs(float(x.float().mean())) < 1e-3
    assert torch.equal(x, stub(5, cfg, 2, *extra, device="cpu"))
    assert torch.equal(x, stub(torch.Generator().manual_seed(5), cfg, 2, *extra))
    assert not torch.equal(x, stub(6, cfg, 2, *extra, device="cpu"))
