"""The rest of the decoder zoo — MoE, RG-LRU and MLA — against the reference.

Seeded numpy inputs go through both packages on the CPU, in f32 at
``reduced()``, and the outputs are held at 1e-4 of their largest magnitude:
- MoE (llama4-scout: top-1 with a shared expert; grok-1: top-2, gelu): both
  dispatches at N ≤ 64 tokens (no drops) and N > 64 (capacity drops), the
  load-balance aux loss, and the top-k order of equal gates;
- RG-LRU: the log-depth scan with and without an initial state, and the
  block's full / prefill / decode paths with their caches;
- MLA: the naive and absorbed full forwards (one above
  ``CHUNKED_THRESHOLD``), prefill and decode with a ring wrap, and that MLA
  reaches neither attention kernel op;
- whole models (recurrentgemma-9b, minicpm3-4b, llama4-scout, grok-1): logits,
  ``DecoderLM.loss`` with its aux term, every gradient leaf of an MoE, an
  RG-LRU and an MLA model, and prefill + decode across a window's ring wrap.
The reference's weights are carried across with ``load_jax_params``.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch.serve import serve_batch as jserve_batch
from repro.models import attention as jattention
from repro.models import build_model as jbuild_model
from repro.models import moe as jmoe
from repro.models import rglru as jrglru
from repro_torch.configs import get_config
from repro_torch.core.tree import as_numpy, tree_leaves
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch.serve import serve_batch, serve_batch_loop
from repro_torch.models import attention, build_model, load_jax_params, moe, rglru
from repro_torch.training import value_and_grad

from _torch_parity import np_params

TOL = 1e-4  # the reference's own tolerance for f32 model outputs
NEW_ARCHS = ["recurrentgemma-9b", "minicpm3-4b", "llama4-scout-17b-a16e", "grok-1-314b"]
MOE_ARCHS = ["llama4-scout-17b-a16e", "grok-1-314b"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The tensors here are small: two intra-op threads do the work, and
    the suite's other workers keep the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _close(got, want, msg=""):
    """|got − want| ≤ TOL · max|want|."""
    got, want = as_numpy(got).astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= TOL, f"{msg}: max abs err {err * scale} = {err} of max |want| {scale}"


def _cfgs(arch, **kw):
    return jget_config(arch).reduced().replace(**kw), get_config(arch).reduced().replace(**kw)


def _sub_params(init, jcfg, seed=0):
    """numpy parameters in the layout of ``init(key, jcfg)``, and the same as
    tensors."""
    params = np_params(SimpleNamespace(init=lambda key: init(key, jcfg)), seed)
    return params, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _pair(arch, seed=0, **kw):
    jcfg, cfg = _cfgs(arch, **kw)
    params = np_params(jbuild_model(jcfg), seed)
    return jcfg, cfg, params, load_jax_params(build_model(cfg), params, device="cpu")


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape, dtype=np.int32)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
@pytest.mark.parametrize("B,S", [(2, 16), (4, 40)])
def test_moe_matches_reference(arch, dispatch, B, S):
    """N = 32 tokens keep every choice (capacity N); N = 160 takes the Switch
    capacity ⌊1.25·k·N/E⌋ and drops the overflow, in the reference's slot
    order. The activations share a mean (0.5), which the router turns into
    a preference between experts, so some expert overflows. Output and aux
    loss at 1e-4."""
    jcfg, cfg = _cfgs(arch, moe_dispatch=dispatch)
    params, tparams = _sub_params(jmoe.init_moe, jcfg, seed=3)
    assert ("shared" in params) == (arch == "llama4-scout-17b-a16e")
    x = _x((B, S, cfg.d_model), seed=4) + np.float32(0.5)
    jout, jaux = jmoe.moe_apply(params, jcfg, jnp.asarray(x))
    out, aux = moe.moe_apply(tparams, cfg, torch.from_numpy(x))
    _close(out, jout, "out")
    _close(aux, jaux, "aux")
    # the drops: some expert is routed more choices than its capacity iff N > 64
    N = B * S
    _, idx, _ = moe._top_k_gating(torch.from_numpy(x.reshape(N, -1)) @ tparams["router"]["w"],
                                  cfg.experts_per_token)
    loads = torch.bincount(idx.reshape(-1), minlength=cfg.num_experts)
    assert bool(loads.max() > moe._capacity(cfg, N)) == (N > 64), (loads, moe._capacity(cfg, N))


def test_moe_dispatches_agree():
    """The einsum and gather dispatches compute the same layer (the
    reference's own variant check), drops included."""
    _, cfg = _cfgs("grok-1-314b")
    _, tparams = _sub_params(jmoe.init_moe, _cfgs("grok-1-314b")[0], seed=5)
    x = torch.from_numpy(_x((3, 50, cfg.d_model), seed=6))
    out_e, aux_e = moe.moe_apply(tparams, cfg, x)
    out_g, aux_g = moe.moe_apply_gather(tparams, cfg.replace(moe_dispatch="gather"), x)
    _close(out_g, out_e.numpy(), "out")
    _close(aux_g, aux_e.numpy(), "aux")


def test_top_k_gating_orders_equal_gates_as_reference():
    """Equal gates keep the lower expert first, as ``jax.lax.top_k`` does."""
    logits = np.array([[1, 1, 1, 1], [0, 2, 2, 0], [3, 3, 1, 3], [0, 1, 0, 1]], np.float32)
    for k in (1, 2, 3):
        jg, jidx, jall = jmoe._top_k_gating(jnp.asarray(logits), k)
        g, idx, gall = moe._top_k_gating(torch.from_numpy(logits), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        _close(g, jg, f"gates k={k}")
        _close(gall, jall, f"all gates k={k}")


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [1, 5, 64, 100])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("grad", [False, True])
def test_rglru_scan_matches_reference_and_the_recurrence(S, with_h0, grad):
    """Both of the scan's paths: under autograd (concatenation) and without
    it (two preallocated buffer pairs, as serving runs it)."""
    rng = np.random.default_rng(S)
    a = rng.uniform(0.3, 1.0, (2, S, 8)).astype(np.float32)
    b = rng.normal(size=(2, S, 8)).astype(np.float32)
    h0 = rng.normal(size=(2, 8)).astype(np.float32) if with_h0 else None
    want = jrglru.rglru_scan(jnp.asarray(a), jnp.asarray(b),
                             None if h0 is None else jnp.asarray(h0))
    ta, tb = (torch.from_numpy(x).requires_grad_(grad) for x in (a, b))
    got = rglru.rglru_scan(ta, tb, None if h0 is None else torch.from_numpy(h0))
    assert got.requires_grad == grad
    got = got.detach()
    _close(got, want, "vs reference")
    h, loop = np.zeros((2, 8)) if h0 is None else h0.astype(np.float64), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        loop.append(h)
    _close(got, np.stack(loop, axis=1), "vs the recurrence")


def test_rglru_block_full_prefill_decode_match_reference():
    """``rglru_full``; ``rglru_prefill`` of a prompt in two pieces (the second
    seeded by the first's conv window and h, the scan's ``h0``); then three
    ``rglru_decode`` steps: outputs and caches at 1e-4."""
    jcfg, cfg = _cfgs("recurrentgemma-9b")
    params, tparams = _sub_params(jrglru.init_rglru, jcfg, seed=7)
    x = _x((2, 23, cfg.d_model), seed=8)
    _close(rglru.rglru_full(tparams, cfg, torch.from_numpy(x)),
           jrglru.rglru_full(params, jcfg, jnp.asarray(x)), "full")
    jcache = jrglru.init_rglru_cache(jcfg, 2)
    cache = rglru.init_rglru_cache(cfg, 2)
    for lo, hi in ((0, 15), (15, 20)):
        jout, jcache = jrglru.rglru_prefill(params, jcfg, jnp.asarray(x[:, lo:hi]), jcache)
        out, cache = rglru.rglru_prefill(tparams, cfg, torch.from_numpy(x[:, lo:hi]), cache)
        _close(out, jout, f"prefill [{lo}, {hi})")
        for key in ("conv", "h"):
            _close(cache[key], jcache[key], f"cache {key} after [{lo}, {hi})")
    for t in range(20, 23):
        jout, jcache = jrglru.rglru_decode(params, jcfg, jnp.asarray(x[:, t:t + 1]), jcache)
        out, cache = rglru.rglru_decode(tparams, cfg, torch.from_numpy(x[:, t:t + 1]), cache)
        _close(out, jout, f"decode {t}")
        for key in ("conv", "h"):
            _close(cache[key], jcache[key], f"cache {key} after decode {t}")


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("absorb", [False, True])
@pytest.mark.parametrize("S", [12, 1280])
def test_mla_full_matches_reference(absorb, S):
    """Naive and absorbed full-sequence MLA; S = 1280 runs ``chunked_sdpa``
    (five q-blocks of 256) in both packages."""
    jcfg, cfg = _cfgs("minicpm3-4b", mla_absorb=absorb)
    params, tparams = _sub_params(jattention.init_mla, jcfg, seed=9)
    x = _x((1, S, cfg.d_model), seed=10)
    _close(attention.mla_full(tparams, cfg, torch.from_numpy(x)),
           jattention.mla_full(params, jcfg, jnp.asarray(x)), "mla_full")


@pytest.mark.parametrize("absorb", [False, True])
@pytest.mark.parametrize("window,capacity", [(0, 15), (8, 8)])
def test_mla_prefill_and_decode_match_reference(absorb, window, capacity):
    """``mla_prefill`` of 12 tokens into a fresh latent ring, then three
    ``mla_decode`` steps (naive or absorbed): outputs and the ring (c_kv,
    k_rope, slot_pos). With a window of 8 the ring of 8 wraps."""
    jcfg, cfg = _cfgs("minicpm3-4b")
    params, tparams = _sub_params(jattention.init_mla, jcfg, seed=11)
    x = _x((2, 15, cfg.d_model), seed=12)
    jcache = jattention.init_mla_cache(jcfg, 2, capacity)
    cache = attention.init_mla_cache(cfg, 2, capacity)
    jout, jcache = jattention.mla_prefill(params, jcfg, jnp.asarray(x[:, :12]), jcache,
                                          window=window)
    out, cache = attention.mla_prefill(tparams, cfg, torch.from_numpy(x[:, :12]), cache,
                                       window=window)
    _close(out, jout, "prefill")
    for t in range(12, 15):
        jout, jcache = jattention.mla_decode(params, jcfg, jnp.asarray(x[:, t:t + 1]), jcache,
                                             jnp.int32(t), window=window, absorb=absorb)
        out, cache = attention.mla_decode(tparams, cfg, torch.from_numpy(x[:, t:t + 1]), cache,
                                          t, window=window, absorb=absorb)
        _close(out, jout, f"decode {t}")
        for key in ("c_kv", "k_rope"):
            _close(cache[key], jcache[key], f"{key} after {t}")
        np.testing.assert_array_equal(cache["slot_pos"].numpy(), np.asarray(jcache["slot_pos"]))


def test_mla_reaches_neither_attention_kernel(monkeypatch):
    """MLA's qk width (96 at full size) is no kernel head size: serving an
    MLA model runs plain attention on any device. With both attention ops
    patched to raise, minicpm3-4b serves; granite (GQA) does not."""
    def refuse(*a, **k):
        raise AssertionError("an attention kernel op was called")

    monkeypatch.setattr(flash_ops, "flash_attention", refuse)
    monkeypatch.setattr(dec_ops, "decode_attention", refuse)
    for arch, reaches in (("minicpm3-4b", False), ("granite-3-2b", True)):
        cfg = get_config(arch).reduced()
        params = build_model(cfg).init(0, device="cpu")
        prompts = _tokens(cfg, (2, 8))
        if reaches:
            with pytest.raises(AssertionError, match="kernel op"):
                serve_batch(cfg, params, prompts, new_tokens=3)
        else:
            assert serve_batch(cfg, params, prompts, new_tokens=3).shape == (2, 3)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_logits_and_loss_match_reference(arch):
    """``apply`` and ``loss`` (CE + router_aux_weight · aux) at S = 80: past
    recurrentgemma's reduced window of 64, and N = 160 tokens, where the MoE
    blocks drop."""
    jcfg, cfg, params, tparams = _pair(arch)
    toks = _tokens(cfg, (2, 81), seed=2)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jlogits, jaux = jbuild_model(jcfg).apply(params, jnp.asarray(batch["tokens"]))
    logits, aux = build_model(cfg).apply(tparams, torch.from_numpy(batch["tokens"]))
    _close(logits, jlogits, "logits")
    _close(aux, jaux, "aux")
    assert (float(aux) > 0) == (cfg.num_experts > 0)
    jl, jm = jbuild_model(jcfg).loss(params, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tm = build_model(cfg).loss(tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(tl, jl, "loss")
    for key in ("ce", "aux", "accuracy"):
        _close(tm[key], jm[key], key)


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "recurrentgemma-9b", "minicpm3-4b"])
def test_loss_gradients_match_reference(arch):
    """Every gradient leaf of ``DecoderLM.loss`` (the aux term included) at
    1e-4 of its largest entry: an MoE, an RG-LRU and an MLA model, S = 40."""
    jcfg, cfg, params, tparams = _pair(arch, seed=1)
    toks = _tokens(cfg, (2, 41), seed=3)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    fn = jax.jit(jax.value_and_grad(lambda p, b: jbuild_model(jcfg).loss(p, b), has_aux=True))
    (jl, _), jg = fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    (tl, _), tg = value_and_grad(build_model(cfg).loss, tparams,
                                 {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(tl, jl, "loss")
    leaves = jax.tree_util.tree_leaves_with_path(jg)
    assert len(leaves) == len(tree_leaves(tg))
    for (path, a), b in zip(leaves, tree_leaves(tg)):
        _close(b, a, jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch,kw", [("recurrentgemma-9b", {}),
                                     ("minicpm3-4b", {"mla_absorb": True})])
def test_prefill_and_decode_across_a_ring_wrap_match_reference(arch, kw):
    """Bulk prefill of 80 tokens (recurrentgemma's reduced window of 64: its
    ring wraps) and three decode steps; minicpm3 with the absorbed decode."""
    jcfg, cfg, params, tparams = _pair(arch, seed=2, **kw)
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    prompts = _tokens(cfg, (2, 80), seed=4)
    B, S = prompts.shape
    jl, jcache = jmodel.prefill(params, jnp.asarray(prompts), jmodel.init_cache(B, S + 3))
    tl, tcache = model.prefill(tparams, torch.from_numpy(prompts),
                               model.init_cache(B, S + 3, device="cpu"))
    _close(tl, jl, "prefill")
    for step in range(3):
        tok = np.array(jnp.argmax(jl[:, : cfg.vocab_size], axis=-1), np.int32)
        jl, jcache = jmodel.decode_step(params, jnp.asarray(tok), jcache, jnp.int32(S + step))
        tl, tcache = model.decode_step(tparams, torch.from_numpy(tok), tcache, S + step)
        _close(tl, jl, f"decode step {step}")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_serving_drops_in_prefill_as_reference(arch):
    """A 2 × 40 prompt is N = 80 > 64 prefill tokens: the bulk prefill drops
    overflow choices where the token-at-a-time loop (N = 2 a step) keeps
    them — in the reference too, whose bulk-vs-loop test leaves MoE out. The
    port's bulk tokens equal the reference's."""
    jcfg, cfg, params, tparams = _pair(arch, seed=5)
    prompts = _tokens(cfg, (2, 40), seed=6)
    got = serve_batch(cfg, tparams, prompts, new_tokens=4).numpy()
    want = np.asarray(jserve_batch(jcfg, params, jnp.asarray(prompts), new_tokens=4))
    np.testing.assert_array_equal(got, want)
    short = prompts[:, :32]  # N = 64: no drops, bulk == loop
    np.testing.assert_array_equal(serve_batch(cfg, tparams, short, new_tokens=4).numpy(),
                                  serve_batch_loop(cfg, tparams, short, new_tokens=4).numpy())
