"""The port's attention kernels' plain versions and attention layer against
the reference.

On CPU tensors the port's ``flash_attention`` / ``decode_attention`` ops take
their plain PyTorch versions; these are held against the JAX package's Pallas
kernels (interpret mode) and its jnp refs over the sweeps of
tests/test_kernels.py, with its tolerances (2e-5 f32, 2e-2 bf16), and against
the refs at ragged S / C, which the Pallas kernels do not take. The layer
functions (``attn_prefill``, ``attn_decode``, ``fill_ring``) are held against
the reference's on granite-3-2b reduced, f32, within 1e-5. The CUDA kernels
themselves are tested on the card (tests/test_torch_cuda.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels.decode_attention.kernel import decode_attention as jax_decode_kernel
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_decode_ref
from repro.kernels.flash_attention.kernel import flash_attention as jax_flash_kernel
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref
from repro.models import attention as JA
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import attention as TA
from repro_torch.models.common import load_jax_params

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _arrays(seed, dtype, *shapes):
    """Standard normals drawn with numpy, as (jax arrays, torch tensors) of
    one dtype: bf16 values are rounded once and shared by both."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jx = [jnp.asarray(x).astype(dtype) for x in xs]
    tx = [torch.from_numpy(np.array(j.astype(jnp.float32))).to(getattr(torch, dtype))
          for j in jx]
    return jx, tx


def _close(got: torch.Tensor, want, dtype: str):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("B,S,KV,G,hd,window", [
    (2, 256, 2, 2, 64, 0),
    (1, 256, 1, 4, 64, 128),    # MQA + sliding window
    (2, 512, 4, 1, 128, 0),
    (1, 128, 2, 2, 256, 64),    # gemma-style head_dim 256
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas_and_ref(B, S, KV, G, hd, window, dtype):
    (jq, jk, jv), (q, k, v) = _arrays(S + hd, dtype, (B, S, KV, G, hd), (B, S, KV, hd),
                                      (B, S, KV, hd))
    got = flash_ops.flash_attention(q, k, v, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    bq = min(128, S)
    _close(got, jax_flash_kernel(jq, jk, jv, window=window, block_q=bq, block_k=bq,
                                 interpret=True), dtype)
    _close(got, jax_flash_ref(jq, jk, jv, window=window), dtype)


@pytest.mark.parametrize("B,S,KV,G,hd,window", [
    (2, 200, 2, 4, 64, 0),      # ragged S: the Pallas kernel needs S % block == 0
    (1, 333, 2, 3, 128, 100),   # ragged, G = 3, windowed
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_ref_at_ragged_s(B, S, KV, G, hd, window, dtype):
    (jq, jk, jv), (q, k, v) = _arrays(S, dtype, (B, S, KV, G, hd), (B, S, KV, hd),
                                      (B, S, KV, hd))
    _close(flash_ops.flash_attention(q, k, v, window=window),
           jax_flash_ref(jq, jk, jv, window=window), dtype)


@pytest.mark.parametrize("B,KV,G,hd,C", [
    (2, 2, 4, 64, 1024),
    (1, 8, 1, 128, 512),
    (3, 1, 6, 64, 2048),
    (1, 2, 2, 256, 256),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_pallas_and_ref(B, KV, G, hd, C, dtype):
    (jq, jk, jv), (q, k, v) = _arrays(C + hd, dtype, (B, KV, G, hd), (B, C, KV, hd),
                                      (B, C, KV, hd))
    valid = np.random.default_rng(C).random(C) < 0.7
    got = dec_ops.decode_attention(q[:, None], k, v, torch.from_numpy(valid))[:, 0]
    assert got.dtype == q.dtype and got.shape == q.shape
    jvalid = jnp.asarray(valid)
    _close(got, jax_decode_kernel(jq, jk, jv, jvalid, block_k=min(256, C), interpret=True), dtype)
    _close(got, jax_decode_ref(jq, jk, jv, jvalid), dtype)


@pytest.mark.parametrize("C", [576, 1000, 37])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_ref_at_ragged_c(C, dtype):
    """Serving's capacity S + new_tokens (e.g. 576) is no multiple of the
    Pallas kernel's block; the port takes any C."""
    (jq, jk, jv), (q, k, v) = _arrays(C, dtype, (2, 8, 4, 64), (2, C, 8, 64), (2, C, 8, 64))
    valid = np.arange(C) < C - 5
    got = dec_ops.decode_attention(q[:, None], k, v, torch.from_numpy(valid))[:, 0]
    _close(got, jax_decode_ref(jq, jk, jv, jnp.asarray(valid)), dtype)


def test_decode_with_no_valid_slot_matches_ref():
    """All scores masked: both give the plain mean of v, as the TPU kernel does."""
    (jq, jk, jv), (q, k, v) = _arrays(3, "float32", (1, 2, 4, 64), (1, 50, 2, 64), (1, 50, 2, 64))
    none = np.zeros(50, bool)
    got = dec_ops.decode_attention(q[:, None], k, v, torch.from_numpy(none))[:, 0]
    _close(got, jax_decode_ref(jq, jk, jv, jnp.asarray(none)), "float32")
    _close(got, jax_decode_kernel(jq, jk, jv, jnp.asarray(none), block_k=50, interpret=True),
           "float32")


# ---------------------------------------------------------------------------
# the attention layer on granite-3-2b reduced (f32)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def granite():
    jcfg = jget_config("granite-3-2b").reduced()
    cfg = get_config("granite-3-2b").reduced()
    jp = JA.init_attention(jax.random.PRNGKey(7), jcfg)
    np_p = jax.tree.map(np.asarray, jp)

    class Layer:  # load_jax_params needs only the layout
        def abstract(self):
            return TA.init_attention(None, cfg)

    return jcfg, cfg, jp, load_jax_params(Layer(), np_p, device="cpu")


def _x(seed, *shape):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _assert_cache_equal(tcache, jcache):
    for name in ("k", "v", "slot_pos"):
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("S,capacity", [(12, 16), (20, 8)])  # the second wraps the ring
def test_attn_prefill_matches_reference(granite, S, capacity):
    jcfg, cfg, jp, tp = granite
    jx, tx = _x(S, 2, S, cfg.d_model)
    jout, jcache = JA.attn_prefill(jp, jcfg, jx, JA.init_attn_cache(jcfg, 2, capacity))
    tout, tcache = TA.attn_prefill(tp, cfg, tx, TA.init_attn_cache(cfg, 2, capacity))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    _assert_cache_equal(tcache, jcache)
    np.testing.assert_allclose(TA.attn_full(tp, cfg, tx).numpy(),
                               np.asarray(JA.attn_full(jp, jcfg, jx)), rtol=1e-5, atol=1e-5)


def test_attn_decode_matches_reference_over_a_ring(granite):
    """Ten decode steps into a ring of 6 slots: outputs and cache agree at
    every step (the ring wraps, so slot validity is exercised)."""
    jcfg, cfg, jp, tp = granite
    jcache = JA.init_attn_cache(jcfg, 2, 6)
    tcache = TA.init_attn_cache(cfg, 2, 6)
    for pos in range(10):
        jx, tx = _x(100 + pos, 2, 1, cfg.d_model)
        jout, jcache = JA.attn_decode(jp, jcfg, jx, jcache, jnp.int32(pos))
        tout, tcache = TA.attn_decode(tp, cfg, tx, tcache, pos)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5,
                                   err_msg=f"pos {pos}")
        _assert_cache_equal(tcache, jcache)


@pytest.mark.parametrize("seq,capacity", [(5, 8), (8, 8), (13, 8)])
def test_fill_ring_matches_reference(granite, seq, capacity):
    jcfg, cfg, _, _ = granite
    vals = np.random.default_rng(seq).standard_normal((2, seq, cfg.n_kv_heads, 64)).astype(np.float32)
    jcache = JA.fill_ring(JA.init_attn_cache(jcfg, 2, capacity), {"k": jnp.asarray(vals)}, seq)
    tcache = TA.fill_ring(TA.init_attn_cache(cfg, 2, capacity), {"k": torch.from_numpy(vals)}, seq)
    _assert_cache_equal(tcache, jcache)


def test_softcap_takes_the_masked_softmax_on_cpu_and_has_no_kernel(monkeypatch):
    jcfg = jget_config("granite-3-2b").reduced().replace(attn_logit_softcap=30.0)
    cfg = get_config("granite-3-2b").reduced().replace(attn_logit_softcap=30.0)
    jp = JA.init_attention(jax.random.PRNGKey(1), jcfg)

    class Layer:
        def abstract(self):
            return TA.init_attention(None, cfg)

    tp = load_jax_params(Layer(), jax.tree.map(np.asarray, jp), device="cpu")
    jx, tx = _x(5, 1, 9, cfg.d_model)
    np.testing.assert_allclose(TA.attn_full(tp, cfg, tx).numpy(),
                               np.asarray(JA.attn_full(jp, jcfg, jx)), rtol=1e-5, atol=1e-5)

    # a capped config never reaches a kernel op, with use_flash too, and the
    # prefill + decode that serving runs take the capped masked softmax
    def no_kernel(*a, **k):
        raise AssertionError("a capped config reached a kernel op")

    monkeypatch.setattr(TA.flash_ops, "flash_attention", no_kernel)
    monkeypatch.setattr(TA.dec_ops, "decode_attention", no_kernel)
    np.testing.assert_allclose(TA.attn_full(tp, cfg, tx, use_flash=True).numpy(),
                               np.asarray(JA.attn_full(jp, jcfg, jx)), rtol=1e-5, atol=1e-5)
    cache = TA.init_attn_cache(cfg, 1, 12)
    out, cache = TA.attn_prefill(tp, cfg, tx, cache)
    np.testing.assert_allclose(out.numpy(), np.asarray(JA.attn_full(jp, jcfg, jx)),
                               rtol=1e-5, atol=1e-5)
    step, _ = TA.attn_decode(tp, cfg, tx[:, -1:], cache, 9)
    assert torch.isfinite(step).all()
