"""The arithmetic of the port's redesigned attention kernels, in plain
PyTorch on the CPU, against the reference.

* ``decode_attention``'s split-K: a partial softmax per slice of the cache,
  merged by rescaling (``decode_attention_split_ref``, the arithmetic of the
  CUDA kernel's cluster merge), held against the port's plain version and the
  JAX package's Pallas kernel (interpret mode) and its jnp ref, with the
  reference's tolerances (2e-5 f32, 2e-2 bf16); and the wrapper's rule for
  the number of slices (``split_count``).
* ``flash_attention``'s bf16 tensor-core kernel rounds the probabilities P to
  bf16 before P·V; an emulation of its tiles in plain PyTorch shows that this
  stays inside the reference's bf16 tolerance at the serving shape.

The CUDA kernels themselves are tested on the card (tests/test_torch_cuda.py).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.kernel import decode_attention as jax_decode_kernel
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_decode_ref
from repro.kernels.flash_attention.kernel import flash_attention as jax_flash_kernel
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref
from repro_torch.kernels.decode_attention.kernel import MAX_SPLIT, split_count
from repro_torch.kernels.decode_attention.ref import (decode_attention_ref,
                                                      decode_attention_split_ref, split_bounds)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

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


# ---------------------------------------------------------------------------
# decode_attention: the split rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,KV,C,sms", [
    (8, 8, 576, 132), (8, 8, 32768, 132), (1, 2, 1, 132), (1, 2, 7, 132), (1, 2, 63, 132),
    (2, 8, 1000, 132), (1, 1, 130, 132), (1, 1, 577, 132), (64, 16, 1000, 132),
    (3, 1, 2048, 114), (1, 1, 520, 132),
])
def test_split_rule_covers_the_cache_in_nonempty_slices(B, KV, C, sms):
    n = split_count(B, KV, C, sms)
    assert 1 <= n <= MAX_SPLIT
    bounds = split_bounds(C, n)
    assert len(bounds) == n and bounds[0][0] == 0 and bounds[-1][1] == C
    assert all(lo < hi for lo, hi in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))


def test_split_rule_fills_the_card_at_the_serving_shape():
    """granite-3-2b's decode (B = 8, KV = 8, C = 576) on 132 SMs: at least two
    blocks per SM, slices of at least 64 entries."""
    n = split_count(8, 8, 576, 132)
    assert 8 * 8 * n >= 2 * 132
    assert min(hi - lo for lo, hi in split_bounds(576, n)) >= 64


@pytest.mark.parametrize("C", [1, 2, 5, 7])
def test_split_rule_takes_fewer_splits_for_a_short_cache(C):
    n = split_count(1, 1, C, 132)
    assert n < MAX_SPLIT and n <= C


# ---------------------------------------------------------------------------
# decode_attention: the split-K merge against the references
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_split", range(1, 9))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_merge_matches_pallas_and_refs(n_split, dtype):
    """C = 1000: ragged slices for every n_split (1000 = 7 * 143 - 1, ...)."""
    C = 1000
    (jq, jk, jv), (q, k, v) = _arrays(n_split, dtype, (2, 2, 4, 64), (2, C, 2, 64),
                                      (2, C, 2, 64))
    valid = np.random.default_rng(C + n_split).random(C) < 0.7
    got = decode_attention_split_ref(q, k, v, torch.from_numpy(valid), n_split)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, decode_attention_ref(q, k, v, torch.from_numpy(valid)).float(), dtype)
    jvalid = jnp.asarray(valid)
    _close(got, jax_decode_kernel(jq, jk, jv, jvalid, block_k=200, interpret=True), dtype)
    _close(got, jax_decode_ref(jq, jk, jv, jvalid), dtype)


@pytest.mark.parametrize("n_split", [2, 3, 8])
def test_split_merge_with_a_slice_of_invalid_slots(n_split):
    """Every slot of the first slice is invalid: that partial has m = -1e30
    and weighs nothing beside the valid slices."""
    C = 480
    (jq, jk, jv), (q, k, v) = _arrays(7, "float32", (1, 2, 4, 64), (1, C, 2, 64), (1, C, 2, 64))
    valid = np.random.default_rng(1).random(C) < 0.7
    lo, hi = split_bounds(C, n_split)[0]
    valid[lo:hi] = False
    got = decode_attention_split_ref(q, k, v, torch.from_numpy(valid), n_split)
    _close(got, jax_decode_ref(jq, jk, jv, jnp.asarray(valid)), "float32")
    _close(got, jax_decode_kernel(jq, jk, jv, jnp.asarray(valid), block_k=160, interpret=True),
           "float32")


@pytest.mark.parametrize("n_split", [1, 3, 8])
def test_split_merge_with_no_valid_slot(n_split):
    """All scores masked: every partial has m = -1e30, and the merge gives the
    plain mean of v, as the TPU kernel does."""
    C = 100
    (jq, jk, jv), (q, k, v) = _arrays(3, "float32", (1, 2, 4, 64), (1, C, 2, 64), (1, C, 2, 64))
    none = np.zeros(C, bool)
    got = decode_attention_split_ref(q, k, v, torch.from_numpy(none), n_split)
    _close(got, v.float().mean(1)[:, :, None].expand_as(got), "float32")
    _close(got, jax_decode_ref(jq, jk, jv, jnp.asarray(none)), "float32")
    _close(got, jax_decode_kernel(jq, jk, jv, jnp.asarray(none), block_k=C, interpret=True),
           "float32")


@pytest.mark.parametrize("C", [1, 2, 5, 7])
@pytest.mark.parametrize("n_split", [1, 4, 8])
def test_split_merge_at_a_short_cache(C, n_split):
    """C below n_split leaves slices past C empty (m = -inf, weight 0)."""
    (jq, jk, jv), (q, k, v) = _arrays(C, "float32", (2, 2, 4, 64), (2, C, 2, 64), (2, C, 2, 64))
    valid = np.ones(C, bool)
    valid[0] = C == 1  # the first slot is empty unless it is the only one
    got = decode_attention_split_ref(q, k, v, torch.from_numpy(valid), n_split)
    _close(got, jax_decode_ref(jq, jk, jv, jnp.asarray(valid)), "float32")
    _close(got, jax_decode_kernel(jq, jk, jv, jnp.asarray(valid), block_k=C, interpret=True),
           "float32")


# ---------------------------------------------------------------------------
# flash_attention: the bf16 tensor-core kernel's rounding of P
# ---------------------------------------------------------------------------


def flash_mma_emulation(q, k, v, *, window: int = 0, tk: int = 64) -> torch.Tensor:
    """The bf16 kernel's arithmetic in plain PyTorch: f32 scores of bf16
    operands in the log2 domain, an online softmax over key tiles of ``tk``
    with f32 m and l, P rounded to bf16 before P·V (f32 accumulation), and
    the output divided by max(l, 1e-30) and rounded to bf16."""
    B, S, KV, G, hd = q.shape
    scale_log2 = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32) * math.log2(math.e)
    qpos = torch.arange(S)[:, None]
    out = torch.empty_like(q)
    for b in range(B):
        qb = q[b].float().permute(1, 2, 0, 3)   # (KV, G, S, hd)
        kb = k[b].float().transpose(0, 1)       # (KV, S, hd)
        vb = v[b].float().transpose(0, 1)
        m = torch.full((KV, G, S), -1e30)
        l = torch.zeros(KV, G, S)
        acc = torch.zeros(KV, G, S, hd)
        for k0 in range(0, S, tk):
            kpos = torch.arange(k0, min(S, k0 + tk))[None, :]
            s = torch.einsum("kgsh,kth->kgst", qb, kb[:, k0:k0 + tk]) * scale_log2
            mask = kpos <= qpos
            if window > 0:
                mask &= kpos > qpos - window
            s = torch.where(mask, s, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            pv = torch.einsum("kgst,kth->kgsh", p.to(torch.bfloat16).float(), vb[:, k0:k0 + tk])
            acc = acc * alpha[..., None] + pv
            m = m_new
        out[b] = (acc / l.clamp_min(1e-30)[..., None]).permute(2, 0, 1, 3).to(q.dtype)
    return out


@pytest.mark.parametrize("B,S,KV,G,hd,window,block", [
    (8, 512, 8, 4, 64, 0, 256),     # granite-3-2b's prefill, the serving shape
    (1, 256, 1, 4, 64, 128, 128),   # sliding window
    (1, 256, 2, 5, 128, 0, 128),    # qwen3-14b's group (G = 5, hd = 128)
    (1, 128, 2, 1, 256, 64, 128),   # gemma-style hd = 256 (32-key tiles), windowed
])
def test_flash_bf16_p_rounding_stays_within_tolerance(B, S, KV, G, hd, window, block):
    (jq, jk, jv), (q, k, v) = _arrays(S + G, "bfloat16", (B, S, KV, G, hd), (B, S, KV, hd),
                                      (B, S, KV, hd))
    got = flash_mma_emulation(q, k, v, window=window, tk=32 if hd == 256 else 64)
    assert got.dtype == torch.bfloat16
    _close(got, jax_flash_kernel(jq, jk, jv, window=window, block_q=block, block_k=block,
                                 interpret=True), "bfloat16")
    _close(got, jax_flash_ref(jq, jk, jv, window=window), "bfloat16")
    _close(got, flash_attention_ref(q, k, v, window=window).float(), "bfloat16")
