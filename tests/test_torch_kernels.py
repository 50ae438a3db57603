"""The port's fed_agg / fed_opt ops against the reference.

On CPU tensors the port's ops take their plain PyTorch versions; these are
held against the JAX package's Pallas kernels (interpret mode) and its jnp
refs, with the shapes and tolerances of tests/test_kernels.py. The CUDA
kernels themselves are tested on the card (tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fed_agg import ops as jax_ops
from repro.kernels.fed_agg.kernel import fed_agg as jax_fed_agg
from repro.kernels.fed_agg.kernel import fed_opt as jax_fed_opt
from repro.kernels.fed_agg.ref import fed_agg_ref as jax_fed_agg_ref
from repro.kernels.fed_agg.ref import fed_opt_ref as jax_fed_opt_ref
from repro_torch.kernels.fed_agg import kernel, ops
from repro_torch.kernels.fed_agg.ref import fed_agg_ref, fed_opt_ref


def _inputs(seed, K, N):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(K, N)).astype(np.float32)
    w = rng.random(K).astype(np.float32)
    return rng, x, w / w.sum()


@pytest.mark.parametrize("K,N", [(2, 128), (3, 8192), (8, 8193), (16, 40000), (32, 7)])
def test_fed_agg_matches_pallas_and_ref(K, N):
    _, x, w = _inputs(K * 1000 + N, K, N)
    got = ops.aggregate_flat(torch.from_numpy(x), w).numpy()
    pallas = np.asarray(jax_fed_agg(jnp.asarray(x), jnp.asarray(w), interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jax_fed_agg_ref(x, w)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("K,N", [(65, 8192), (130, 8193), (200, 4000)])
def test_fed_agg_wide_fleet_matches_pallas_streaming(K, N):
    """K above the TPU kernel's 64-row stripe: one op serves every K."""
    _, x, w = _inputs(K + N, K, N)
    got = ops.aggregate_flat(torch.from_numpy(x), w).numpy()
    pallas = np.asarray(jax_fed_agg(jnp.asarray(x), jnp.asarray(w), interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("variant", ["adam", "yogi", "adagrad"])
@pytest.mark.parametrize("K,N", [(3, 4096), (5, 8193)])
def test_fed_opt_matches_fused_pallas(variant, K, N):
    rng, x, w = _inputs(N + ord(variant[0]), K, N)
    p = rng.normal(size=(N,)).astype(np.float32)
    m = rng.normal(size=(N,)).astype(np.float32) * 0.1
    v = np.abs(rng.normal(size=(N,))).astype(np.float32) * 0.01
    got = ops.fed_opt_flat(torch.from_numpy(x), w, *map(torch.from_numpy, (p, m, v)),
                           variant=variant, server_lr=0.3, beta1=0.9, beta2=0.95, tau=1e-2)
    pallas = jax_fed_opt(jnp.asarray(x), jnp.asarray(w), jnp.asarray(p), jnp.asarray(m),
                         jnp.asarray(v), interpret=True, lr=0.3, b1=0.9, b2=0.95, tau=1e-2,
                         variant=variant)
    for g, r, name in zip(got, pallas, ("x", "m", "v")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5,
                                   err_msg=f"{variant}/{name}")


def test_fed_opt_wide_fleet_matches_two_pass_pallas():
    K, N = 64 + 33, 4097
    rng, x, w = _inputs(K, K, N)
    p = rng.normal(size=(N,)).astype(np.float32)
    zeros = np.zeros((N,), np.float32)
    hp = dict(lr=0.5, b1=0.9, b2=0.99, tau=1e-2, variant="yogi")
    got = fed_opt_ref(*map(torch.from_numpy, (x, w, p, zeros, zeros)), **hp)
    pallas = jax_fed_opt(*map(jnp.asarray, (x, w, p, zeros, zeros)), interpret=True, **hp)
    for g, r in zip(got, pallas):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5)


def test_fed_opt_multi_step_stateful_matches_reference():
    """State threaded through four rounds in both packages, as FedAdam does."""
    rng = np.random.default_rng(0)
    K, N = 4, 1000
    w = np.full((K,), 1.0 / K, np.float32)
    x_j = rng.normal(size=(N,)).astype(np.float32)
    m_j = v_j = np.zeros((N,), np.float32)
    x_t, m_t, v_t = (torch.from_numpy(a.copy()) for a in (x_j, m_j, v_j))
    hp = dict(variant="adam", server_lr=0.5, beta1=0.9, beta2=0.99, tau=1e-2)
    for step in range(4):
        stacked = rng.normal(size=(K, N)).astype(np.float32)
        x_t, m_t, v_t = ops.fed_opt_flat(torch.from_numpy(stacked), w, x_t, m_t, v_t, **hp)
        x_j, m_j, v_j = jax_ops.fed_opt_flat(stacked, w, x_j, m_j, v_j, force_kernel=True, **hp)
        for g, r in zip((x_t, m_t, v_t), (x_j, m_j, v_j)):
            np.testing.assert_allclose(g.numpy(), r, rtol=1e-4, atol=1e-5, err_msg=f"step {step}")


def test_plain_versions_match_jnp_refs_on_strided_stack():
    """The strategies' stack has rows padded to a multiple of 32 elements;
    the ops read such a strided view exactly as a contiguous stack."""
    rng, x, w = _inputs(7, 4, 1001)
    padded = torch.zeros(4, 1024)
    padded[:, :1001] = torch.from_numpy(x)
    view = padded[:, :1001]
    out = torch.empty(1001)
    assert ops.aggregate_flat(view, w, out=out) is out
    np.testing.assert_array_equal(out.numpy(), ops.aggregate_flat(torch.from_numpy(x), w).numpy())
    np.testing.assert_allclose(fed_agg_ref(view, torch.from_numpy(w)).numpy(),
                               np.asarray(jax_fed_agg_ref(x, w)), rtol=1e-5, atol=1e-6)
    p, m, v = (rng.normal(size=(1001,)).astype(np.float32) for _ in range(3))
    v = np.abs(v)
    for variant in ("adam", "yogi", "adagrad"):
        got = fed_opt_ref(view, torch.from_numpy(w), *map(torch.from_numpy, (p, m, v)),
                          lr=0.1, b1=0.8, b2=0.9, tau=1e-3, variant=variant)
        want = jax_fed_opt_ref(x, w, p, m, v, lr=0.1, b1=0.8, b2=0.9, tau=1e-3, variant=variant)
        for g, r in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)


def test_yogi_sign_is_zero_at_zero():
    """jnp.sign(0) == 0: where v == Δ², yogi leaves v unchanged."""
    x = torch.tensor([[1.0, 2.0]])
    w = torch.ones(1)
    p = torch.tensor([3.0, 2.0])  # Δ = (2, 0)
    v = torch.tensor([4.0, 0.0])  # v == Δ² in both columns
    _, _, v_new = fed_opt_ref(x, w, p, torch.zeros(2), v, lr=0.1, b1=0.9, b2=0.5,
                              tau=1e-3, variant="yogi")
    np.testing.assert_array_equal(v_new.numpy(), v.numpy())


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel on CUDA tensors or raises; it never runs
    the plain version itself (that is ops.py's CPU branch)."""
    x, w = torch.ones(2, 8), torch.full((2,), 0.5)
    before = dict(kernel.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.fed_agg(x, w)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.fed_opt(x, w, torch.ones(8), torch.zeros(8), torch.zeros(8),
                       lr=0.1, b1=0.9, b2=0.99, tau=1e-3)
    assert kernel.LAUNCHES == before
    np.testing.assert_allclose(ops.aggregate_flat(x, w).numpy(), np.ones(8))
    assert kernel.LAUNCHES == before
