"""The arithmetic of the port's bf16 ``ssd_scan`` kernel, in plain PyTorch on
the CPU, against the reference.

The CUDA kernel computes each chunk's own contribution to the state apart,
chains the chunks of a thread-block cluster (and its rounds, where there are
more chunks than blocks) through distributed shared memory, and does its
products on the tensor cores with bf16 operands: the decayed scores, the
state entering a chunk, and the state update's x o decay, each split into
two bf16 terms. ``ssd_cluster_ref`` emulates that arithmetic; here it is held

* in f32 against the JAX package's Pallas kernel (interpret mode) and its
  ``ssd_scan_ref`` at the reference's four sweeps, at its 1e-4;
* with bf16 operands, at the model's decays, against ``ssd_chunked`` in f64
  at the card checks' tolerances (``chip_smoke.py``'s ``check_ssd``): y at
  2e-2 with atol scaled by min(1, max|want|), the final state at 1e-4
  relative to its largest value, over clusters of 1, 3 and 8 blocks, rounds
  and a ragged S;

and two cases show why the operands are split: rounded to one bf16 term
each, the final state misses its tolerance, and so does y where slowly
decaying heads sum many scores.

The CUDA kernel itself is tested on the card (tests/test_torch_cuda.py).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.kernel import ssd_scan as jax_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ssd_scan_ref
from repro_torch.kernels.ssd_scan.kernel import MAX_CLUSTER, cluster_size
from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_cluster_ref

SWEEPS = [(2, 128, 64, 32, 32), (3, 256, 64, 128, 64), (1, 512, 128, 64, 128),
          (2, 256, 64, 128, 256)]  # BH, S, P, N, chunk: tests/test_kernels.py's
# The model's decays at both ends: A = -exp(A_log) with A_log = log(1..24)
# (mamba2-130m's 24 heads); at A = -24 the running sum of dA reaches ~-5000
# in a chunk of 256.
MODEL_A = (-1.0, -8.0, -16.0, -24.0)


@functools.lru_cache(maxsize=None)
def _sweep(BH, S, P, N, chunk):
    """The reference's sweep inputs (numpy, seeded) and the JAX kernel's and
    ref's outputs on them."""
    rng = np.random.default_rng(BH * S + P)
    x = (rng.standard_normal((BH, S, P)) * 0.5).astype(np.float32)
    dA = -np.log1p(np.exp(rng.standard_normal((BH, S)))).astype(np.float32)  # -softplus
    Bm, Cm = ((rng.standard_normal((BH, S, N)) * 0.5).astype(np.float32) for _ in range(2))
    args = [jnp.asarray(t) for t in (x, dA, Bm, Cm)]
    kernel = np.asarray(jax_ssd_scan(*args, chunk=chunk, interpret=True))
    ref = np.asarray(jax_ssd_scan_ref(*args, chunk=chunk))
    return (x, dA, Bm, Cm), kernel, ref


@pytest.mark.parametrize("cluster", [1, 3, MAX_CLUSTER])
@pytest.mark.parametrize("BH,S,P,N,chunk", SWEEPS)
def test_cluster_arithmetic_f32_matches_the_jax_kernel(BH, S, P, N, chunk, cluster):
    (x, dA, Bm, Cm), want_kernel, want_ref = _sweep(BH, S, P, N, chunk)
    t = [torch.from_numpy(a) for a in (x, dA, Bm, Cm)]
    y, _ = ssd_cluster_ref(t[0][:, :, None], t[1][:, :, None], t[2][:, :, None], t[3][:, :, None],
                           chunk, cluster=cluster, bf16_products=False)
    got = y[:, :, 0].numpy()
    np.testing.assert_allclose(got, want_kernel, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, want_ref, rtol=1e-4, atol=1e-4)


def _model_case(seed, B, S, P, N, *, init: bool, heads=MODEL_A):
    """Mamba2 SSD inputs as the model makes them (chip_smoke.py's ssd_case):
    dt = softplus(N(0,1)), dA = dt*A for A in ``heads``, x = bf16(xh)*bf16(dt)
    in bf16, B/C (B,S,N) bf16 shared by the heads; an f32 initial state or
    None."""
    rng = np.random.default_rng(seed)
    H = len(heads)
    dt = torch.from_numpy(np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32))
    xh = torch.from_numpy((rng.standard_normal((B, S, H, P)) * 0.5).astype(np.float32))
    x = xh.to(torch.bfloat16) * dt[..., None].to(torch.bfloat16)
    Bm, Cm = (torch.from_numpy((rng.standard_normal((B, S, N)) * 0.5).astype(np.float32))
              .to(torch.bfloat16) for _ in range(2))
    dA = dt * torch.tensor(heads)
    state = (torch.from_numpy((rng.standard_normal((B, H, P, N)) * 0.3).astype(np.float32))
             if init else None)
    return x, dA, Bm, Cm, state


def _want_f64(x, dA, Bm, Cm, chunk, state):
    shape = (*Bm.shape[:2], x.shape[2], Bm.shape[-1])
    return ssd_chunked(x.double(), dA.double(), Bm[:, :, None].expand(shape).double(),
                       Cm[:, :, None].expand(shape).double(), chunk,
                       initial_state=None if state is None else state.double())


def _state_close(got, want) -> bool:
    return torch.allclose(got.double(), want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("S,chunk,cluster,init", [
    (1024, 256, 1, False),            # 4 chunks, one block: 4 rounds
    (1024, 256, 3, True),             # 2 rounds, the second with 1 of 3 ranks
    (1024, 256, MAX_CLUSTER, False),  # 4 of 8 ranks in one round
    (2048 + 77, 256, MAX_CLUSTER, True),  # 9 chunks: 2 rounds, the last chunk ragged
    (2048, 256, MAX_CLUSTER, False),  # the serving prefill's 8 chunks in one round
    (77, 32, MAX_CLUSTER, True),      # 3 chunks of 32, the last ragged
    (200, 64, 3, False),              # nc = 4, not a multiple of the cluster
])
def test_cluster_arithmetic_bf16_at_the_models_decay(S, chunk, cluster, init):
    x, dA, Bm, Cm, state = _model_case(S + cluster, 1, S, 64, 128, init=init)
    want_y, want_state = _want_f64(x, dA, Bm, Cm, chunk, state)
    got_y, got_state = ssd_cluster_ref(x, dA, Bm, Cm, chunk, state, cluster=cluster)
    assert got_y.dtype == torch.bfloat16 and torch.isfinite(got_y.float()).all()
    atol = 2e-2 * min(1.0, float(want_y.abs().max()))
    torch.testing.assert_close(got_y.double(), want_y, rtol=2e-2, atol=atol)
    assert _state_close(got_state, want_state), float((got_state.double() - want_state).abs().max())


def test_cluster_size_does_not_change_the_arithmetic():
    """The scan chains the same steps in the same order whatever the cluster
    size: y and the final state are equal bit for bit."""
    x, dA, Bm, Cm, state = _model_case(7, 1, 1000, 64, 32, init=True)
    outs = [ssd_cluster_ref(x, dA, Bm, Cm, 128, state, cluster=n) for n in (1, 3, 8)]
    for y, s in outs[1:]:
        assert torch.equal(y, outs[0][0]) and torch.equal(s, outs[0][1])


@pytest.mark.parametrize("P,N", [(128, 32), (128, 128)])
def test_cluster_arithmetic_bf16_other_widths(P, N):
    x, dA, Bm, Cm, state = _model_case(P + N, 2, 300, P, N, init=True)
    want_y, want_state = _want_f64(x, dA, Bm, Cm, 128, state)
    got_y, got_state = ssd_cluster_ref(x, dA, Bm, Cm, 128, state, cluster=2)
    atol = 2e-2 * min(1.0, float(want_y.abs().max()))
    torch.testing.assert_close(got_y.double(), want_y, rtol=2e-2, atol=atol)
    assert _state_close(got_state, want_state)


def test_one_bf16_term_in_the_state_update_misses_the_final_state_tolerance():
    """Why the kernel splits x o decay into two bf16 terms: rounded to one,
    the final state is ~1e-3 off (relative ~3e-4), over its 1e-4; split, it
    meets it. (Of the operands ``split`` rounds, only x o decay reaches the
    final state.)"""
    x, dA, Bm, Cm, _ = _model_case(0, 1, 1024, 64, 128, init=False)
    _, want_state = _want_f64(x, dA, Bm, Cm, 256, None)
    _, split = ssd_cluster_ref(x, dA, Bm, Cm, 256, cluster=MAX_CLUSTER)
    _, single = ssd_cluster_ref(x, dA, Bm, Cm, 256, cluster=MAX_CLUSTER, split=False)
    assert _state_close(split, want_state)
    assert not _state_close(single, want_state)


def test_one_bf16_term_in_the_products_misses_the_y_tolerance():
    """Why the kernel also splits the decayed scores and the entering state:
    rounded to one bf16 term each, y misses its tolerance (2e-2, atol scaled
    by min(1, max|want|)) by 11% at an output near zero, on four heads at the
    slowest decay (A = -1), which sum the most scores; split, y is as close
    as the plain f32 version (~0.18 of it). An S = 8,192 draw on the card
    missed the same way, on its A = -1 head."""
    x, dA, Bm, Cm, state = _model_case(26, 1, 4096, 64, 128, init=True, heads=(-1.0,) * 4)
    want_y, _ = _want_f64(x, dA, Bm, Cm, 256, state)
    atol = 2e-2 * min(1.0, float(want_y.abs().max()))

    def worst(y):  # the largest error over what the tolerance allows there
        return float(((y.double() - want_y).abs() / (atol + 2e-2 * want_y.abs())).max())

    split = worst(ssd_cluster_ref(x, dA, Bm, Cm, 256, state, cluster=MAX_CLUSTER)[0])
    single = worst(ssd_cluster_ref(x, dA, Bm, Cm, 256, state, cluster=MAX_CLUSTER, split=False)[0])
    assert split < 0.25 and single > 1.0, (split, single)


# Clusters of 1..8 blocks an H100 holds at once at one block an SM (the
# bf16 kernel's shared memory; chip_smoke.py's cluster sweep prints them).
RESIDENT = [132, 66, 39, 30, 22, 17, 15, 15]


@pytest.mark.parametrize("n_chunks,n_pairs,want", [
    (8, 192, 2),    # the serving prefill: 3 waves of 4 rounds (2 waves of 8 at n = 1)
    (8, 96, 8),     # B = 4: 7 waves of one round
    (64, 24, 4),    # B = 1, S = 16,384: every cluster of 4 at once, 16 rounds
    (1, 192, 1),    # one chunk: a cluster of one
    (3, 8, 3),      # fewer chunks than the portable size
])
def test_cluster_rule_takes_the_fewest_rounds(n_chunks, n_pairs, want):
    assert cluster_size(n_chunks, n_pairs, RESIDENT) == want


@pytest.mark.parametrize("n_chunks,n_pairs", [(1, 1), (9, 7), (64, 1000), (2, 300)])
def test_cluster_rule_stays_in_range(n_chunks, n_pairs):
    n = cluster_size(n_chunks, n_pairs, RESIDENT)
    assert 1 <= n <= min(MAX_CLUSTER, n_chunks)
