"""The port's CUDA kernels and device paths, on the card.

Every test here needs an NVIDIA GPU (Hopper, sm_90a) and ``nvcc``; without a
card they skip. This file imports torch and the port only, so it runs on a
machine without JAX:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.serialize import NodeUpdate
from repro_torch.core.strategies import FedAdam, FedAvg
from repro_torch.kernels.fed_agg import kernel
from repro_torch.kernels.fed_agg.ref import fed_agg_ref, fed_opt_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("K,N,ld", [(2, 421642, 421642), (4, 11176970, 11176992),
                                    (8, 8193, 8193), (65, 8192, 8192), (200, 4000, 4000),
                                    (3, 7, 8)])
def test_fed_agg_kernel_matches_plain(cuda, K, N, ld):
    g = torch.Generator(device=cuda).manual_seed(K)
    x = torch.randn(K, ld, device=cuda, generator=g)[:, :N]
    w = torch.rand(K, device=cuda, generator=g)
    w /= w.sum()
    before = kernel.LAUNCHES["fed_agg"]
    got = kernel.fed_agg(x, w)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES["fed_agg"] == before + 1
    torch.testing.assert_close(got, fed_agg_ref(x, w), rtol=1e-5 if K <= 64 else 1e-4, atol=1e-5)


@pytest.mark.parametrize("variant", ["adam", "yogi", "adagrad"])
@pytest.mark.parametrize("K,N", [(4, 100003), (130, 8193)])
def test_fed_opt_kernel_matches_plain(cuda, variant, K, N):
    g = torch.Generator(device=cuda).manual_seed(N)
    x = torch.randn(K, N, device=cuda, generator=g)
    w = torch.rand(K, device=cuda, generator=g)
    w /= w.sum()
    p = torch.randn(N, device=cuda, generator=g)
    m = torch.randn(N, device=cuda, generator=g) * 0.1
    v = torch.rand(N, device=cuda, generator=g) * 0.01
    hp = dict(lr=0.3, b1=0.9, b2=0.95, tau=1e-2, variant=variant)
    got = kernel.fed_opt(x, w, p, m, v, **hp)
    torch.cuda.synchronize()
    for a, b in zip(got, fed_opt_ref(x, w, p, m, v, **hp)):
        torch.testing.assert_close(a, b, rtol=1e-5 if K <= 64 else 1e-4, atol=1e-5)


def test_strategies_on_cuda_launch_the_kernels(cuda):
    rng = np.random.default_rng(0)
    tree = lambda: {"a": rng.normal(size=(33, 7)).astype(np.float32),
                    "b": rng.normal(size=(5,)).astype(np.float32)}
    own = NodeUpdate(tree(), 10, "own", counter=1)
    peer = NodeUpdate(tree(), 30, "peer", counter=1)
    kernel.reset_launches()
    out = FedAvg().aggregate(own, [peer])
    assert out["a"].is_cuda and kernel.LAUNCHES["fed_agg"] == 1
    want = 0.25 * own.params["a"] + 0.75 * peer.params["a"]
    np.testing.assert_allclose(out["a"].cpu().numpy(), want, rtol=1e-6, atol=1e-6)
    FedAdam(server_lr=0.1).aggregate(own, [peer])
    assert kernel.LAUNCHES["fed_opt"] == 1
