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


ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,KV,G,hd,window", [(2, 256, 2, 2, 64, 0), (1, 333, 2, 3, 128, 100),
                                                (1, 128, 2, 2, 256, 64), (8, 512, 8, 4, 64, 0)])
def test_flash_attention_kernel_matches_plain(cuda, dtype, B, S, KV, G, hd, window):
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    g = torch.Generator(device=cuda).manual_seed(S)
    q = torch.randn(B, S, KV, G, hd, device=cuda, generator=g).to(dtype)
    k, v = (torch.randn(B, S, KV, hd, device=cuda, generator=g).to(dtype) for _ in range(2))
    before = fk.LAUNCHES["flash_attention"]
    got = fk.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["flash_attention"] == before + 1 and got.dtype == dtype
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), flash_attention_ref(q, k, v, window=window).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,KV,G,hd,C", [(2, 2, 4, 64, 1024), (8, 8, 4, 64, 576),
                                         (1, 2, 2, 256, 256), (3, 1, 6, 128, 1000)])
def test_decode_attention_kernel_matches_plain(cuda, dtype, B, KV, G, hd, C):
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    g = torch.Generator(device=cuda).manual_seed(C)
    q = torch.randn(B, KV, G, hd, device=cuda, generator=g).to(dtype)
    k, v = (torch.randn(B, C, KV, hd, device=cuda, generator=g).to(dtype) for _ in range(2))
    valid = torch.rand(C, device=cuda, generator=g) < 0.7
    before = dk.LAUNCHES["decode_attention"]
    got = dk.decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert dk.LAUNCHES["decode_attention"] == before + 1 and got.dtype == dtype
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), decode_attention_ref(q, k, v, valid).float(),
                               rtol=tol, atol=tol)


def test_serving_path_runs_the_attention_kernels(cuda):
    """Prefill through flash_attention and decode through decode_attention
    give the decode-only loop's tokens, and both kernels were launched."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch.serve import serve_batch, serve_batch_loop
    from repro_torch.models import build_model

    cfg = get_config("granite-3-2b").reduced()
    params = build_model(cfg).init(0, device=cuda)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24), dtype=np.int32)
    fk.reset_launches()
    dk.reset_launches()
    fast = serve_batch(cfg, params, prompts, new_tokens=5)
    assert fk.LAUNCHES["flash_attention"] == cfg.n_layers
    assert dk.LAUNCHES["decode_attention"] == 4 * cfg.n_layers
    slow = serve_batch_loop(cfg, params, prompts, new_tokens=5)
    assert torch.equal(fast, slow)
