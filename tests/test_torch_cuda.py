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
    fedavg = FedAvg()
    out = fedavg.aggregate(own, [peer])
    assert out["a"].is_cuda and kernel.LAUNCHES["fed_agg"] == 1
    assert fedavg.launches == {"fed_agg": 1, "fed_opt": 0}  # what a node counts
    want = 0.25 * own.params["a"] + 0.75 * peer.params["a"]
    np.testing.assert_allclose(out["a"].cpu().numpy(), want, rtol=1e-6, atol=1e-6)
    fedadam = FedAdam(server_lr=0.1)
    fedadam.aggregate(own, [peer])
    assert kernel.LAUNCHES["fed_opt"] == 1
    assert fedadam.launches == {"fed_agg": 0, "fed_opt": 1}


def test_sharded_delta_federation_on_the_card(cuda, tmp_path):
    """Four nodes in two groups of a ``shard2+`` store push a small MnistCNN
    through ``delta(chain=2)`` and aggregate on the card: fed_agg launches,
    and a fresh reader rebuilds every latest deposit bit for bit (checked
    against its self-contained history blob)."""
    from repro_torch.api import connect
    from repro_torch.core import AsyncFederatedNode, balanced_groups
    from repro_torch.core.serialize import deserialize_update_flat, peek_meta
    from repro_torch.core.tree import LeafSpec
    from repro_torch.models.cnn import MnistCNN

    uri = f"shard2+{tmp_path}"
    names = [f"node{i}" for i in range(4)]
    groups = balanced_groups(names, 2)
    init = MnistCNN().init(0, device=cuda)
    spec = LeafSpec.of(init)
    nodes = [AsyncFederatedNode(strategy=FedAvg(), node_id=n, store=connect(
        uri, transport="delta(chain=2)", keep_history=True, group_of=groups)) for n in names]
    kernel.reset_launches()
    g = torch.Generator(device=cuda).manual_seed(0)
    params = [init for _ in names]
    for _round in range(4):
        for i, node in enumerate(nodes):
            flat = torch.empty(spec.num_params, device=cuda)
            spec.flatten_into(params[i], flat)
            idx = torch.randint(0, spec.num_params, (2000,), device=cuda, generator=g)
            flat[idx] += 0.01 * torch.randn(2000, device=cuda, generator=g)
            params[i] = spec.unflatten(flat)
            out = node.update_parameters(params[i], 64)
            if out is not None:
                params[i] = out
    torch.cuda.synchronize()
    assert kernel.LAUNCHES["fed_agg"] >= 1
    reader = connect(uri, group_of=groups)
    for node in nodes:
        got = reader.pull_node(node.node_id)
        folder = reader.folders.group_folder(groups[node.node_id])
        exact = deserialize_update_flat(
            folder.get(f"history/{node.node_id}/{got.counter:06d}"), {})
        assert got.counter == node.counter - 1
        np.testing.assert_array_equal(got.flat, exact.flat)
    assert any("delta_of" in peek_meta(reader.folders.group_folder(groups[n]).get(f"latest/{n}"))
               for n in names)


ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def assert_attention_close(got, want, dtype):
    """The reference's tolerances, with bf16's atol scaled by max|want| where
    that is below 1: outputs of ~0.01 (a long cache) would meet a plain 2e-2
    with zeros."""
    tol = atol = ATTN_TOL[dtype]
    if dtype == torch.bfloat16:
        atol = tol * min(1.0, float(want.float().abs().max()))
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,KV,G,hd,window", [
    (2, 256, 2, 2, 64, 0), (1, 333, 2, 3, 128, 100), (1, 128, 2, 2, 256, 64), (8, 512, 8, 4, 64, 0),
    (2, 200, 4, 2, 32, 0),      # hd 32, ragged S
    (1, 256, 8, 5, 128, 0),     # qwen3-14b's group: KV 8, G 5, hd 128
    (1, 333, 16, 1, 256, 0),    # gemma-7b's: KV 16, G 1, hd 256, ragged S
    (2, 200, 2, 16, 64, 50),    # G 16, windowed, ragged
    (1, 96, 1, 64, 64, 0),      # the widest group: one position per q tile
    (1, 64, 1, 32, 256, 16),    # the widest group at hd 256, windowed
    (1, 1, 2, 4, 64, 0),        # S = 1
    (4, 64, 16, 1, 64, 0),      # seamless-m4t-medium's decoder prefill: KV 16, G 1
    (4, 512, 2, 7, 64, 0),      # internvl2-1b's prefix + text: G 7, 9 positions a tile
])
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
    assert_attention_close(got, flash_attention_ref(q, k, v, window=window), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,KV,G,hd,C", [
    (2, 2, 4, 64, 1024), (8, 8, 4, 64, 576), (1, 2, 2, 256, 256), (3, 1, 6, 128, 1000),
    (2, 8, 4, 64, 1), (1, 2, 5, 128, 63), (8, 8, 4, 64, 32768), (2, 2, 16, 64, 1000),
    (1, 16, 1, 256, 576), (2, 2, 4, 32, 100),
    (1, 1, 16, 256, 576),       # the largest block: G 16 at hd 256 (recurrentgemma-9b's group)
    (4, 16, 1, 64, 96),         # seamless-m4t-medium's decoder: 64 prompt + 32 new tokens
    (4, 2, 7, 64, 544),         # internvl2-1b's: 256 patches + 256 text + 32 new tokens
])
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
    assert_attention_close(got, decode_attention_ref(q, k, v, valid), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["invalid_slice", "no_valid_slot"])
def test_decode_attention_kernel_masked_slices(cuda, dtype, case):
    """A split whose slots are all invalid weighs nothing; a ring with no
    valid slot at all gives the plain mean of v, as the reference does."""
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref, split_bounds

    B, KV, G, hd, C = 8, 8, 4, 64, 576
    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn(B, KV, G, hd, device=cuda, generator=g).to(dtype)
    k, v = (torch.randn(B, C, KV, hd, device=cuda, generator=g).to(dtype) for _ in range(2))
    n = dk.split_count(B, KV, C, dk.sm_count(q.device))
    assert n > 1
    if case == "invalid_slice":
        valid = torch.rand(C, device=cuda, generator=g) < 0.7
        lo, hi = split_bounds(C, n)[1]
        valid[lo:hi] = False
    else:
        valid = torch.zeros(C, dtype=torch.bool, device=cuda)
    before = dk.LAUNCHES["decode_attention"]
    got = dk.decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert dk.LAUNCHES["decode_attention"] == before + 1
    assert_attention_close(got, decode_attention_ref(q, k, v, valid), dtype)
    if case == "no_valid_slot":
        assert_attention_close(got, v.float().mean(1)[:, :, None].expand_as(got), dtype)


@pytest.mark.parametrize("n_split", [1, 2, 3, 5, 8])
def test_decode_attention_kernel_any_split_matches_plain(cuda, n_split):
    """Every cluster size gives the plain version's output (C = 1000: ragged
    slices), in one launch."""
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    g = torch.Generator(device=cuda).manual_seed(n_split)
    q = torch.randn(2, 2, 4, 64, device=cuda, generator=g).to(torch.bfloat16)
    k, v = (torch.randn(2, 1000, 2, 64, device=cuda, generator=g).to(torch.bfloat16)
            for _ in range(2))
    valid = torch.rand(1000, device=cuda, generator=g) < 0.7
    before = dk.LAUNCHES["decode_attention"]
    got = dk._launch(q, k, v, valid, n_split=n_split)
    torch.cuda.synchronize()
    assert dk.LAUNCHES["decode_attention"] == before + 1
    assert_attention_close(got, decode_attention_ref(q, k, v, valid), torch.bfloat16)


def test_decode_split_fills_the_card(cuda):
    """At the serving shape the split gives at least two blocks per SM."""
    from repro_torch.kernels.decode_attention import kernel as dk

    sms = dk.sm_count(torch.device("cuda"))
    assert 8 * 8 * dk.split_count(8, 8, 576, sms) >= 2 * sms


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


def _ssd_inputs(dev, g, B, S, H, P, N, dtype, *, shared_bc: bool):
    """Model-layout SSD inputs: x scaled as a dt-premultiplied input, dA
    negative (dt·A), B/C shared by the heads or per head."""
    x = (torch.randn(B, S, H, P, device=dev, generator=g) * 0.5).to(dtype)
    dA = -torch.nn.functional.softplus(torch.randn(B, S, H, device=dev, generator=g))
    bc = (B, S, N) if shared_bc else (B, S, H, N)
    Bm, Cm = ((torch.randn(*bc, device=dev, generator=g) * 0.5).to(dtype) for _ in range(2))
    return x, dA, Bm, Cm


@pytest.mark.parametrize("BH,S,P,N,chunk", [(2, 128, 64, 32, 32), (3, 256, 64, 128, 64),
                                             (1, 512, 128, 64, 128), (2, 256, 64, 128, 256)])
def test_ssd_scan_kernel_matches_plain_at_reference_sweeps(cuda, BH, S, P, N, chunk):
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref, ssd_scan_sequential

    g = torch.Generator(device=cuda).manual_seed(BH * S)
    x, dA, Bm, Cm = (t[:, :, 0] for t in _ssd_inputs(cuda, g, BH, S, 1, P, N, torch.float32,
                                                       shared_bc=False))
    before = sk.LAUNCHES["ssd_scan"]
    got = sk.ssd_scan(x, dA, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["ssd_scan"] == before + 1
    torch.testing.assert_close(got, ssd_scan_ref(x, dA, Bm, Cm, chunk=chunk), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got, ssd_scan_sequential(x, dA, Bm, Cm), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,P,N,chunk,shared", [(2, 1000, 3, 64, 128, 256, True),
                                                     (1, 200, 2, 128, 32, 64, False),
                                                     (2, 77, 4, 64, 64, 32, True)])
def test_ssd_kernel_initial_and_final_state(cuda, dtype, B, S, H, P, N, chunk, shared):
    """Model layout, ragged S, B/C shared by the heads (read with a head
    stride of 0), a nonzero initial state, and the final state written in
    place over it, against the plain ssd_chunked."""
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked

    g = torch.Generator(device=cuda).manual_seed(S)
    x, dA, Bm, Cm = _ssd_inputs(cuda, g, B, S, H, P, N, dtype, shared_bc=shared)
    init = torch.randn(B, H, P, N, device=cuda, generator=g) * 0.3
    wide = (B, S, H, N)
    want_y, want_state = ssd_chunked(x, dA, Bm[:, :, None].expand(wide) if shared else Bm,
                                     Cm[:, :, None].expand(wide) if shared else Cm, chunk,
                                     initial_state=init)
    state = init.clone()
    got_y, got_state = sk.ssd(x, dA, Bm, Cm, chunk=chunk, initial_state=state, state_out=state)
    torch.cuda.synchronize()
    assert got_state.data_ptr() == state.data_ptr() and got_y.dtype == dtype
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got_y.float(), want_y.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(got_state, want_state, rtol=1e-4, atol=1e-4 if dtype == torch.float32
                               else 1e-3)


def test_ssd_kernel_raises_on_what_it_does_not_take(cuda):
    from repro_torch.kernels.ssd_scan import kernel as sk

    x = torch.zeros(1, 64, 1, 96, device=cuda)  # P = 96
    dA, bc = torch.zeros(1, 64, 1, device=cuda), torch.zeros(1, 64, 32, device=cuda)
    with pytest.raises(ValueError, match="P in"):
        sk.ssd(x, dA, bc, bc, chunk=32)
    with pytest.raises(ValueError, match="CUDA"):
        sk.ssd(x.cpu(), dA.cpu(), bc.cpu(), bc.cpu(), chunk=32)


def test_mamba2_serving_path_runs_the_ssd_kernel(cuda):
    """The Mamba2 bulk prefill runs ssd_scan once per layer, and gives the
    tokens of the decode recurrence alone, which never launches it."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.launch.serve import serve_batch, serve_batch_loop
    from repro_torch.models import build_model

    cfg = get_config("mamba2-130m").reduced()
    params = build_model(cfg).init(0, device=cuda)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 75), dtype=np.int32)
    sk.reset_launches()
    fast = serve_batch(cfg, params, prompts, new_tokens=5)
    assert sk.LAUNCHES["ssd_scan"] == cfg.n_layers
    slow = serve_batch_loop(cfg, params, prompts, new_tokens=5)
    assert sk.LAUNCHES["ssd_scan"] == cfg.n_layers
    assert torch.equal(fast, slow)


def test_ssd_kernel_at_the_models_decay_against_f64(cuda):
    """At the model's dA (A = -(1..24), dt = softplus(N(0,1))) the running sum
    of dA reaches ~-5000 in a chunk; the kernel (f64 prefix sums) stays within
    the reference's 1e-4 of the plain version computed in f64, where the plain
    version's own f32 arithmetic does not."""
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked

    g = torch.Generator(device=cuda).manual_seed(3)
    B, S, H, P, N, chunk = 2, 1000, 24, 64, 128, 256
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, device=cuda, generator=g))
    dA = dt * -torch.arange(1, H + 1, dtype=torch.float32, device=cuda)
    x = torch.randn(B, S, H, P, device=cuda, generator=g) * 0.5 * dt[..., None]
    Bm, Cm = (torch.randn(B, S, N, device=cuda, generator=g) * 0.5 for _ in range(2))
    init = torch.randn(B, H, P, N, device=cuda, generator=g) * 0.3
    wide = (B, S, H, N)
    want_y, want_state = ssd_chunked(x.double(), dA.double(), Bm[:, :, None].expand(wide).double(),
                                     Cm[:, :, None].expand(wide).double(), chunk,
                                     initial_state=init.double())
    got_y, got_state = sk.ssd(x, dA, Bm, Cm, chunk=chunk, initial_state=init)
    torch.cuda.synchronize()
    torch.testing.assert_close(got_y.double(), want_y, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got_state.double(), want_state, rtol=1e-4,
                               atol=1e-4 * float(want_state.abs().max()))


def _ssd_model_case(dev, g, B, S, H, P, N, dtype):
    """Mamba2 SSD inputs as the model makes them: dt = softplus(N(0,1)),
    A = -(1..H), x = bf16(xh)·bf16(dt), dA = dt·A in f32, B/C (B,S,N) shared
    by the heads."""
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, device=dev, generator=g))
    A = -torch.arange(1, H + 1, dtype=torch.float32, device=dev)
    x = (torch.randn(B, S, H, P, device=dev, generator=g) * 0.5).to(dtype) * dt[..., None].to(dtype)
    Bm, Cm = ((torch.randn(B, S, N, device=dev, generator=g) * 0.5).to(dtype) for _ in range(2))
    return x, dt * A, Bm, Cm


def _ssd_against_f64(x, dA, Bm, Cm, chunk, init, got_y, got_state):
    """bf16 y at 2e-2 (atol scaled by min(1, max|want|)) and the final state
    at 1e-4 relative to its largest value, against ssd_chunked in f64."""
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked

    wide = (*Bm.shape[:2], x.shape[2], Bm.shape[-1])
    want_y, want_state = ssd_chunked(x.double(), dA.double(), Bm[:, :, None].expand(wide).double(),
                                     Cm[:, :, None].expand(wide).double(), chunk,
                                     initial_state=None if init is None else init.double())
    assert torch.isfinite(got_y.float()).all() and got_y.dtype == x.dtype
    atol = 2e-2 * min(1.0, float(want_y.abs().max()))
    torch.testing.assert_close(got_y.double(), want_y, rtol=2e-2, atol=atol)
    torch.testing.assert_close(got_state.double(), want_state, rtol=1e-4,
                               atol=1e-4 * float(want_state.abs().max()))


@pytest.mark.parametrize("B,S,H,chunk", [
    (8, 2048, 24, 256),         # mamba2-130m's serving prefill: 8 chunks, one cluster round
    (1, 8192, 24, 256),         # 32 chunks: 4 rounds
    (2, 2048 + 77, 24, 256),    # 9 chunks: 2 rounds, the last chunk ragged
    (2, 200, 24, 256),          # one chunk: a cluster of 1
    (1, 2560, 24, 256),         # 10 chunks: not a multiple of the cluster
    (1, 16384, 24, 256),        # a single long prompt: 64 chunks, 8 rounds
    (2, 77, 4, 32),             # 3 chunks of 32, the last ragged
])
def test_ssd_bf16_cluster_kernel_against_f64(cuda, B, S, H, chunk):
    """The bf16 cluster kernel at the model's decays, with a nonzero initial
    state and the final state written in place over it, one launch a call."""
    from repro_torch.kernels.ssd_scan import kernel as sk

    g = torch.Generator(device=cuda).manual_seed(S + B)
    x, dA, Bm, Cm = _ssd_model_case(cuda, g, B, S, H, 64, 128, torch.bfloat16)
    init = torch.randn(B, H, 64, 128, device=cuda, generator=g) * 0.3
    state = init.clone()
    before = sk.LAUNCHES["ssd_scan"]
    got_y, got_state = sk.ssd(x, dA, Bm, Cm, chunk=chunk, initial_state=state, state_out=state)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["ssd_scan"] == before + 1
    assert got_state.data_ptr() == state.data_ptr()
    _ssd_against_f64(x, dA, Bm, Cm, chunk, init, got_y, got_state)


@pytest.mark.parametrize("cluster", range(1, 9))
def test_ssd_bf16_any_cluster_matches_plain(cuda, cluster):
    """Every cluster size the kernel takes (1 to 8 blocks, rounds of chunks
    where there are more) gives the same scan."""
    from repro_torch.kernels.ssd_scan import kernel as sk

    g = torch.Generator(device=cuda).manual_seed(cluster)
    B, S, H, chunk = 1, 2048 + 77, 6, 256
    x, dA, Bm, Cm = _ssd_model_case(cuda, g, B, S, H, 64, 128, torch.bfloat16)
    init = torch.randn(B, H, 64, 128, device=cuda, generator=g) * 0.3
    got_y, got_state = sk._launch(x, dA, Bm, Cm, chunk=chunk, initial_state=init, cluster=cluster)
    torch.cuda.synchronize()
    _ssd_against_f64(x, dA, Bm, Cm, chunk, init, got_y, got_state)


@pytest.mark.parametrize("P,N", [(64, 32), (64, 64), (128, 32), (128, 64), (128, 128)])
def test_ssd_bf16_other_widths(cuda, P, N):
    from repro_torch.kernels.ssd_scan import kernel as sk

    g = torch.Generator(device=cuda).manual_seed(P + N)
    B, S, H, chunk = 2, 600, 3, 128
    x, dA, Bm, Cm = _ssd_model_case(cuda, g, B, S, H, P, N, torch.bfloat16)
    init = torch.randn(B, H, P, N, device=cuda, generator=g) * 0.3
    got_y, got_state = sk.ssd(x, dA, Bm, Cm, chunk=chunk, initial_state=init)
    torch.cuda.synchronize()
    _ssd_against_f64(x, dA, Bm, Cm, chunk, init, got_y, got_state)


def test_ssd_bf16_model_layout_views(cuda):
    """B and C as the model slices them from the conv output (row stride
    1,792 elements, offset 1,536): read in place, 16-byte aligned."""
    from repro_torch.kernels.ssd_scan import kernel as sk

    g = torch.Generator(device=cuda).manual_seed(11)
    B, S, H, P, N = 2, 700, 24, 64, 128
    conv = (torch.randn(B, S, H * P + 2 * N, device=cuda, generator=g) * 0.5).to(torch.bfloat16)
    xs, Bm, Cm = conv.split([H * P, N, N], dim=-1)
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, device=cuda, generator=g))
    x = xs.reshape(B, S, H, P) * dt[..., None].to(torch.bfloat16)
    dA = dt * -torch.arange(1, H + 1, dtype=torch.float32, device=cuda)
    assert Bm.stride(1) == 1792 and Bm.storage_offset() == 1536
    got_y, got_state = sk.ssd(x, dA, Bm, Cm, chunk=256)
    torch.cuda.synchronize()
    _ssd_against_f64(x, dA, Bm, Cm, 256, None, got_y, got_state)


def test_ssd_bf16_raises_on_misaligned_views(cuda):
    """The bf16 kernel reads B/C rows in 16-byte pieces: a view off that
    grid raises, and nothing is launched or routed elsewhere."""
    from repro_torch.kernels.ssd_scan import kernel as sk

    B, S, H, P, N = 1, 64, 2, 64, 32
    x = torch.zeros(B, S, H, P, device=cuda, dtype=torch.bfloat16)
    dA = torch.zeros(B, S, H, device=cuda)
    conv = torch.zeros(B, S, 2 * N + 1, device=cuda, dtype=torch.bfloat16)
    before = sk.LAUNCHES["ssd_scan"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        sk.ssd(x, dA, conv[..., 1:N + 1], conv[..., N + 1:], chunk=32)
    shifted = torch.zeros(B * S * H * P + 1, device=cuda, dtype=torch.bfloat16)[1:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        sk.ssd(shifted.view(B, S, H, P), dA, conv[..., :N], conv[..., :N], chunk=32)
    assert sk.LAUNCHES["ssd_scan"] == before


def test_ssd_f32_still_runs_the_fma_kernel(cuda):
    """f32 keeps the FMA kernel, off the serving path, at the reference's
    1e-4; a misaligned f32 view is taken (it has no 16-byte copies)."""
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked

    g = torch.Generator(device=cuda).manual_seed(5)
    B, S, H, P, N = 1, 300, 2, 64, 32
    x = torch.randn(B, S, H, P, device=cuda, generator=g) * 0.5
    dA = -torch.nn.functional.softplus(torch.randn(B, S, H, device=cuda, generator=g))
    conv = torch.randn(B, S, 2 * N + 1, device=cuda, generator=g) * 0.5
    Bm, Cm = conv[..., 1:N + 1], conv[..., N + 1:]
    got_y, _ = sk.ssd(x, dA, Bm, Cm, chunk=128)
    wide = (B, S, H, N)
    want_y, _ = ssd_chunked(x, dA, Bm[:, :, None].expand(wide), Cm[:, :, None].expand(wide), 128)
    torch.cuda.synchronize()
    torch.testing.assert_close(got_y, want_y, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch,S", [("pythia-14m", 64), ("pythia-14m", 1280),
                                    ("mamba2-130m", 96)])
def test_training_forward_on_the_card_reaches_no_forward_only_kernel(cuda, arch, S):
    """A training loss (use_flash=False, remat on) on CUDA tensors launches
    none of the forward-only kernels and differentiates: loss and gradients
    equal the CPU's at the reference's 1e-4 (S = 1280 runs chunked_sdpa).
    Serving's bulk prefill of the same model launches one a layer."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.models import build_model
    from repro_torch.training import value_and_grad

    def launches():
        return fk.LAUNCHES["flash_attention"] + sk.LAUNCHES["ssd_scan"]

    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, S + 1), dtype=np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])}
    on_card = lambda tree: tree_map(lambda t: t.to(cuda), tree)  # noqa: E731
    loss_fn = lambda p, b: model.loss(p, b, remat=True)  # noqa: E731
    before = launches()
    (loss, _), grads = value_and_grad(loss_fn, on_card(params), on_card(batch))
    torch.cuda.synchronize()
    assert launches() == before
    (want, _), want_grads = value_and_grad(loss_fn, params, batch)
    torch.testing.assert_close(loss.cpu(), want, rtol=1e-4, atol=1e-4)
    for got, ref in zip(tree_leaves(grads), tree_leaves(want_grads)):
        torch.testing.assert_close(got.cpu(), ref, rtol=1e-4, atol=1e-4)
    with torch.inference_mode():
        model.prefill(on_card(params), on_card(batch)["tokens"],
                      model.init_cache(2, S, device=cuda))
    torch.cuda.synchronize()
    assert launches() == before + cfg.n_layers


@pytest.mark.parametrize("arch,attn_layers", [("recurrentgemma-9b", 2), ("minicpm3-4b", 0),
                                              ("llama4-scout-17b-a16e", 2)])
def test_zoo_serving_runs_the_attention_kernels_per_attention_layer(cuda, arch, attn_layers):
    """At reduced(), f32: the bulk prefill launches flash_attention once per
    GQA attention layer and decode_attention once per such layer per token
    (none for MLA), and gives the decode-only loop's tokens. recurrentgemma's
    prompt of 80 passes its reduced window of 64; the MoE prompt stays at 64
    tokens, under which no choice is dropped."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch.serve import serve_batch, serve_batch_loop
    from repro_torch.models import build_model

    cfg = get_config(arch).reduced()
    params = build_model(cfg).init(0, device=cuda)
    S = 32 if cfg.num_experts else 80
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, S), dtype=np.int32)
    fk.reset_launches()
    dk.reset_launches()
    fast = serve_batch(cfg, params, prompts, new_tokens=5)
    assert fk.LAUNCHES["flash_attention"] == attn_layers
    assert dk.LAUNCHES["decode_attention"] == 4 * attn_layers
    slow = serve_batch_loop(cfg, params, prompts, new_tokens=5)
    assert torch.equal(fast, slow)


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "internvl2-1b"])
def test_encdec_and_prefix_serving_run_the_attention_kernels(cuda, arch):
    """At reduced(), f32: the enc-dec's decoder and the VLM's prefix + prompt
    prefill through flash_attention (one a decoder layer) and decode through
    decode_attention (one a layer a token); the greedy tokens equal the
    port's on the CPU from the same weights, and the enc-dec's bulk prefill
    equals its decode-only loop."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch.serve import serve_batch, serve_batch_loop
    from repro_torch.models import build_model
    from repro_torch.models.frontends import stub_audio_frames, stub_patch_embeddings

    cfg = get_config(arch).reduced()
    cpu_params = build_model(cfg).init(0, device="cpu")
    params = tree_map(lambda t: t.to(cuda), cpu_params)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24), dtype=np.int32)
    if cfg.is_encdec:
        extra = {"frames": stub_audio_frames(1, cfg, 2, 40, device="cpu")}
    else:
        extra = {"embeds": stub_patch_embeddings(1, cfg, 2, device="cpu")}
    fk.reset_launches()
    dk.reset_launches()
    fast = serve_batch(cfg, params, prompts, new_tokens=5, **extra)
    assert fk.LAUNCHES["flash_attention"] == cfg.n_layers
    assert dk.LAUNCHES["decode_attention"] == 4 * cfg.n_layers
    assert torch.equal(fast.cpu(), serve_batch(cfg, cpu_params, prompts, new_tokens=5, **extra))
    if cfg.is_encdec:
        assert torch.equal(fast, serve_batch_loop(cfg, params, prompts, new_tokens=5, **extra))


def test_grok_softcap_served_on_the_card(cuda):
    """grok-1's attn_logit_softcap takes the capped plain attention on the
    card, as the reference routes it: the card equals the CPU (tokens, and
    logits within 2e-5 of the largest), and neither attention kernel runs."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import build_model

    cfg = get_config("grok-1-314b").reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24), dtype=np.int32)
    on_card = tree_map(lambda t: t.to(cuda), params)
    fk.reset_launches()
    dk.reset_launches()
    got = serve_batch(cfg, on_card, prompts, new_tokens=6).cpu()
    torch.cuda.synchronize()
    assert fk.LAUNCHES["flash_attention"] == 0 and dk.LAUNCHES["decode_attention"] == 0
    assert torch.equal(got, serve_batch(cfg, params, prompts, new_tokens=6))
    with torch.inference_mode():
        logits = [model.prefill(p, torch.from_numpy(prompts).to(d), model.init_cache(
            2, 25, device=d))[0].cpu() for p, d in ((on_card, cuda), (params, "cpu"))]
    assert (logits[0] - logits[1]).abs().max() <= 2e-5 * logits[1].abs().max()


@pytest.mark.parametrize("arch", ["granite-3-2b", "mamba2-130m"])
def test_mesh_serving_on_one_card(cuda, tmp_path, arch):
    """A world-1 NCCL group (FileStore) and its (1, 1) host mesh, in a child
    process: ``ServingNode(mesh=)`` serves the tokens of the mesh-less path,
    through the kernels on the local shards, once a layer a prefill
    (flash_attention / ssd_scan) and once a layer a token (decode_attention)."""
    import json

    import torch.multiprocessing as tmp

    import _torch_children as kids

    tmp.start_processes(kids.mesh_cuda_rank, args=(str(tmp_path), arch), nprocs=1,
                        start_method="spawn")  # joins; a child's error raises here
    rec = json.loads((tmp_path / "mesh_cuda.json").read_text())
    assert rec["tokens"] == rec["meshless_tokens"]
    assert rec["launches"] == rec["want_launches"], rec


def test_serve_and_strategies_twin_on_the_card(cuda):
    """The example twin's ``serve_demo`` at the reduced mamba2 (4 prompts of
    12 tokens, one partial chunk of 32): ``ssd_scan`` once a layer in its
    prefill, and the tokens of the decode recurrence alone on the same
    weights; its strategies aggregate through ``fed_agg``."""
    from repro_torch.configs import get_config
    from repro_torch.examples import serve_and_strategies
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.launch.serve import serve_batch_loop
    from repro_torch.models import build_model

    cfg = get_config("mamba2-130m").reduced()
    sk.reset_launches()
    rec = serve_and_strategies.serve_demo(device=cuda)
    assert sk.LAUNCHES["ssd_scan"] == cfg.n_layers == 2
    params = build_model(cfg).init(0, device=cuda)  # the twin's seed, on the card
    loop = serve_batch_loop(cfg, params, rec["prompts"], new_tokens=12)
    assert torch.equal(rec["tokens"], loop)
    before = kernel.LAUNCHES["fed_agg"]
    got = serve_and_strategies.strategies_demo(device=cuda, uri="memory://cuda-strategies")
    assert got["launches"]["fed_agg"] >= 1
    assert kernel.LAUNCHES["fed_agg"] - before == got["launches"]["fed_agg"]


# --- the serving node's decode graphs: mamba2-130m at its published widths, bf16 -----------

GRAPH_B, GRAPH_NEW = 8, 40


@pytest.fixture(scope="module")
def mamba2_sets():
    """mamba2-130m's published config and three weight sets drawn on the
    card from seeds 0-2, as host f32 flats ready to deploy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import get_config
    from repro_torch.core.tree import LeafSpec
    from repro_torch.models import build_model

    cfg = get_config("mamba2-130m")
    model = build_model(cfg)
    spec = LeafSpec.of(model.abstract())
    flats = []
    for seed in range(3):
        params = model.init(seed, device="cuda")
        flats.append(spec.flatten_into(params, spec.empty_flat()))
        del params
    return cfg, flats


def _graph_node(cfg):
    from repro_torch.core import Telemetry
    from repro_torch.core.store import InMemoryFolder, WeightStore
    from repro_torch.serving import ServingNode

    tel = Telemetry("server", enabled=True, flush_every=10**9)
    return ServingNode(WeightStore(InMemoryFolder()), cfg, telemetry=tel, device="cuda"), tel


def _deploy(node, flats, k):
    from repro_torch.serving.watcher import Deployment

    node.deploy(Deployment(source="t", counter=k, timestamp=0.0, max_counter=k,
                           flat=flats[k]))


def _eager_decode(node, prompts, new_tokens):
    """The node's eager path on its deployed weights: the bulk prefill, then
    ``make_serve_step`` once a token → (tokens (B, new) numpy, final cache)."""
    params = node._deployed.params
    p = torch.as_tensor(prompts).to("cuda")
    B, S = p.shape
    cache = node.model.init_cache(B, capacity=S + new_tokens, device="cuda")
    tok, cache = node._prefill(params, p, cache)
    toks = [tok]
    for t in range(1, new_tokens):
        tok, cache = node._serve_step(params, tok, cache, S - 1 + t)
        toks.append(tok)
    return torch.stack(toks, dim=1).cpu().numpy(), cache


def _graph_prompts(cfg, S, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (GRAPH_B, S), dtype=np.int32)


def _graph_counters(tel):
    return tel.snapshot()["counters"]


@pytest.mark.parametrize("S", [75, 300])
def test_decode_graph_serves_the_eager_tokens_and_cache_bitwise(cuda, mamba2_sets, S):
    """The graph path's tokens and final cache equal the eager path's bit for
    bit; the bulk prefill still launches ssd_scan once a layer."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels.ssd_scan import kernel as sk

    cfg, flats = mamba2_sets
    node, tel = _graph_node(cfg)
    assert node._graphable
    _deploy(node, flats, 0)
    prompts = _graph_prompts(cfg, S)
    sk.reset_launches()
    tokens, _ = node.generate(prompts, new_tokens=GRAPH_NEW)
    assert sk.LAUNCHES["ssd_scan"] == cfg.n_layers
    want, want_cache = _eager_decode(node, prompts, GRAPH_NEW)
    assert np.array_equal(tokens, want)
    dep = node._deployed
    graph = node._graphs[(dep.buf, dep.gen, GRAPH_B)]
    for got, ref in zip(tree_leaves(graph.cache), tree_leaves(want_cache)):
        assert torch.equal(got, ref)
    again, _ = node.generate(prompts, new_tokens=GRAPH_NEW)
    assert np.array_equal(again, want)
    records = tel.recorder.drain_records()
    assert sum(r.name == "serve.decode.replay" for r in records) == 2 * (GRAPH_NEW - 1)
    counters = _graph_counters(tel)
    assert counters["serve.decode.capture"] == 1
    assert counters["serve.decode.graph"] == 2 * (GRAPH_NEW - 1)
    assert "serve.decode.eager" not in counters


@pytest.mark.parametrize("S", [75, 300])
def test_decode_graph_replays_the_leaves_a_swap_rewrote_in_place(cuda, mamba2_sets, S):
    cfg, flats = mamba2_sets
    node, tel = _graph_node(cfg)
    prompts = _graph_prompts(cfg, S)
    _deploy(node, flats, 0)  # buffer 0
    first, _ = node.generate(prompts, new_tokens=GRAPH_NEW)
    _deploy(node, flats, 1)  # buffer 1
    _deploy(node, flats, 2)  # buffer 0, rewritten in place
    assert node._deployed.buf == 0 and node._deployed.gen == 1
    tokens, meta = node.generate(prompts, new_tokens=GRAPH_NEW)
    assert meta["counter"] == 2
    want, _ = _eager_decode(node, prompts, GRAPH_NEW)
    assert np.array_equal(tokens, want)
    assert not np.array_equal(tokens, first)
    assert _graph_counters(tel)["serve.decode.capture"] == 1


@pytest.mark.parametrize("S", [75, 300])
def test_decode_graph_captures_while_the_watcher_writes_a_swap(cuda, mamba2_sets, S,
                                                                monkeypatch):
    """A batch's first decode captures its graph while the watcher writes a
    swap into the other buffer: the capture succeeds and serves the eager
    tokens, and so does the next buffer's."""
    import threading

    from repro_torch.serving import node as node_mod

    cfg, flats = mamba2_sets
    node, tel = _graph_node(cfg)
    prompts = _graph_prompts(cfg, S)
    _deploy(node, flats, 0)
    _deploy(node, flats, 1)  # the batch below runs on buffer 1, the swap writes buffer 0
    want, _ = _eager_decode(node, prompts, GRAPH_NEW)
    monkeypatch.setattr(node_mod, "_SWAP_PAUSE_S", 0.005)  # over 1 s of chunked writes
    writing = threading.Event()
    copy = node_mod._ChunkCopier.copy

    def copy_and_tell(self, dst, src):
        copy(self, dst, src)
        writing.set()

    monkeypatch.setattr(node_mod._ChunkCopier, "copy", copy_and_tell)
    swap = threading.Thread(target=_deploy, args=(node, flats, 2))
    swap.start()
    assert writing.wait(60)
    tokens, meta = node.generate(prompts, new_tokens=GRAPH_NEW)
    swap.join(timeout=120)
    assert not swap.is_alive()
    assert meta["counter"] == 1 and np.array_equal(tokens, want)
    records = tel.recorder.drain_records()
    (capture,) = [r for r in records if r.name == "serve.decode.capture"]
    (write,) = [r for r in records if r.name == "serve.swap.write" and r.trace == 2]
    assert write.t0 < capture.t0 + capture.dur and capture.t0 < write.t0 + write.dur
    assert node._deployed.counter == 2
    after, _ = node.generate(prompts, new_tokens=GRAPH_NEW)  # buffer 0: a second capture
    assert np.array_equal(after, _eager_decode(node, prompts, GRAPH_NEW)[0])
    assert _graph_counters(tel)["serve.decode.capture"] == 2


@pytest.mark.parametrize("S", [75, 300])
def test_decode_graph_busy_sends_a_concurrent_batch_eager(cuda, mamba2_sets, S):
    """A second generate, on another thread while the first holds the graph,
    decodes eagerly and gives the same tokens."""
    import threading

    cfg, flats = mamba2_sets
    node, tel = _graph_node(cfg)
    _deploy(node, flats, 0)
    prompts = _graph_prompts(cfg, S)
    want, _ = _eager_decode(node, prompts, GRAPH_NEW)
    inner = {}

    def second_batch():
        inner["tokens"], _ = node.generate(prompts, new_tokens=GRAPH_NEW)

    def on_token(t):
        if t == 1:
            th = threading.Thread(target=second_batch)
            th.start()
            th.join(timeout=120)
            assert not th.is_alive()

    tokens, _ = node.generate(prompts, new_tokens=GRAPH_NEW, on_token=on_token)
    assert np.array_equal(tokens, want) and np.array_equal(inner["tokens"], want)
    counters = _graph_counters(tel)
    assert counters["serve.decode.eager"] == GRAPH_NEW - 1
    assert counters["serve.decode.graph"] == GRAPH_NEW - 1
    assert counters["serve.decode.capture"] == 1


@pytest.mark.parametrize("S", [75, 300])
def test_decode_graph_recaptured_after_a_drain_timeout(cuda, mamba2_sets, S, monkeypatch):
    """A swap that times out on a wedged batch allocates fresh leaves: a new
    generation, a new capture, the new set's tokens; the stale graph goes."""
    from repro_torch.serving import node as node_mod

    cfg, flats = mamba2_sets
    node, tel = _graph_node(cfg)
    prompts = _graph_prompts(cfg, S)
    _deploy(node, flats, 0)
    node.generate(prompts, new_tokens=GRAPH_NEW)  # captures (0, 1, B)
    _deploy(node, flats, 1)
    monkeypatch.setattr(node_mod, "_SWAP_DRAIN_TIMEOUT_S", 0.05)
    node._buf_refs[0] += 1  # a batch wedged on buffer 0
    _deploy(node, flats, 2)
    node._buf_refs[0] -= 1
    assert node._deployed.buf == 0 and node._deployed.gen == 2
    tokens, _ = node.generate(prompts, new_tokens=GRAPH_NEW)
    assert np.array_equal(tokens, _eager_decode(node, prompts, GRAPH_NEW)[0])
    assert _graph_counters(tel)["serve.decode.capture"] == 2
    assert list(node._graphs) == [(0, 2, GRAPH_B)]
