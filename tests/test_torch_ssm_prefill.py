"""The Mamba2 prefill's elementwise ops (``repro_torch.kernels.ssm_prefill``)
on the CPU: their plain side is, bit for bit, the composition that serving's
bulk prefill ran before the fused kernels (copied below as it stood), and
the kernel module imports and refuses CPU tensors without a card or a
compiler. The kernels themselves are held against ``ref.py`` on the card in
``tests/test_torch_cuda.py``. No JAX."""
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_prefill import kernel, ops

D_INNER, N, P, K = 128, 16, 64, 4
H = D_INNER // P


def _seed_prefill_in(xs, Bp, Cp, dt_raw, conv, w, b, dt_bias, A_log):
    """The bulk prefill's steps before the scan, as ``models/ssm.py`` ran them."""
    B, S = xs.shape[:2]
    xBC = torch.cat([xs, Bp, Cp], dim=-1)
    window = torch.cat([conv.to(xBC.dtype), xBC], dim=1)
    out = sum(window[:, i : i + S] * w[i] for i in range(w.shape[0]))
    conv_out = F.silu(out + b)
    x_, Bm, Cm = conv_out.split([D_INNER, N, N], dim=-1)
    dt = F.softplus(dt_raw.float() + dt_bias)
    A = -torch.exp(A_log)
    xh = x_.reshape(B, S, H, P)
    xdt = xh * dt[..., None].to(xh.dtype)
    conv.copy_(window[:, S:])
    return xh, xdt, dt * A, Bm, Cm


def _seed_prefill_out(y, xh, z, D, scale, eps):
    """The steps after the scan, up to out_proj, as ``models/ssm.py`` ran them."""
    B, S = y.shape[:2]
    y = y + xh * D[None, None, :, None].to(y.dtype)
    x = y.reshape(B, S, -1) * F.silu(z)
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _inputs(B, S, dtype, seeded_cache, seed=0):
    g = torch.Generator().manual_seed(seed)
    rand = lambda *shape, s=1.0: (torch.randn(*shape, generator=g) * s).to(dtype)  # noqa: E731
    C = D_INNER + 2 * N
    conv = rand(B, K - 1, C) if seeded_cache else torch.zeros(B, K - 1, C, dtype=dtype)
    return dict(xs=rand(B, S, D_INNER), Bp=rand(B, S, N), Cp=rand(B, S, N),
                dt_raw=rand(B, S, H), conv_cache=conv, conv_w=rand(K, C, s=0.3),
                conv_b=rand(C, s=0.1), dt_bias=torch.randn(H, generator=g) * 0.5,
                A_log=torch.log(torch.arange(1, H + 1, dtype=torch.float32)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S", [(1, 1), (2, 2), (2, 3), (3, 70)])
@pytest.mark.parametrize("seeded_cache", [False, True])
def test_prefill_in_on_cpu_is_the_seed_composition(dtype, B, S, seeded_cache):
    a = _inputs(B, S, dtype, seeded_cache, seed=S)
    want_cache = a["conv_cache"].clone()
    want = _seed_prefill_in(a["xs"], a["Bp"], a["Cp"], a["dt_raw"], want_cache, a["conv_w"],
                            a["conv_b"], a["dt_bias"], a["A_log"])
    got = ops.prefill_in(**a, head_dim=P)
    assert len(got) == len(want)
    for g_, w_ in zip(got, want):
        assert g_.dtype == w_.dtype and g_.shape == w_.shape and torch.equal(g_, w_)
    assert torch.equal(a["conv_cache"], want_cache)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_in_cache_keeps_old_rows_for_short_prompts(dtype):
    """S < K-1: the new conv cache is the old rows shifted up by S, then the
    prompt's raw x/B/C rows."""
    a = _inputs(2, 2, dtype, True)
    old = a["conv_cache"].clone()
    ops.prefill_in(**a, head_dim=P)
    xBC = torch.cat([a["xs"], a["Bp"], a["Cp"]], dim=-1)
    assert torch.equal(a["conv_cache"], torch.cat([old[:, 2:], xBC], dim=1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S", [(1, 1), (2, 33)])
def test_prefill_out_on_cpu_is_the_seed_composition(dtype, B, S):
    g = torch.Generator().manual_seed(B * S)
    y, xh = ((torch.randn(B, S, H, P, generator=g)).to(dtype) for _ in range(2))
    z = torch.randn(B, S, D_INNER, generator=g).to(dtype)
    D = torch.randn(H, generator=g)
    scale = (1 + 0.1 * torch.randn(D_INNER, generator=g)).to(dtype)
    got = ops.prefill_out(y, xh, z, D, scale, 1e-5)
    want = _seed_prefill_out(y, xh, z, D, scale, 1e-5)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_prefill_on_cpu_is_the_seed_prefill(dtype):
    """The whole mixer's bulk prefill on CPU tensors: output, conv cache and
    SSM state equal the seed's composition bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked
    from repro_torch.models import ssm
    from repro_torch.models.common import dense_apply

    cfg = get_config("mamba2-130m").reduced().replace(dtype=dtype)
    gen = torch.Generator().manual_seed(3)
    p = ssm.init_mamba2(gen, cfg)
    p["dt_bias"] = torch.randn(p["dt_bias"].shape, generator=gen) * 0.3
    B, S = 2, 45
    x = torch.randn(B, S, cfg.d_model, generator=gen).to(cfg.torch_dtype)
    cache = ssm.init_ssm_cache(cfg, B)
    cache["conv"].copy_(torch.randn(cache["conv"].shape, generator=gen))
    cache["ssm"].copy_(torch.randn(cache["ssm"].shape, generator=gen) * 0.1)
    want_cache = {k: v.clone() for k, v in cache.items()}

    d_inner, Hm, Nm = ssm._dims(cfg)
    proj = [dense_apply(p[k], x) for k in ("w_z", "w_x", "w_B", "w_C", "w_dt")]
    z = proj[0]
    xs, Bp, Cp = proj[1:4]
    window = torch.cat([want_cache["conv"], torch.cat([xs, Bp, Cp], dim=-1)], dim=1)
    out = F.silu(sum(window[:, i : i + S] * p["conv_w"][i] for i in range(cfg.ssm_conv))
                 + p["conv_b"])
    x_, Bm, Cm = out.split([d_inner, Nm, Nm], dim=-1)
    dt = F.softplus(proj[4].float() + p["dt_bias"])
    xh = x_.reshape(B, S, Hm, cfg.ssm_head_dim)
    xdt = xh * dt[..., None].to(xh.dtype)
    wide = (B, S, Hm, Nm)
    y, state = ssd_chunked(xdt, dt * -torch.exp(p["A_log"]), Bm[:, :, None].expand(wide),
                           Cm[:, :, None].expand(wide), cfg.ssm_chunk,
                           initial_state=want_cache["ssm"])
    want_cache["conv"].copy_(window[:, S:])
    want_cache["ssm"].copy_(state)
    want = dense_apply(p["out_proj"], _seed_prefill_out(y, xh, z, p["D"], p["norm"]["scale"],
                                                        cfg.norm_eps))

    got, got_cache = ssm.mamba2_prefill(p, cfg, x, cache)
    assert torch.equal(got, want)
    for k in ("conv", "ssm"):
        assert torch.equal(got_cache[k], want_cache[k])


def test_kernel_module_imports_without_cuda_and_refuses_cpu_tensors():
    """The wrapper imports with no card and no nvcc, counts nothing, and
    raises on CPU tensors before it builds or launches anything."""
    a = _inputs(1, 4, torch.bfloat16, False)
    kernel.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        kernel.prefill_in(**a, head_dim=P)
    y = torch.zeros(1, 4, H, P, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.prefill_out(y, y, y.reshape(1, 4, -1), torch.ones(H),
                           torch.ones(D_INNER, dtype=torch.bfloat16), 1e-6)
    assert kernel.LAUNCHES == {"ssm_prefill_in": 0, "ssm_prefill_out": 0}


def test_kernel_wrapper_takes_16_byte_vectors_only():
    """The alignment rule the wrapper applies before a launch, on CPU tensors:
    widths in whole 16-byte vectors, base pointers and outer strides on the
    16-byte grid, the innermost stride 1 (not itself 16 bytes)."""
    bf = torch.bfloat16
    rows = torch.zeros(2, 5, D_INNER, dtype=bf)
    kernel._check_vectors("op", bf, {"d_inner": D_INNER, "N": N}, {"x": rows})
    kernel._check_vectors("op", torch.float32, {"N": 4}, {"x": rows.float()[:, :1]})
    with pytest.raises(ValueError, match="multiple of 8"):
        kernel._check_vectors("op", bf, {"N": 12}, {})
    with pytest.raises(ValueError, match="x 16-byte aligned"):
        kernel._check_vectors("op", bf, {}, {"x": torch.zeros(2 * 5 * 136 + 1, dtype=bf)[1:]
                                             .view(2, 5, 136)})
    with pytest.raises(ValueError, match="z 16-byte aligned"):
        kernel._check_vectors("op", bf, {}, {"z": torch.zeros(2, 5, 132, dtype=bf)[..., :128]})
