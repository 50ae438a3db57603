"""The port's Mamba2 (``repro_torch.models.ssm``) and ``ssd_scan`` op against
the reference.

Inputs are drawn with numpy from a seed and handed to both packages. The
port's plain SSD (the CPU path of ``ops.ssd``, and the oracle of the CUDA
kernel) is held against the reference's Pallas kernel in interpret mode and
its two oracles at the reference's sweeps and tolerances
(``tests/test_kernels.py``: 1e-4 against the chunked form and the kernel,
1e-3 against the sequential recurrence); the Mamba2 block, the reduced
model's logits and greedy tokens, and serving from a store a JAX node pushed
to are held against ``repro`` in f32 at 1e-4. Everything runs on the CPU
(``device="cpu"``).
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import store as jstore
from repro.core.serialize import NodeUpdate as JNodeUpdate
from repro.kernels.ssd_scan import ref as jref
from repro.kernels.ssd_scan import ssd_scan as jssd_scan
from repro.launch.serve import serve_batch as jserve_batch
from repro.models import build_model as jbuild_model
from repro.models import ssm as jssm
from repro_torch import api
from repro_torch import serve as serve_cli
from repro_torch.configs import get_config
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.kernels.ssd_scan import kernel as sk
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref, ssd_scan_sequential
from repro_torch.launch.serve import serve_batch, serve_batch_loop
from repro_torch.models import build_model, load_jax_params
from repro_torch.models import ssm

from _torch_parity import np_params

ARCH = "mamba2-130m"
T = torch.from_numpy


def _ssd_inputs(seed, x_shape, da_shape, bc_shape):
    """x ~ 0.5·N(0,1) (dt-premultiplied), dA = -softplus(N(0,1)), B/C ~ 0.5·N(0,1)."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=x_shape) * 0.5).astype(np.float32)
    dA = -np.log1p(np.exp(rng.normal(size=da_shape))).astype(np.float32)
    Bm = (rng.normal(size=bc_shape) * 0.5).astype(np.float32)
    Cm = (rng.normal(size=bc_shape) * 0.5).astype(np.float32)
    return x, dA, Bm, Cm


# ---------------------------------------------------------------------------
# the SSD core and the op
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("BH,S,P,N,chunk", [
    (2, 128, 64, 32, 32),
    (3, 256, 64, 128, 64),
    (1, 512, 128, 64, 128),
    (2, 256, 64, 128, 256),     # single chunk
])
def test_ssd_scan_plain_matches_reference_kernel_and_oracles(BH, S, P, N, chunk):
    """The reference's four sweeps: the port's (BH,S,P) oracles and its op in
    model layout against the Pallas kernel (interpret mode) and the
    reference's oracles."""
    x, dA, Bm, Cm = _ssd_inputs(BH * S, (BH, S, P), (BH, S), (BH, S, N))
    jargs = [jnp.asarray(a) for a in (x, dA, Bm, Cm)]
    kernel_out = np.asarray(jssd_scan(*jargs, chunk=chunk, interpret=True))
    targs = [T(a) for a in (x, dA, Bm, Cm)]
    got = ssd_scan_ref(*targs, chunk=chunk).numpy()
    np.testing.assert_allclose(got, kernel_out, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(jref.ssd_scan_ref(*jargs, chunk=chunk)),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ssd_scan_sequential(*targs).numpy(),
                               np.asarray(jref.ssd_scan_sequential(*jargs)), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(jref.ssd_scan_sequential(*jargs)),
                               rtol=1e-3, atol=1e-3)
    # the op, model layout (one head per row), on the CPU: the plain version
    before = sk.LAUNCHES["ssd_scan"]
    y, _ = ssd_ops.ssd(targs[0][:, :, None], targs[1][:, :, None], targs[2][:, :, None],
                       targs[3][:, :, None], chunk=chunk)
    assert sk.LAUNCHES["ssd_scan"] == before
    np.testing.assert_allclose(y[:, :, 0].numpy(), kernel_out, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("S,chunk,with_init", [(200, 64, False), (200, 64, True),
                                                (256, 64, True), (70, 32, True)])
def test_ssd_chunked_states_match_reference(S, chunk, with_init):
    """ssd_chunked with an initial state, its final state, and a ragged S
    (zero-padded, dA = 0 on the padding) against the reference's, 1e-4."""
    B, H, P, N = 2, 3, 64, 32
    x, dA, Bm, Cm = _ssd_inputs(S + chunk, (B, S, H, P), (B, S, H), (B, S, H, N))
    init = (np.random.default_rng(7).normal(size=(B, H, P, N)) * 0.3).astype(np.float32)
    jy, jstate = jssm.ssd_chunked(*(jnp.asarray(a) for a in (x, dA, Bm, Cm)), chunk,
                                  initial_state=jnp.asarray(init) if with_init else None)
    ty, tstate = ssm.ssd_chunked(*(T(a) for a in (x, dA, Bm, Cm)), chunk,
                                 initial_state=T(init) if with_init else None)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tstate.numpy(), np.asarray(jstate), rtol=1e-4, atol=1e-4)
    sy, sstate = ssm.ssd_sequential(*(T(a) for a in (x, dA, Bm, Cm)),
                                    initial_state=T(init) if with_init else None)
    jsy, jsstate = jssm.ssd_sequential(*(jnp.asarray(a) for a in (x, dA, Bm, Cm)),
                                       initial_state=jnp.asarray(init) if with_init else None)
    np.testing.assert_allclose(sy.numpy(), np.asarray(jsy), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sstate.numpy(), np.asarray(jsstate), rtol=1e-4, atol=1e-4)


def test_ssd_op_shared_bc_and_state_out_in_place():
    """B/C (B,S,N) shared by every head give what the broadcast (B,S,H,N)
    gives in the reference; the final state lands in ``state_out`` even when
    it is the initial state's own buffer (a cache view)."""
    B, S, H, P, N, chunk = 2, 100, 3, 64, 32, 32
    x, dA, Bm, Cm = _ssd_inputs(5, (B, S, H, P), (B, S, H), (B, S, N))
    init = (np.random.default_rng(8).normal(size=(B, H, P, N)) * 0.3).astype(np.float32)
    wide = lambda a: jnp.broadcast_to(jnp.asarray(a)[:, :, None], (B, S, H, N))  # noqa: E731
    jy, jstate = jssm.ssd_chunked(jnp.asarray(x), jnp.asarray(dA), wide(Bm), wide(Cm), chunk,
                                  initial_state=jnp.asarray(init))
    stacked = T(np.stack([init, np.zeros_like(init)]))   # a stacked cache; layer 0's view
    view = stacked.unbind(0)[0]
    y, state = ssd_ops.ssd(T(x), T(dA), T(Bm), T(Cm), chunk=chunk, initial_state=view,
                           state_out=view)
    assert state.data_ptr() == view.data_ptr()
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(stacked[0].numpy(), np.asarray(jstate), rtol=1e-4, atol=1e-4)
    assert not stacked[1].any()


def test_ssd_kernel_wrapper_takes_only_cuda_tensors():
    x, dA, Bm, Cm = (T(a) for a in _ssd_inputs(0, (1, 64, 1, 64), (1, 64, 1), (1, 64, 32)))
    with pytest.raises(ValueError, match="CUDA"):
        sk.ssd(x, dA, Bm, Cm, chunk=32)


# ---------------------------------------------------------------------------
# the Mamba2 block and the reduced model
# ---------------------------------------------------------------------------


def _pair(seed=0):
    """(jax cfg, port cfg, numpy params in the reference's layout, port params)."""
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    params = np_params(jbuild_model(jcfg), seed)
    return jcfg, cfg, params, load_jax_params(build_model(cfg), params, device="cpu")


@pytest.mark.parametrize("path", ["full", "prefill", "decode"])
def test_mamba2_block_matches_reference(path):
    """One Mamba2 block (layer 0's weights, carried by load_jax_params), its
    output and its cache against the reference's, f32, 1e-4. Prefill starts
    from a nonzero cache; decode runs three tokens on from it."""
    jcfg, cfg, params, tparams = _pair(seed=1)
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["u0_ssm"]["ssm"])
    tp = tree_map(lambda t: t[0], tparams["blocks"]["u0_ssm"]["ssm"])
    rng = np.random.default_rng(2)
    B, S = 2, 45
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    if path == "full":
        want = np.asarray(jssm.mamba2_full(jp, jcfg, jnp.asarray(x)))
        np.testing.assert_allclose(ssm.mamba2_full(tp, cfg, T(x)).numpy(), want,
                                   rtol=1e-4, atol=1e-4)
        return
    jcache = jssm.init_ssm_cache(jcfg, B)
    jcache = {"conv": jnp.asarray(rng.normal(size=jcache["conv"].shape).astype(np.float32)),
              "ssm": jnp.asarray(rng.normal(size=jcache["ssm"].shape).astype(np.float32) * 0.3)}
    tcache = ssm.init_ssm_cache(cfg, B)
    for k in tcache:
        tcache[k].copy_(T(np.array(jcache[k])))
    jy, jcache = jssm.mamba2_prefill(jp, jcfg, jnp.asarray(x), jcache)
    ty, out_cache = ssm.mamba2_prefill(tp, cfg, T(x), tcache)
    assert out_cache is tcache  # written in place
    steps = [(jy, ty)]
    for t in range(3 if path == "decode" else 0):
        xt = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
        jy, jcache = jssm.mamba2_decode(jp, jcfg, jnp.asarray(xt), jcache)
        ty, _ = ssm.mamba2_decode(tp, cfg, T(xt), tcache)
        steps.append((jy, ty))
    for i, (jy, ty) in enumerate(steps):
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4, atol=1e-4,
                                   err_msg=f"step {i}")
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)


def test_model_caches_after_prefill_match_reference():
    """The stacked cache itself (not a copy of a layer's view) holds the
    reference's conv window and SSM state after a bulk prefill of a ragged
    prompt (S = 75 at chunk 32)."""
    jcfg, cfg, params, tparams = _pair(seed=3)
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    prompts = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 75), dtype=np.int32)
    jl, jcache = jmodel.prefill(params, jnp.asarray(prompts), jmodel.init_cache(2, 80))
    cache = model.init_cache(2, 80, device="cpu")
    tl, _ = model.prefill(tparams, T(prompts), cache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    for k in ("conv", "ssm"):
        got, want = cache["u0_ssm"][k].numpy(), np.asarray(jcache["u0_ssm"][k])
        assert got.shape == want.shape and got.dtype == want.dtype
        assert np.abs(got).max() > 0
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=k)


def test_jax_init_carries_over_and_serves_the_same_tokens():
    """The reference's own init (deterministic A_log/dt_bias/D leaves, f32)
    carried by load_jax_params gives the reference's logits (1e-4) and greedy
    tokens."""
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    params = jax.tree.map(np.asarray, jbuild_model(jcfg).init(jax.random.PRNGKey(5)))
    tparams = load_jax_params(build_model(cfg), params, device="cpu")
    prompts = np.random.default_rng(6).integers(0, cfg.vocab_size, (3, 40), dtype=np.int32)
    jlogits, _ = jbuild_model(jcfg).apply(params, jnp.asarray(prompts))
    tlogits, _ = build_model(cfg).apply(tparams, T(prompts))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    want = np.asarray(jserve_batch(jcfg, params, jnp.asarray(prompts), new_tokens=6))
    np.testing.assert_array_equal(serve_batch(cfg, tparams, prompts, new_tokens=6).numpy(), want)


def test_bf16_jax_init_loads_with_f32_leaves():
    """A bf16 model's tree from the reference's init: bf16 leaves read through
    f32 exactly, and the A_log/dt_bias/D leaves stay f32, as the reference
    keeps them; the port then serves tokens in range."""
    jcfg = jget_config(ARCH).reduced().replace(dtype="bfloat16")
    cfg = get_config(ARCH).reduced().replace(dtype="bfloat16")
    params = jax.tree.map(np.asarray, jbuild_model(jcfg).init(jax.random.PRNGKey(9)))
    tparams = load_jax_params(build_model(cfg), params, device="cpu")
    ssm_leaves = tparams["blocks"]["u0_ssm"]["ssm"]
    for name in ("A_log", "dt_bias", "D"):
        assert ssm_leaves[name].dtype == torch.float32
    assert ssm_leaves["w_x"]["w"].dtype == torch.bfloat16
    for got, want in zip(tree_leaves(tparams), jax.tree.leaves(params)):
        np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))
    out = serve_batch(cfg, tparams, np.zeros((2, 8), np.int32), new_tokens=3).numpy()
    assert out.shape == (2, 3) and ((out >= 0) & (out < cfg.vocab_size)).all()


@pytest.mark.parametrize("prompt_len", [8, 75])
def test_bulk_prefill_matches_decode_loop(prompt_len):
    """The port's bulk prefill (the ssd op) against its own token-at-a-time
    decode recurrence, as ``tests/test_serving.py`` holds the reference's;
    75 tokens span three chunks of 32, the last one ragged."""
    _, cfg, _, tparams = _pair(seed=10)
    prompts = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, prompt_len),
                                                 dtype=np.int32)
    fast = serve_batch(cfg, tparams, prompts, new_tokens=6).numpy()
    slow = serve_batch_loop(cfg, tparams, prompts, new_tokens=6).numpy()
    np.testing.assert_array_equal(fast, slow)


# ---------------------------------------------------------------------------
# serving from a store a JAX node pushed to
# ---------------------------------------------------------------------------


def _jax_push(folder, params, counter=0):
    jstore.WeightStore(jstore.DiskFolder(str(folder))).push(
        JNodeUpdate(params, 1, "jax-trainer", counter=counter, timestamp=time.time()))


def test_api_serve_deploys_jax_pushed_mamba2(tmp_path):
    jcfg, cfg, params, _ = _pair(seed=12)
    _jax_push(tmp_path, params)
    prompts = np.random.default_rng(13).integers(0, cfg.vocab_size, (3, 20), dtype=np.int32)
    node = api.serve(str(tmp_path), ARCH, reduced=True, poll_interval=0.02, wait=30.0,
                     device="cpu")
    try:
        assert node.stats()["deployed"]
        got, meta = node.generate(prompts, new_tokens=5)
    finally:
        node.stop()
    want = np.asarray(jserve_batch(jcfg, params, jnp.asarray(prompts), new_tokens=5))
    np.testing.assert_array_equal(got, want)
    assert meta["source"] == "jax-trainer" and meta["counter"] == 0


def test_serve_cli_serves_from_a_jax_store(tmp_path, capsys):
    _, _, params, _ = _pair(seed=14)
    _jax_push(tmp_path, params)
    rc = serve_cli.main(["--store", str(tmp_path), "--arch", ARCH, "--reduced",
                         "--device", "cpu", "--requests", "2", "--wait", "30"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert out.count("batch ") == 2 and "weights=jax-trainer@0" in out
    slo = [line for line in out.splitlines() if line.startswith("SLO ")]
    assert len(slo) == 1 and '"deployed": true' in slo[0] and '"requests": 2' in slo[0]
