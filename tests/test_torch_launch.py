"""``repro_torch.launch`` (sharding rules, costs) and ``remat_policy="dots"``
against the reference.

* The sharding rules: ``param_spec`` / ``cache_spec`` / ``batch_spec`` of
  every leaf of every configuration at its published size (the port's meta
  specs against the reference's ``eval_shape`` ones), with FSDP on and off and
  one or two data axes; ``resolve``'s kept and dropped axes over a seeded
  sweep against the reference's on a ``jax.sharding.AbstractMesh``; the
  twins of ``tests/test_launch.py``'s rule cases.
* The cost model: the twins of ``tests/test_launch.py``'s cost cases, and the
  flops of whole prefill and train steps against ``jaxpr_costs``.
* The ``dots`` remat policy against ``full`` (the twin of
  ``tests/test_perf_variants.py::test_remat_policies_agree``).

The multi-rank cases (a mesh, DTensors) run in child processes:
``tests/test_torch_mesh.py`` and ``tests/test_torch_dryrun.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

import repro.optim as joptim
from repro.configs import get_config as jget_config
from repro.core.tree import path_str as jpath_str
from repro.launch import costs as JC
from repro.launch import sharding as jsharding
from repro.launch import specs as jspecs
from repro.launch import steps as jsteps
from repro_torch.configs import ARCH_IDS, PAPER_IDS, get_config
from repro_torch.core.tree import path_str, tree_flatten_with_path, tree_leaves
from repro_torch.launch import costs as C
from repro_torch.launch import sharding as S
from repro_torch.launch import specs, steps
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.training.trainer import value_and_grad

ARCHS = ARCH_IDS + PAPER_IDS
DPS = ["data", ("pod", "data")]


def _paths(tree) -> list:
    return [(path_str(p), leaf) for p, leaf in tree_flatten_with_path(tree)[0]]


def _jpaths(tree) -> list:
    return [(jpath_str(p), leaf) for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _same(got: S.P, want: JP) -> bool:
    return tuple(got) == tuple(want)


# ---------------------------------------------------------------------------
# the rules, leaf for leaf, at full size
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_specs_match_reference_at_full_size(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    port, ref = _paths(specs.params_specs(cfg)), _jpaths(jspecs.params_specs(jcfg))
    assert [p for p, _ in port] == [p for p, _ in ref]
    for dp in DPS:
        for fsdp in (False, True):
            for (path, t), (_, s) in zip(port, ref):
                got = S.param_spec(path, t.dim(), fsdp=fsdp, dp=dp)
                want = jsharding.param_spec(path, len(s.shape), fsdp=fsdp, dp=dp)
                assert _same(got, want), (path, dp, fsdp, got, want)
    shape = specs.SHAPES["decode_32k"]
    p_meta, p_ref = specs.params_specs(cfg), jspecs.params_specs(jcfg)
    port = _paths(specs.cache_specs(cfg, shape, p_meta))
    ref = _jpaths(jspecs.cache_specs(jcfg, jspecs.SHAPES["decode_32k"], p_ref))
    assert [p for p, _ in port] == [p for p, _ in ref]
    for dp in DPS:
        for (path, t), (_, s) in zip(port, ref):
            assert _same(S.cache_spec(path, t.dim(), dp=dp),
                         jsharding.cache_spec(path, len(s.shape), dp=dp)), path
    for name, shp in specs.SHAPES.items():
        for key, t in specs.input_specs(cfg, shp).items():
            for dp in DPS:
                assert _same(S.batch_spec(t.dim(), dp=dp), jsharding.batch_spec(t.dim(), dp=dp))


def test_resolve_matches_reference_over_a_seeded_sweep():
    rng = np.random.default_rng(0)
    axes_choices = [None, "data", "model", ("pod", "data"), "pod"]
    for _ in range(400):
        sizes = {"pod": int(rng.choice([1, 2])), "data": int(rng.choice([1, 2, 4, 8, 16])),
                 "model": int(rng.choice([1, 2, 4, 8, 16]))}
        mesh = AbstractMesh(tuple(sizes.values()), tuple(sizes))
        ndim = int(rng.integers(1, 5))
        shape = tuple(int(rng.choice([1, 2, 3, 6, 8, 12, 16, 24, 32, 48, 64, 100])) for _ in range(ndim))
        spec = tuple(axes_choices[int(rng.integers(len(axes_choices)))]
                     for _ in range(int(rng.integers(0, ndim + 1))))
        if len({a for ax in spec if ax for a in (ax if isinstance(ax, tuple) else (ax,))}) \
                < sum(len(ax) if isinstance(ax, tuple) else 1 for ax in spec if ax):
            continue  # an axis named twice is no valid spec
        want = jsharding.resolve(JP(*spec), shape, mesh).spec
        got = S.resolve_spec(S.P(*spec), shape, sizes)
        assert tuple(got) == tuple(want) + (None,) * (len(got) - len(want)), (spec, shape, sizes)


def test_placements_of_a_resolved_spec():
    from torch.distributed.tensor import Replicate, Shard

    axes = ("pod", "data", "model")
    assert S.placements(S.P(("pod", "data"), None, "model"), axes) == (Shard(0), Shard(0), Shard(2))
    assert S.placements(S.P(None, "model"), axes) == (Replicate(), Replicate(), Shard(1))
    assert S.placements(S.P(), ("data", "model")) == (Replicate(), Replicate())


# twins of tests/test_launch.py:22-46


def test_param_spec_rules():
    P = S.P
    assert S.param_spec("blocks/u0_attn/attn/wq/w", 3, fsdp=False, dp="data") == P(None, None, "model")
    assert S.param_spec("blocks/u0_attn/attn/wo/w", 3, fsdp=False, dp="data") == P(None, "model", None)
    assert S.param_spec("blocks/u0_attn/attn/wo/w", 3, fsdp=True, dp="data") == P(None, "model", "data")
    assert S.param_spec("embed/table", 2, fsdp=False, dp="data") == P("model", None)
    assert S.param_spec("blocks/u0_moe_attn/moe/wi/w", 4, fsdp=True, dp="data") == P(None, None, "data", "model")
    assert S.param_spec("blocks/u0_moe_attn/moe/router/w", 3, fsdp=True, dp="data") == P()
    assert S.param_spec("final_norm/scale", 1, fsdp=True, dp="data") == P()
    assert S.param_spec("m/blocks/u0_attn/attn/wq/w", 3, fsdp=False, dp="data") == P(None, None, "model")


def test_resolver_drops_non_divisible():
    assert S.resolve_spec(S.P("data", "model"), (3, 5), {"data": 1, "model": 1}) == S.P("data", "model")
    assert S.resolve_spec(S.P("data", "model"), (3, 5), {"data": 2, "model": 5}) == S.P(None, "model")


def test_resolver_fallback_tuple_axis():
    sizes = {"pod": 2, "data": 7, "model": 1}
    assert S.resolve_spec(S.P(("pod", "data"),), (7,), sizes)[0] == "data"
    assert S.resolve_spec(S.P(("pod", "data"),), (14,), sizes)[0] == ("pod", "data")
    assert S.resolve_spec(S.P(("pod", "data"),), (5,), sizes)[0] is None


# ---------------------------------------------------------------------------
# the cost model: twins of tests/test_launch.py:99-156
# ---------------------------------------------------------------------------


def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_step_costs_counts_matmul_exactly():
    got, _ = C.step_costs(lambda a, b: a @ b, _meta(64, 128), _meta(128, 32))
    want = JC.jaxpr_costs(lambda a, b: a @ b, jax.ShapeDtypeStruct((64, 128), jnp.float32),
                          jax.ShapeDtypeStruct((128, 32), jnp.float32))
    assert got.flops == 2 * 64 * 128 * 32 == want.flops
    assert got.bytes == want.bytes


def test_step_costs_counts_every_layer_of_a_python_loop():
    def looped(x, w):
        for wi in w.unbind(0):
            x = x @ wi
        return x

    got, _ = C.step_costs(looped, _meta(32, 32), _meta(10, 32, 32))
    assert got.flops == 10 * 2 * 32**3


def test_step_costs_sees_through_remat_and_grad():
    from torch.utils.checkpoint import checkpoint

    def f(w, x):
        h = x
        for wi in w.unbind(0):
            h = checkpoint(lambda a, b: torch.tanh(a @ b), h, wi, use_reentrant=False)
        return h.sum()

    w, x = torch.zeros(4, 16, 16), torch.zeros(16, 16)
    fwd, _ = C.step_costs(f, w, x)

    def grad(w, x):
        w = w.clone().requires_grad_(True)
        return torch.autograd.grad(f(w, x), w)[0]

    bwd, _ = C.step_costs(grad, w, x)
    assert fwd.flops == 4 * 2 * 16**3
    assert bwd.flops >= 2.5 * fwd.flops  # fwd + remat recompute + 2-matmul backward


def test_roofline_terms_bottleneck():
    # the H100's ridge is ~295 flops a byte (the reference's v5e: ~240), so
    # the twin's compute-bound case carries more flops per byte
    t = C.roofline_terms(total_flops=1e18, total_bytes=1e12, coll_bytes=1e10, chips=256)
    assert t["bottleneck"] == "compute_s"
    t2 = C.roofline_terms(total_flops=1e12, total_bytes=1e14, coll_bytes=0.0, chips=256)
    assert t2["bottleneck"] == "memory_s"
    t3 = C.roofline_terms(total_flops=1e12, total_bytes=1e10, coll_bytes=1e12, chips=1)
    assert t3["bottleneck"] == "collective_s"
    assert C.model_flops_train(10, 3, 0.5) == 6.0 * 10 * 0.5 * 3
    assert C.model_flops_infer(10, 3) == 2.0 * 10 * 3


def _ssd_hadamard_flops(cfg, B: int, S: int) -> int:
    """What ``jnp.einsum`` counts as dot_general and ``torch.einsum`` applies
    elementwise, per ``ssd_chunked`` call: the decay factors of the three
    multi-operand SSD einsums (2·|bchls| + 2·|bshp| + 2·|bshn|)."""
    H = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    return 2 * B * H * S * (cfg.ssm_chunk + cfg.ssm_head_dim + cfg.ssm_state)


@pytest.mark.parametrize("arch", ["granite-3-2b", "mamba2-130m"])
def test_step_flops_match_reference(arch):
    """Prefill and train steps of the reduced config: the port's flops equal
    ``jaxpr_costs``'s, but for the SSD's Hadamard factors (PERF.md §3)."""
    cfg, jcfg = get_config(arch).reduced(), jget_config(arch).reduced()
    B, L = 2, 128
    params, jparams = specs.params_specs(cfg), jspecs.params_specs(jcfg)
    tok = torch.empty((B, L), dtype=torch.int32, device="meta")
    jtok = jax.ShapeDtypeStruct((B, L), jnp.int32)
    extra = _ssd_hadamard_flops(cfg, B, L) * cfg.n_layers if cfg.ssm_state else 0

    got, _ = C.step_costs(steps.make_prefill_step(cfg), params, {"tokens": tok})
    want = JC.jaxpr_costs(jsteps.make_prefill_step(jcfg), jparams, {"tokens": jtok})
    assert got.flops == want.flops - extra

    opt, jopt = adamw(2e-5), joptim.adamw(2e-5)
    got, _ = C.step_costs(steps.make_train_step(cfg, opt, remat=True), params, opt.init(params),
                          {"tokens": tok, "labels": tok})
    want = JC.jaxpr_costs(jsteps.make_train_step(jcfg, jopt, remat=True), jparams,
                          jax.eval_shape(jopt.init, jparams), {"tokens": jtok, "labels": jtok})
    # forward, remat recompute, and the two transposes of the backward
    assert got.flops == want.flops - 4 * extra


def test_collective_keys_match_reference():
    assert set(C.collective_bytes(C.Costs())) == set(JC._COLLECTIVES) | {"total"}


# ---------------------------------------------------------------------------
# remat_policy="dots": the twin of tests/test_perf_variants.py:48-64
# ---------------------------------------------------------------------------


def test_remat_policies_agree():
    cfg = get_config("granite-3-2b").reduced()
    rng = np.random.default_rng(2)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1536), dtype=np.int32)),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1536), dtype=np.int32))}
    losses, grads = {}, {}
    for policy in ("full", "dots"):
        model = build_model(cfg.replace(remat_policy=policy))
        params = model.init(3, device="cpu")
        (losses[policy], _), grads[policy] = value_and_grad(
            lambda p, b: model.loss(p, b, remat=True), params, batch)
    assert float(abs(losses["full"] - losses["dots"])) < 1e-5
    for a, b in zip(tree_leaves(grads["full"]), tree_leaves(grads["dots"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


def test_dots_policy_saves_the_projections():
    """Under ``dots`` the backward recomputes no mm (the projections' outputs
    are saved), only the attention's bmm: fewer flops than ``full``."""
    cfg = get_config("granite-3-2b").reduced()
    tok = torch.zeros((2, 64), dtype=torch.int32)
    flops = {}
    for policy in ("full", "dots"):
        model = build_model(cfg.replace(remat_policy=policy))
        params = model.init(3, device="cpu")
        costs, _ = C.step_costs(lambda p: value_and_grad(
            lambda q, b: model.loss(q, b, remat=True), p, {"tokens": tok, "labels": tok}), params)
        flops[policy] = costs.by_prim["mm"][0], costs.by_prim["bmm"][0]
    no_remat = build_model(cfg)
    costs, _ = C.step_costs(lambda p: value_and_grad(
        lambda q, b: no_remat.loss(q, b), p, {"tokens": tok, "labels": tok}),
        no_remat.init(3, device="cpu"))
    assert flops["dots"][0] == costs.by_prim["mm"][0] < flops["full"][0]
    assert flops["dots"][1] == flops["full"][1] > costs.by_prim["bmm"][0]
