"""granite-4.0-h-micro, the port's hybrid of Mamba2 + MLP (``ssm_mlp``) and
NoPE GQA + MLP (``attn``) layers with Granite's multipliers, against the
benchmark's plain f32 reference (``portbench/reference/granite_hybrid.py``)
on the CPU at a small size, and the models that were there before it held to
what they were: their trees as before, their logits to the reference package
(JAX), which has no granite-4.0-h, at its f32 tolerance.

Tolerances: the program and the reference compute the same float32
mathematics in different orders (the chunked SSD against its sequential
recurrence in decode, fused against split attention): they agree to 6.4e-7
of the largest logit here. 1e-5 leaves ~15× room over that, and lies far
below what dropping any multiplier or NoPE moves (0.52-7.0 here; 1e-2
asserted).
"""
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import np_params
from portbench import harness
from portbench.reference import granite_hybrid as ref
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro_torch import api
from repro_torch.configs import ARCH_IDS, PAPER_IDS, PORT_IDS, get_config
from repro_torch.core.serialize import NodeUpdate
from repro_torch.core.store import InMemoryFolder, WeightStore
from repro_torch.core.telemetry import Telemetry
from repro_torch.core.tree import LeafSpec
from repro_torch.launch.steps import decode_graphable
from repro_torch.models import ModelConfig, build_model, load_jax_params

TOL = 1e-5  # of the largest logit (module docstring)
# the new fields and their published values; each default is a no-op
PUBLISHED = {"embedding_multiplier": 12.0, "attention_multiplier": 0.015625,
             "residual_multiplier": 0.22, "logits_scaling": 8.0, "position_embedding": "nope"}
REF_KEYS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab_size",
            "vocab_pad_to", "ssm_state", "ssm_conv", "ssm_expand", "ssm_head_dim", "ssm_chunk",
            "embedding_multiplier", "attention_multiplier", "residual_multiplier",
            "logits_scaling", "norm_eps", "dtype")


def small(**kw):
    """Both block kinds in a period of 3, two periods, at toy widths, f32,
    with the published multipliers and NoPE."""
    return get_config("granite-4.0-h-micro").replace(
        n_layers=6, layer_pattern=("ssm_mlp", "attn", "ssm_mlp"), d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=96, vocab_size=200, ssm_state=8, ssm_head_dim=16,
        ssm_chunk=8, dtype="float32", **kw)


def ref_cfg(cfg) -> dict:
    # q/k drawn at 6/sqrt(d_in), as the benchmark's cell draws them, so that
    # the scores spread and the attention scale matters
    return {**{k: getattr(cfg, k) for k in REF_KEYS}, "layer_pattern": list(cfg.layer_pattern),
            "qk_gain": 6.0, "embed_std": 0.005}


@pytest.fixture(scope="module")
def hybrid():
    cfg = small()
    rc = ref_cfg(cfg)
    weights = ref.make_weights(rc, 7, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = ref.forward(weights, rc, tokens)
    return cfg, rc, weights, tokens, want


def _close(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def test_registry_keeps_the_published_model():
    cfg = get_config("granite-4.0-h-micro")
    assert PORT_IDS == ["granite-4.0-h-micro"]
    # no parity with the reference's registry, which lacks the model
    assert "granite-4.0-h-micro" not in ARCH_IDS + PAPER_IDS
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_, cfg.d_ff,
            cfg.vocab_size, cfg.padded_vocab, cfg.norm_eps) == (40, 2048, 32, 8, 64, 8192, 100352,
                                                                100352, 1e-5)
    assert (cfg.ssm_state, cfg.ssm_conv, cfg.ssm_expand, cfg.ssm_head_dim, cfg.ssm_chunk) == \
        (128, 4, 2, 64, 256)
    assert {k: getattr(cfg, k) for k in PUBLISHED} == PUBLISHED
    kinds = [cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.n_layers)]
    assert [i for i, k in enumerate(kinds) if k == "attn"] == [5, 15, 25, 35]
    n = sum(int(np.prod(s)) for s in LeafSpec.of(build_model(cfg).abstract()).shapes)
    assert 3.18e9 < n < 3.20e9  # ~3.19 B parameters, as published


def test_layout_equals_the_reference(hybrid):
    cfg, rc, weights, _, _ = hybrid
    got = {p: (tuple(t.shape), str(t.dtype).split(".")[-1])
           for p, t in harness.flat_paths(build_model(cfg).abstract()).items()}
    assert got == {p: (s, d) for p, s, d in ref.layout(rc)}


def test_full_forward_equals_the_reference(hybrid):
    cfg, _, weights, tokens, want = hybrid
    with torch.no_grad():
        got, _ = build_model(cfg).apply(harness.nested(weights), tokens)
    assert _close(got, want) < TOL


def test_prefill_then_decode_through_the_hybrid_cache(hybrid):
    cfg, _, weights, tokens, want = hybrid
    model, params = build_model(cfg), harness.nested(weights)
    S = 29  # not a whole number of chunks
    with torch.no_grad():
        cache = model.init_cache(2, tokens.shape[1], device="cpu")
        assert set(cache["u0_ssm_mlp"]) == {"conv", "ssm"}
        assert set(cache["u1_attn"]) == {"k", "v", "slot_pos"}
        logits, cache = model.prefill(params, tokens[:, :S], cache)
        assert _close(logits, want[:, S - 1]) < TOL
        for t in range(S, tokens.shape[1]):
            logits, cache = model.decode_step(params, tokens[:, t], cache, t)
            assert _close(logits, want[:, t]) < TOL, t


@pytest.mark.parametrize("field", sorted(PUBLISHED))
def test_each_multiplier_and_nope_matter(hybrid, field):
    cfg, _, weights, tokens, want = hybrid
    dropped = cfg.replace(**{field: getattr(get_config("granite-3-2b"), field)})
    with torch.no_grad():
        got, _ = build_model(dropped).apply(harness.nested(weights), tokens)
        cache = build_model(dropped).init_cache(2, tokens.shape[1], device="cpu")
        last, _ = build_model(dropped).prefill(harness.nested(weights), tokens, cache)
    assert _close(got, want) > 1e-2
    assert _close(last, want[:, -1]) > 1e-2


def test_serving_node_generates_the_reference_tokens(hybrid):
    cfg, rc, weights, _, _ = hybrid
    store = WeightStore(InMemoryFolder())
    store.push(NodeUpdate(params=harness.nested(weights), num_examples=1, node_id="fleet",
                          counter=3, timestamp=0.0))
    tel = Telemetry("server", enabled=True, flush_every=10**9)
    node = api.serve(store, cfg, telemetry=tel, start=False, device="cpu")
    assert not node._graphable and not decode_graphable(node.model, torch.device("cuda"))
    assert node.poll_once()
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (3, 21), dtype=np.int32)
    tokens, meta = node.generate(prompts, new_tokens=6)
    assert meta["counter"] == 3 and tokens.shape == (3, 6)
    with torch.no_grad():
        gaps = ref.served_gaps(weights, rc, torch.from_numpy(prompts), torch.from_numpy(tokens))
    # logits here reach ~0.1: a token below the best by more than 1e-5 is no rounding
    assert float(gaps.max()) <= TOL
    records = tel.recorder.drain_records()
    (init,) = [r for r in records if r.name == "serve.cache.init"]
    (prefill,) = [r for r in records if r.name == "serve.prefill"]
    assert init.trace == prefill.trace == 1 and init.t0 + init.dur <= prefill.t0
    m = ref.dims(rc)
    ring = 2 * 2 * 3 * 27 * cfg.n_kv_heads * cfg.head_dim * 4 + 2 * 27 * 4  # k, v; slot_pos
    state = 4 * 3 * ((cfg.ssm_conv - 1) * m["conv_ch"] + m["H"] * m["P"] * m["N"]) * 4
    assert tel.counters()["serve.cache.kv_bytes"] == ring
    assert tel.counters()["serve.cache.state_bytes"] == state


# -- the models that were there before ------------------------------------------------------

# sha256 of (paths, shapes, dtypes) of each published tree, recorded from
# the code before the hybrid's fields and block kind existed
TREES = {"mamba2-130m": ("38aa882c5dd3d298", 15), "granite-3-2b": ("7bdb8a16daf012b7", 11),
         "recurrentgemma-9b": ("ea7071ade62b7e01", 63)}


def _digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:16]


@pytest.mark.parametrize("arch", sorted(TREES))
def test_parameter_trees_are_as_before(arch):
    spec = LeafSpec.of(build_model(get_config(arch)).abstract())
    assert (_digest(repr((spec.paths, spec.shapes, spec.dtypes)).encode()), len(spec.paths)) \
        == TREES[arch]


@pytest.mark.parametrize("arch", ["granite-3-2b", "mamba2-130m"])
def test_logits_are_as_before_bit_for_bit(arch):
    """With the hybrid's fields at their defaults, a seeded small forward,
    prefill and decode step equal the reference package's, which has none of
    those fields, at its f32 tolerance of 1e-4."""
    cfg, jcfg = get_config(arch).reduced(), jget_config(arch).reduced()
    assert all(getattr(cfg, k) == getattr(ModelConfig(), k) for k in PUBLISHED)
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    jparams = np_params(jmodel, 0)
    params = load_jax_params(model, jparams, device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 24), dtype=np.int32)
    with torch.no_grad():
        full, _ = model.apply(params, torch.from_numpy(tokens))
        last, cache = model.prefill(params, torch.from_numpy(tokens),
                                    model.init_cache(2, 28, device="cpu"))
        step, _ = model.decode_step(params, torch.from_numpy(tokens[:, 0]), cache, 24)
    j_full, _ = jmodel.apply(jparams, jnp.asarray(tokens))
    j_last, j_cache = jmodel.prefill(jparams, jnp.asarray(tokens), jmodel.init_cache(2, 28))
    j_step, _ = jmodel.decode_step(jparams, jnp.asarray(tokens[:, 0]), j_cache, jnp.int32(24))
    for name, got, want in (("apply", full, j_full), ("prefill", last, j_last),
                            ("decode_step", step, j_step)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


# -- the launch layer: sharding rules, costs and the dry run --------------------------------

DRY_CHILD = r"""
import json, logging, sys
logging.disable(logging.WARNING)
from repro_torch.launch import dryrun as D
from repro_torch.launch.specs import InputShape
recs = [D.run_one("granite-4.0-h-micro", InputShape(name, seq, 4, kind), multi_pod=False,
                  reduced=True, mesh_shape=(1, 2), microbatches=2, verbose=False,
                  overrides={"n_layers": 10})
        for name, seq, kind in (("train_s", 64, "train"), ("prefill_s", 128, "prefill"),
                                ("decode_s", 128, "decode"))]
json.dump(recs, open(sys.argv[1], "w"))
"""


def test_sharding_rules_place_the_hybrids_leaves():
    from repro_torch.launch.sharding import P, param_spec, serve_cache_spec

    col, row = P(None, None, "model"), P(None, "model", None)
    for leaf in ("ssm/w_z/w", "ssm/w_x/w", "mlp/wi/w", "mlp/wg/w"):
        assert param_spec(f"blocks/u0_ssm_mlp/{leaf}", 3, fsdp=False, dp="data") == col
    for leaf in ("ssm/out_proj/w", "mlp/wo/w"):
        assert param_spec(f"blocks/u0_ssm_mlp/{leaf}", 3, fsdp=False, dp="data") == row
    assert serve_cache_spec("u0_ssm_mlp/ssm", 5, dp="data") == P(None, "data", "model", None, None)
    assert serve_cache_spec("u5_attn/k", 5, dp="data") == P(None, "data", None, "model", None)


def test_dry_run_of_a_small_hybrid_on_a_fake_1x2_mesh(tmp_path):
    """One period of the reduced hybrid (10 layers, d_model 256) through the
    dry run's train, prefill and decode steps on a fake (1, 2) mesh, in a
    child process (the fake group lives for its process)."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    out = tmp_path / "records.json"
    env = {**os.environ, "PYTHONPATH": str(root / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", DRY_CHILD, str(out)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    cfg = get_config("granite-4.0-h-micro").reduced().replace(n_layers=10)
    n = sum(int(np.prod(s)) for s in LeafSpec.of(build_model(cfg).abstract()).shapes)
    for rec in json.loads(out.read_text()):
        assert rec["ok"] and rec["mesh"] == "1x2" and rec["n_params"] == n, rec
        assert rec["collective_bytes"] > 0  # heads split over "model"
        # 2·N (6·N training) a token of model flops against every counted flop
        # (attention, the scan and the convolution besides)
        assert 0.6 < rec["useful_flop_ratio"] <= 1.0, rec
