"""``repro_torch.launch.specs`` against ``repro.launch.specs``.

The input, cache and parameter specs of every architecture at its published
size: the port's are tensors on the meta device (no memory, grok-1-314b
included), the reference's ``jax.ShapeDtypeStruct``s from ``eval_shape``.
They must agree in structure, shape and dtype name.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import specs as jspecs
from repro_torch.configs import ARCH_IDS, PAPER_IDS, get_config
from repro_torch.core.tree import LeafSpec, tree_flatten_with_path, tree_leaves
from repro_torch.launch import specs

ARCHS = ARCH_IDS + PAPER_IDS
DECODE_SHAPES = [name for name, s in specs.SHAPES.items() if s.kind == "decode"]


def _layout(tree) -> list:
    """(path, shape, dtype name) per leaf of a port tree, in flattening order."""
    leaves, _ = tree_flatten_with_path(tree)
    return [("/".join(str(k) for k in path), tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for path, t in leaves]


def _jlayout(tree) -> list:
    return [(jax.tree_util.keystr(path, simple=True, separator="/"), tuple(s.shape),
             np.dtype(s.dtype).name) for path, s in jax.tree_util.tree_leaves_with_path(tree)]


def test_shapes_and_constants_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in specs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jspecs.SHAPES.items()}
    assert specs.AUDIO_DECODE_FRAMES == jspecs.AUDIO_DECODE_FRAMES


@pytest.mark.parametrize("shape", list(specs.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch, shape):
    """Keys, shapes and dtypes of every step's data inputs (the enc-dec's 50/50
    frames/tokens split, the VLM's patch budget), and the long-context window
    override."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    got = specs.input_specs(cfg, specs.SHAPES[shape])
    want = jspecs.input_specs(jcfg, jspecs.SHAPES[shape])
    assert list(got) == list(want)
    for key, t in got.items():
        assert t.device.type == "meta"
        assert (tuple(t.shape), str(t.dtype).removeprefix("torch.")) == \
            (tuple(want[key].shape), np.dtype(want[key].dtype).name), key
    assert specs.decode_window_override(cfg, specs.SHAPES[shape]) == \
        jspecs.decode_window_override(jcfg, jspecs.SHAPES[shape])
    small = specs.input_specs(cfg, specs.SHAPES[shape], batch_override=3)
    assert all(t.shape[0] == 3 for t in small.values() if t.dim())


@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, shape):
    """The decode cache of every architecture at both decode shapes: the
    enc-dec's encoded memory (4,096 frames) and ring, a windowed
    ``long_500k`` ring, mamba2's state-only cache; meta tensors all."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    jparams = jspecs.params_specs(jcfg) if jcfg.is_encdec else None
    want = jspecs.cache_specs(jcfg, jspecs.SHAPES[shape], jparams)
    got = specs.cache_specs(cfg, specs.SHAPES[shape])
    assert _layout(got) == _jlayout(want)
    assert all(t.device.type == "meta" for t in tree_leaves(got))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_specs_allocate_nothing_and_match_reference(arch):
    got = specs.params_specs(get_config(arch))
    assert all(t.device.type == "meta" for t in tree_leaves(got))
    want = jspecs.params_specs(jget_config(arch))
    assert _layout(got) == _jlayout(want)
    assert LeafSpec.of(got).num_params == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(want))


def test_encdec_cache_specs_take_given_params_and_a_batch_override():
    cfg = get_config("seamless-m4t-medium")
    params = specs.params_specs(cfg)
    cache = specs.cache_specs(cfg, specs.SHAPES["decode_32k"], params, batch_override=2)
    assert tuple(cache["cross_k"].shape) == (cfg.n_layers, 2, specs.AUDIO_DECODE_FRAMES,
                                             cfg.n_kv_heads, cfg.head_dim_)
    assert tuple(cache["self"]["k"].shape) == (cfg.n_layers, 2, 32768, cfg.n_kv_heads,
                                               cfg.head_dim_)
    assert cache["self"]["slot_pos"].dtype == torch.int32
