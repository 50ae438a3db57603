"""The delta, top-k and family transports: the port against the reference.

A torch writer and a JAX writer push the same seeded sequence of sparse
updates into one folder. After every push, fresh readers of both packages
(cold caches) and steady readers (warm chain caches) must pull bit-identical
flats with equal ``LeafSpec.key``s, both packages must see the same
``state_hash``, and the two writers must report the same ``rebases``,
``chain_depth`` and ``topk_k``. Lossless transports must also reconstruct
exactly what was pushed; top-k must reconstruct the writer's error-feedback
state.
"""
import io

import jax
import numpy as np
import pytest
import torch

from repro.core import serialize as jser
from repro.core import store as jstore
from repro.core.serialize import NodeUpdate as JNodeUpdate
from repro.core.tree import LeafSpec as JLeafSpec
from repro_torch.core import serialize as tser
from repro_torch.core import store as tstore
from repro_torch.core.serialize import NodeUpdate
from repro_torch.core.tree import LeafSpec, as_numpy, tree_leaves, tree_size_bytes

# same-length node ids: the writers' blobs then differ in no byte count, so
# the size-based rebase guard decides alike in both packages
T, J = "node-t", "node-j"
SPECS = ["delta", "delta(chain=4)|zstd", "delta_q", "topk(adaptive)", "topk(0.05)|npz",
         "family(adapters=full)", "family(adapters=delta, norms=quantized)"]


def _tree(rng, dtype=np.float32):
    return {"blk": {"lora_a": rng.normal(size=(64, 4)).astype(np.float32),
                    "lora_b": rng.normal(size=(4, 48)).astype(np.float32),
                    "norm": {"scale": (1 + 0.1 * rng.normal(size=(48,))).astype(np.float32)}},
            "dense": {"w": rng.normal(size=(64, 48)).astype(dtype),
                      "b": rng.normal(size=(48,)).astype(np.float32)},
            "head": {"w": rng.normal(size=(48, 10)).astype(np.float32)}}


def _sequence(seed: int, steps: int, fraction: float = 0.03) -> list[dict]:
    """A seeded run of sparse local steps: each changes ``fraction`` of every
    leaf's entries (the adapters and norms change whole, as fine-tuning moves
    them)."""
    rng = np.random.default_rng(seed)
    tree = _tree(rng)
    out = [tree]
    for _ in range(steps - 1):
        tree = jax.tree.map(np.copy, tree)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            flat = leaf.reshape(-1)
            name = jax.tree_util.keystr(path)
            n = flat.size if ("lora" in name or "norm" in name) else max(1, int(fraction * flat.size))
            idx = rng.choice(flat.size, size=n, replace=False)
            flat[idx] += (0.1 * rng.normal(size=n)).astype(flat.dtype)
        out.append(tree)
    return out


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(a.copy()), tree)


def _stats(store):
    s = store.pipeline.stats
    return s.rebases, s.chain_depth, s.topk_k


def _pull_both(folder, t_reader=None, j_reader=None):
    t_reader = t_reader or tstore.WeightStore(tstore.DiskFolder(folder))
    j_reader = j_reader or jstore.WeightStore(jstore.DiskFolder(folder))
    return ({u.node_id: u for u in t_reader.pull()}, {u.node_id: u for u in j_reader.pull()})


def _assert_same(a, b, msg=""):
    assert a.spec.key == b.spec.key, msg
    assert (a.counter, a.num_examples) == (b.counter, b.num_examples), msg
    np.testing.assert_array_equal(a.flat, b.flat, err_msg=msg)


@pytest.mark.parametrize("spec", SPECS)
def test_blobs_cross_packages_both_ways(tmp_path, spec):
    folder = str(tmp_path)
    tw = tstore.WeightStore(tstore.DiskFolder(folder), transport=spec, rebase_every=20)
    jw = jstore.WeightStore(jstore.DiskFolder(folder), transport=spec, rebase_every=20)
    assert tw.transport == jw.transport
    steady_t = tstore.WeightStore(tstore.DiskFolder(folder))
    steady_j = jstore.WeightStore(jstore.DiskFolder(folder))
    deltas = 0
    for step, tree in enumerate(_sequence(0, 7)):
        tw.push(NodeUpdate(_torch_tree(tree), 10, T, counter=step))
        jw.push(JNodeUpdate(tree, 10, J, counter=step))
        deltas += "delta_of" in jser.peek_meta(
            jser.maybe_decompress(jstore.DiskFolder(folder).get(f"latest/{T}")))
        msg = f"{spec} step {step}"
        assert _stats(tw) == _stats(jw), msg
        for t_pull, j_pull in (_pull_both(folder), _pull_both(folder, steady_t, steady_j)):
            for node in (T, J):
                _assert_same(t_pull[node], j_pull[node], f"{msg} {node}")
            # same sequence, same codec: both writers deposit the same state
            np.testing.assert_array_equal(t_pull[T].flat, t_pull[J].flat, err_msg=msg)
        truth = LeafSpec.of(tree).flatten(tree)
        got = t_pull[T].flat
        if spec.startswith("delta(") or spec == "delta":
            np.testing.assert_array_equal(got, truth, err_msg=msg)
        elif spec.startswith("topk"):
            np.testing.assert_array_equal(got, tw.pipeline.policy._state[T][3], err_msg=msg)
            np.testing.assert_array_equal(got, jw.pipeline.policy._state[J][3], err_msg=msg)
        elif spec == "delta_q":
            np.testing.assert_allclose(got, truth, atol=0.05, err_msg=msg)
        else:  # family: the selected families are shipped, the rest is the anchor
            view = LeafSpec.of(tree).family_view(("adapters",))
            np.testing.assert_array_equal(view.extract(got), view.extract(truth), err_msg=msg)
        assert (tstore.WeightStore(tstore.DiskFolder(folder)).state_hash()
                == jstore.WeightStore(jstore.DiskFolder(folder)).state_hash())
    assert deltas >= 3, f"{spec}: only {deltas} delta pushes"


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_fresh_readers_resolve_every_chain_depth(tmp_path, writer):
    """delta(chain=4): the depths run 0, 1, 2, 3, 4, then a re-anchor to 1;
    a fresh reader of either package rebuilds every push bit for bit."""
    folder = str(tmp_path)
    if writer == "torch":
        store = tstore.WeightStore(tstore.DiskFolder(folder), transport="delta(chain=4)",
                                   rebase_every=20)
        make = lambda tree, c: NodeUpdate(_torch_tree(tree), 1, "n", counter=c)  # noqa: E731
    else:
        store = jstore.WeightStore(jstore.DiskFolder(folder), transport="delta(chain=4)",
                                   rebase_every=20)
        make = lambda tree, c: JNodeUpdate(tree, 1, "n", counter=c)  # noqa: E731
    depths = []
    for step, tree in enumerate(_sequence(1, 7, fraction=0.01)):
        store.push(make(tree, step))
        depths.append(store.pipeline.stats.chain_depth)
        truth = LeafSpec.of(tree).flatten(tree)
        fresh_t = tstore.WeightStore(tstore.DiskFolder(folder))
        got = fresh_t.pull_node("n")
        np.testing.assert_array_equal(got.flat, truth, err_msg=f"step {step}")
        assert fresh_t.pipeline.stats.resolve_hops == max(depths[-1] - 1, 0)
        np.testing.assert_array_equal(
            jstore.WeightStore(jstore.DiskFolder(folder)).pull_node("n").flat, truth)
    assert depths == [0, 1, 2, 3, 4, 1, 2]
    assert store.pipeline.stats.reanchors == 1 and store.pipeline.stats.rebases == 1
    keys = tstore.DiskFolder(folder).keys()
    assert sum(k.startswith("chain/") for k in keys) == 2  # the live segment's links
    assert sum(k.startswith("base/") for k in keys) == 1


def _narrow_tree(kind, rng):
    if kind == "bf16":
        w = np.array(jax.numpy.asarray(rng.normal(size=(40, 30)), "bfloat16"))
        return {"w": w, "b": rng.normal(size=(30,)).astype(np.float32)}
    return {"w": rng.normal(size=(40, 30)).astype(np.float32),
            "steps": np.arange(30, dtype=np.int64)}


def _as_torch_leaf(a):
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("kind", ["bf16", "int"])
def test_narrow_and_int_trees_take_the_reference_branch(tmp_path, kind):
    """``LeafSpec.f32_exact`` decides the branch: a bf16 tree chains on the
    flat path (chain/ links appear), a tree with an int leaf takes the per-leaf
    path (no links), in both packages alike, and each package's reader
    rebuilds the other's deposits."""
    rng = np.random.default_rng(5)
    tree = _narrow_tree(kind, rng)
    ttree = {k: _as_torch_leaf(v) for k, v in tree.items()}
    assert LeafSpec.of(ttree).f32_exact == JLeafSpec.of(tree).f32_exact == (kind == "bf16")
    assert tree_size_bytes(ttree) == sum(v.nbytes for v in tree.values())
    folder = str(tmp_path)
    tw = tstore.WeightStore(tstore.DiskFolder(folder), transport="delta(chain=2)")
    jw = jstore.WeightStore(jstore.DiskFolder(folder), transport="delta(chain=2)")
    for step in range(4):
        tw.push(NodeUpdate({k: v.clone() for k, v in ttree.items()}, 1, T, counter=step))
        jw.push(JNodeUpdate(jax.tree.map(np.copy, tree), 1, J, counter=step))
        assert _stats(tw) == _stats(jw)
        t_pull, j_pull = _pull_both(folder)
        for node in (T, J):
            a, b = t_pull[node], j_pull[node]
            for x, y in zip(tree_leaves(a.params), jax.tree.leaves(b.params)):
                np.testing.assert_array_equal(as_numpy(x), np.asarray(y, np.float32)
                                              if kind == "bf16" else np.asarray(y))
            for x, y in zip(tree_leaves(a.params), jax.tree.leaves(tree)):
                np.testing.assert_array_equal(as_numpy(x).astype(np.float64),
                                              np.asarray(y).astype(np.float64))
        # one sparse change per leaf, representable in the leaf's dtype
        tree["w"][step, 0] += 1
        ttree["w"][step, 0] += 1
        if kind == "int":
            tree["steps"][step] += 1
            ttree["steps"][step] += 1
    keys = tstore.DiskFolder(folder).keys()
    links = {n: sum(k.startswith(f"chain/{n}/") for k in keys) for n in (T, J)}
    assert links[T] == links[J] == (1 if kind == "bf16" else 0)


def test_int8_delta_segments_decode_as_the_reference_decodes():
    """``c|``-scaled int8 segments, dense and sparse (the family codec's
    ``quantized`` sub-policy): the port's blob and the reference's blob for
    the same input apply to the same bits in either package."""
    seq = _sequence(2, 2)
    spec = LeafSpec.of(seq[0])
    base, new = spec.flatten(seq[0]), spec.flatten(seq[1])
    quantize = frozenset(range(len(spec.paths)))  # whole leaves dense, the rest sparse
    changed = np.flatnonzero(new != base)
    blobs = [mod.serialize_update_delta_from_flat(
        upd(seq[1], 1, "n"), sp, new, base, "h", changed=changed,
        quantize_leaves=quantize, density_threshold=0.4)
        for mod, upd, sp in ((tser, NodeUpdate, spec),
                             (jser, JNodeUpdate, JLeafSpec.of(seq[0])))]
    for blob in blobs:
        files = set(np.load(io.BytesIO(blob)).files)
        assert any(f.startswith("c|") and "d|" + f[2:] in files for f in files)  # dense int8
        assert any(f.startswith("c|") and "i|" + f[2:] in files for f in files)  # sparse int8
        t = tser.deserialize_update_delta_flat(blob, spec, base)
        j = jser.deserialize_update_delta_flat(blob, JLeafSpec.of(seq[0]), base)
        np.testing.assert_array_equal(t.flat, j.flat)
        tt = tser.deserialize_update_delta(blob, seq[0]).params
        jt = jser.deserialize_update_delta(blob, seq[0]).params
        for x, y in zip(tree_leaves(tt), jax.tree.leaves(jt)):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(tser.deserialize_update_delta_flat(blobs[0], spec, base).flat,
                                  tser.deserialize_update_delta_flat(blobs[1], spec, base).flat)
    assert tser.delta_density(seq[1], seq[0]) == jser.delta_density(seq[1], seq[0])
