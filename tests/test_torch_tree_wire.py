"""Tree layout and wire compatibility between the port and the reference.

Both packages must flatten a parameter tree to the same leaf order, paths and
``LeafSpec.key``, and a blob written by either must decode in the other to
bit-identical arrays. Inputs are made with numpy from a seed and handed to
both packages.
"""
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import serialize as jser
from repro.core import store as jstore
from repro.core import transport as jtransport
from repro.core.serialize import NodeUpdate as JNodeUpdate
from repro.core.tree import LeafSpec as JLeafSpec
from repro.models.cnn import MnistCNN as JMnistCNN
from repro.models.cnn import ResNet as JResNet
from repro_torch.core import serialize as tser
from repro_torch.core import store as tstore
from repro_torch.core import transport as ttransport
from repro_torch.core.serialize import NodeUpdate
from repro_torch.core.tree import LeafSpec, as_numpy, tree_leaves, tree_to_numpy
from repro_torch.models.cnn import MnistCNN, ResNet


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _unsorted_tree(rng):
    """Insertion order differs from sorted order at every level, with a list
    and non-f32 leaves in it."""
    return {
        "zeta": {"w": rng.normal(size=(3, 2)).astype(np.float32),
                 "a": rng.normal(size=(4,)).astype(np.float32)},
        "beta": [rng.normal(size=(2, 2)).astype(np.float32),
                 {"y": np.arange(3, dtype=np.int64), "x": rng.normal(size=(1,)).astype(np.float64)}],
        "alpha": rng.normal(size=(5,)).astype(np.float16),
    }


def _assert_same_layout(port_spec, ref_spec):
    assert port_spec.paths == ref_spec.paths
    assert port_spec.shapes == ref_spec.shapes
    assert list(port_spec.dtypes) == [d.name for d in ref_spec.dtypes]
    assert port_spec.key == ref_spec.key


def test_leafspec_matches_reference_on_unsorted_nested_tree():
    tree = _unsorted_tree(np.random.default_rng(0))
    port, ref = LeafSpec.of(tree), JLeafSpec.of(tree)
    _assert_same_layout(port, ref)
    assert port.paths[0] == "alpha" and port.paths[-1] == "zeta/w"
    np.testing.assert_array_equal(port.flatten(tree), ref.flatten(tree))
    # torch leaves flatten to the same layout and values
    ttree = {"zeta": {k: torch.from_numpy(v) for k, v in tree["zeta"].items()},
             "beta": [torch.from_numpy(tree["beta"][0]),
                      {k: torch.from_numpy(v) for k, v in tree["beta"][1].items()}],
             "alpha": torch.from_numpy(tree["alpha"])}
    _assert_same_layout(LeafSpec.of(ttree), ref)
    np.testing.assert_array_equal(LeafSpec.of(ttree).flatten(ttree), ref.flatten(tree))


@pytest.mark.parametrize("jmodel,tmodel", [
    (JMnistCNN(), MnistCNN()),
    (JResNet(blocks_per_stage=1), ResNet(blocks_per_stage=1)),
    (JResNet(), ResNet()),
])
def test_model_layouts_match_reference(jmodel, tmodel):
    """The port's parameter tree has the reference's paths, shapes and key
    (ResNet-18 included), so both packages' updates share one spec."""
    ref = JLeafSpec.of(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0)))
    _assert_same_layout(LeafSpec.of(tmodel.abstract()), ref)
    _assert_same_layout(LeafSpec.of(tmodel.init(0, device="cpu")), ref)


def test_resnet_flattens_keys_sorted():
    paths = LeafSpec.of(ResNet(blocks_per_stage=1).abstract()).paths
    top = list(dict.fromkeys(p.split("/")[0] for p in paths))
    assert top == ["fc", "gn0", "s0b0", "s1b0", "s2b0", "s3b0", "stem"]
    block = list(dict.fromkeys(p.split("/")[1] for p in paths if p.startswith("s1b0/")))
    assert block == ["conv1", "conv2", "gn1", "gn2", "proj"]


def test_flat_vectors_and_views_match_reference():
    params = _np_tree(JMnistCNN().init(jax.random.PRNGKey(3)))
    spec, ref = LeafSpec.of(params), JLeafSpec.of(params)
    flat = spec.flatten(params)
    np.testing.assert_array_equal(flat, ref.flatten(params))
    # unflatten: f32 leaves are views into the flat vector, numpy or tensor
    tflat = torch.from_numpy(flat.copy())
    tree = spec.unflatten(tflat)
    tflat[int(spec.offsets[spec.index["fc1/w"]])] = 123.0
    assert float(tree["fc1"]["w"][0, 0]) == 123.0
    back = torch.zeros(spec.num_params)
    spec.flatten_into(tree_to_numpy(spec.unflatten(flat)), back)
    np.testing.assert_array_equal(back.numpy(), flat)


def _update_tree(rng):
    return {"conv": {"w": rng.normal(size=(3, 3, 2, 4)).astype(np.float32),
                     "b": rng.normal(size=(4,)).astype(np.float32)},
            "dense": {"w": rng.normal(size=(7, 5)).astype(np.float32)}}


@pytest.mark.parametrize("transport", ["full", "quantized", "full|zstd", "quantized|npz"])
def test_blobs_cross_packages_both_ways(tmp_path, transport):
    """A torch node's deposit decodes in a JAX store to bit-identical arrays
    and an equal key, and the reverse holds too."""
    rng = np.random.default_rng(1)
    tparams = {k: {n: torch.from_numpy(a) for n, a in v.items()}
               for k, v in _update_tree(rng).items()}
    jparams = _update_tree(rng)
    tstore_ = tstore.WeightStore(tstore.DiskFolder(str(tmp_path)), transport=transport)
    jstore_ = jstore.WeightStore(jstore.DiskFolder(str(tmp_path)), transport=transport)
    assert tstore_.transport == jstore_.transport
    tstore_.push(NodeUpdate(tparams, 11, "torch", counter=2, lease_epoch=1))
    jstore_.push(JNodeUpdate(jparams, 13, "jax", counter=4))
    j_pulled = {u.node_id: u for u in jstore_.pull()}
    t_pulled = {u.node_id: u for u in tstore_.pull()}
    for node in ("torch", "jax"):
        a, b = j_pulled[node], t_pulled[node]
        assert a.spec.key == b.spec.key and a.spec.paths == b.spec.paths
        np.testing.assert_array_equal(a.flat, b.flat)
        assert (a.num_examples, a.counter, a.lease_epoch) == (b.num_examples, b.counter,
                                                              b.lease_epoch)
    if transport.startswith("full"):
        np.testing.assert_array_equal(j_pulled["torch"].flat,
                                      LeafSpec.of(tparams).flatten(tparams))
        np.testing.assert_array_equal(t_pulled["jax"].flat, JLeafSpec.of(jparams).flatten(jparams))
    assert jstore_.state_hash() == tstore_.state_hash()
    assert jstore_.state_hash(exclude_node="jax") == tstore_.state_hash(exclude_node="jax")


def test_tree_decode_of_non_f32_leaves_crosses_packages():
    tree = _unsorted_tree(np.random.default_rng(2))
    blob = tser.serialize_update(NodeUpdate(tree, 1, "n"))
    jtree = jser.deserialize_update(blob).params
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    back = tser.deserialize_update(jser.serialize_update(JNodeUpdate(tree, 1, "n"))).params
    for a, b in zip(tree_leaves(back), tree_leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_bf16_tensor_leaves_ship_as_reference_does():
    ml_dtypes = pytest.importorskip("ml_dtypes")
    t = torch.randn(4, 3).to(torch.bfloat16)
    blob = tser.serialize_update(NodeUpdate({"w": t}, 1, "n"))
    leaf = jser.deserialize_update(blob).params["w"]
    assert leaf.dtype == np.dtype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(leaf.astype(np.float32), t.float().numpy())
    assert LeafSpec.of({"w": t}).key == JLeafSpec.of({"w": leaf}).key


@pytest.mark.parametrize("dtype", ["bfloat16", "float8_e4m3fn"])
def test_narrow_float_wire_round_trip_without_ml_dtypes(tmp_path, monkeypatch, dtype):
    """bf16/fp8 leaves cross the wire both ways with ``ml_dtypes`` hidden from
    the port: a JAX-pushed blob decodes in the port to the same values (as
    torch tensors of that dtype) and the same ``LeafSpec.key``, flat and tree
    path alike, and a port-pushed blob decodes in the reference."""
    rng = np.random.default_rng(7)
    jtree = {"w": np.asarray(jax.numpy.asarray(rng.normal(size=(6, 5)), dtype)),
             "b": rng.normal(size=(5,)).astype(np.float32)}
    folder = str(tmp_path)
    jstore.WeightStore(jstore.DiskFolder(folder)).push(JNodeUpdate(jtree, 3, "jax", counter=1))
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "ml_dtypes", None)
        (flat,) = tstore.WeightStore(tstore.DiskFolder(folder)).pull()
        assert flat.spec.key == JLeafSpec.of(jtree).key and flat.spec.dtypes[1] == dtype
        np.testing.assert_array_equal(flat.flat, JLeafSpec.of(jtree).flatten(jtree))
        tree = tser.deserialize_update(tstore.DiskFolder(folder).get("latest/jax")).params
        assert tree["w"].dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(tree["w"].float().numpy(), jtree["w"].astype(np.float32))
        assert LeafSpec.of(tree).key == flat.spec.key
        tstore.WeightStore(tstore.DiskFolder(folder)).push(
            NodeUpdate({"w": (-tree["w"].float()).to(tree["w"].dtype),
                        "b": torch.from_numpy(jtree["b"])}, 2, "torch"))
    back = {u.node_id: u for u in jstore.WeightStore(jstore.DiskFolder(folder)).pull()}
    assert back["torch"].spec.key == back["jax"].spec.key
    np.testing.assert_array_equal(back["torch"].flat[5:], -back["jax"].flat[5:])
    leaf = jser.deserialize_update(jstore.DiskFolder(folder).get("latest/torch")).params["w"]
    assert leaf.dtype == jtree["w"].dtype
    np.testing.assert_array_equal(leaf.astype(np.float32), -jtree["w"].astype(np.float32))


def test_state_and_obs_blobs_cross_packages(tmp_path):
    state = {"x": torch.arange(5, dtype=torch.float32), "m": torch.ones(5)}
    blob = tser.serialize_strategy_state("n1", "fedadam", 3, state)
    arrays, meta = jser.deserialize_strategy_state(blob)
    np.testing.assert_array_equal(arrays["x"], np.arange(5, dtype=np.float32))
    assert meta["strategy"] == "fedadam" and meta["counter"] == 3
    back, _ = tser.deserialize_strategy_state(
        jser.serialize_strategy_state("n1", "fedadam", 3, {"v": np.ones(2, np.float32)}))
    np.testing.assert_array_equal(back["v"], np.ones(2, np.float32))
    # telemetry written by a port store reads in the reference's collector
    folder = tstore.DiskFolder(str(tmp_path))
    tstore.WeightStore(folder).push_obs("torchnode", 0, {"rounds": 3}, keep=4)
    from repro.core.telemetry import collect_obs

    assert collect_obs(str(tmp_path)) == {"torchnode": [{"rounds": 3}]}


def test_delta_blobs_raise_instead_of_decoding_wrongly(tmp_path):
    """A port reader of a JAX node's delta blob rebuilds the pushed params bit
    for bit; when the base it names is gone (a writer mid-rebase), the pull
    skips the node instead of returning stale or wrong parameters."""
    params = {"w": np.random.default_rng(4).normal(size=(200, 100)).astype(np.float32)}
    writer = jstore.WeightStore(jstore.DiskFolder(str(tmp_path)), transport="delta")
    writer.push(JNodeUpdate(params, 1, "jax", counter=0))
    params["w"][0, 0] += 1.0
    writer.push(JNodeUpdate(params, 1, "jax", counter=1))  # a delta blob now
    folder = tstore.DiskFolder(str(tmp_path))
    assert "delta_of" in jser.peek_meta(folder.get("latest/jax"))
    (got,) = tstore.WeightStore(folder).pull()
    assert got.counter == 1 and got.spec.key == JLeafSpec.of(params).key
    np.testing.assert_array_equal(got.flat, params["w"].reshape(-1))
    for key in folder.keys():
        if key.startswith("base/"):
            folder.delete(key)
    assert tstore.WeightStore(folder).pull() == []


@pytest.mark.parametrize("spec", ["delta", "delta(chain=4)|zstd", "topk(adaptive)",
                                  "family(adapters=full)"])
def test_deferred_transports_validate_then_raise(spec, monkeypatch):
    """The transports a port store once refused now validate as the reference
    does, build, and write blobs the reference reads back exactly; a ``zstd``
    envelope with no zstd module still raises ``ImportError``."""
    assert ttransport.normalize_transport(spec) == jtransport.normalize_transport(spec)
    rng = np.random.default_rng(6)
    params = {"lora_a": rng.normal(size=(300,)).astype(np.float32),
              "w": rng.normal(size=(400, 50)).astype(np.float32)}
    folder = tstore.InMemoryFolder()
    store = tstore.WeightStore(folder, transport=spec)
    assert store.transport == jtransport.normalize_transport(spec)
    for counter in range(3):
        store.push(NodeUpdate({k: torch.from_numpy(v.copy()) for k, v in params.items()},
                              1, "torch", counter=counter))
        params["lora_a"][counter] += 1.0
    assert "delta_of" in jser.peek_meta(jser.maybe_decompress(folder.get("latest/torch")))
    (got,) = jstore.WeightStore(folder).pull()
    params["lora_a"][2] -= 1.0  # the last push came before this change
    np.testing.assert_array_equal(got.flat, JLeafSpec.of(params).flatten(params))
    if spec.endswith("zstd"):
        monkeypatch.setattr(tser, "_ZSTD_MODULE", False)
        with pytest.raises(ImportError):
            tstore.WeightStore(tstore.InMemoryFolder(), transport=spec)


@pytest.mark.parametrize("spec", ["full", "quantized|zstd", "delta_q", "topk|delta",
                                  "family(embeddings=quantized|npz, adapters)", "topk(0.05)"])
def test_spec_grammar_matches_reference(spec):
    assert ttransport.normalize_transport(spec) == jtransport.normalize_transport(spec)
    assert ttransport.parse_pipeline_spec(spec) == jtransport.parse_pipeline_spec(spec)


@pytest.mark.parametrize("bad", ["", "zstd|full", "delta(chain=0)", "bogus", "full(x)",
                                 "delta(q,chain=2)", "topk|quantized"])
def test_spec_grammar_rejects_what_reference_rejects(bad):
    with pytest.raises(ValueError):
        jtransport.normalize_transport(bad)
    with pytest.raises(ValueError):
        ttransport.normalize_transport(bad)


@pytest.mark.parametrize("uri", ["shard8+cache+/mnt/x", "shard4x2+retry+memory://a",
                                 "cache+retry+s3://b/p", "/plain/path"])
def test_folder_uri_grammar_matches_reference(uri):
    assert ttransport.parse_folder_uri(uri) == jtransport.parse_folder_uri(uri)


def test_quantized_decode_matches_reference_dequantization():
    rng = np.random.default_rng(5)
    params = _update_tree(rng)
    blob = tser.serialize_update_quantized(NodeUpdate(params, 1, "n"))
    specs_t, specs_j = {}, {}
    t = tser.deserialize_update_flat(blob, specs_t)
    j = jser.deserialize_update_flat(blob, specs_j)
    np.testing.assert_array_equal(t.flat, j.flat)
    tree = tser.deserialize_update_quantized(blob).params
    for a, b in zip(tree_leaves(tree), jax.tree.leaves(jser.deserialize_update_quantized(blob).params)):
        np.testing.assert_array_equal(as_numpy(a), b)
