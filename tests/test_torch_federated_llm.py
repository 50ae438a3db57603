"""The federated LLM scenario in the port: the twins of
``tests/test_federated_llm.py`` and of the two LM examples.

- The leaf-family machinery on the port's LoRA model: ``family_view``, the
  ``family(...)`` transport, ``PartialFedAvg(families=...)`` held against the
  reference's frozen per-leaf oracle ``PartialFedAvgRef``, and adapter-only
  federation leaving every non-federated leaf bit-exact.
- Async port nodes training the tiny LoRA transformer through a
  ``delta(chain=4)`` store.
- A mixed fleet — a JAX node and a torch node on one ``DiskFolder`` — held
  against an all-JAX fleet at 1e-4, under ``delta(chain=4)`` FedAvg and
  adapters-only; in the adapters-only run each node's non-federated leaves
  come back from every aggregate bit for bit.
- ``main`` of ``repro_torch.examples.federated_llm`` and
  ``repro_torch.examples.federated_serving`` on the CPU at a tiny size.
Everything runs on the CPU, torch on two threads.
"""
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.core import AsyncFederatedNode as JAsyncNode
from repro.core import FederatedCallback as JFederatedCallback
from repro.core import NodeUpdate as JNodeUpdate
from repro.core import normalize_transport as jnormalize_transport
from repro.core.store import DiskFolder as JDiskFolder
from repro.core.strategies_ref import PartialFedAvgRef
from repro.core.tree import LeafSpec as JLeafSpec
from repro.data import lm_batch_iterator as jlm_batches
from repro.data import make_synthetic_wikitext as jwikitext
from repro.models import ModelConfig as JModelConfig
from repro.models import build_model as jbuild_model
from repro.optim import adamw as jadamw
from repro.optim import chain_clip as jchain_clip
from repro.training import Trainer as JTrainer
from repro_torch.core import (
    AsyncFederatedNode,
    DiskFolder,
    FederatedCallback,
    InMemoryFolder,
    NodeUpdate,
    WeightStore,
    family_transport_spec,
    normalize_transport,
    run_threaded,
)
from repro_torch.core.partition import partition_sequence_dataset
from repro_torch.core.strategies import FedAvg, PartialFedAvg
from repro_torch.core.tree import LeafSpec, as_numpy, tree_leaves, tree_map, tree_to_numpy
from repro_torch.data import lm_batch_iterator, make_synthetic_wikitext
from repro_torch.examples import federated_llm, federated_serving
from repro_torch.models import ModelConfig, build_model, load_jax_params
from repro_torch.optim import adamw, chain_clip
from repro_torch.training import Trainer

from _torch_parity import np_params

TINY_FIELDS = dict(name="tiny-lm", n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
                   vocab_size=512, activation="gelu", dtype="float32", lora_rank=4)
TINY, JTINY = ModelConfig(**TINY_FIELDS), JModelConfig(**TINY_FIELDS)
SEQ, BATCH = 16, 2
TOL = 1e-4  # the reference's own tolerance for f32 model outputs


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The tensors here are small: two intra-op threads do the work, and
    the suite's other workers keep the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _tiny_params(seed=0):
    """The port's TINY model and numpy parameters in its layout."""
    return build_model(TINY), np_params(jbuild_model(JTINY), seed)


# --- the headline scenario -----------------------------------------------------


def test_async_nodes_train_llm_through_delta_chain_store():
    """≥2 async port nodes train the tiny LoRA transformer on non-IID shards
    through a real WeightStore with a delta-chain pipeline spec."""
    model, init = _tiny_params()
    data = make_synthetic_wikitext(vocab_size=TINY.vocab_size, train_tokens=4_000, seed=0)
    shards = partition_sequence_dataset(data.train_tokens, 2)
    folder = InMemoryFolder()

    def client(i):
        trainer = Trainer(loss_fn=lambda p, b, r: model.loss(p, b),
                          optimizer=chain_clip(adamw(1e-3), 1.0), init_params=init, seed=i,
                          name=f"node{i}", device="cpu")
        node = AsyncFederatedNode(strategy=FedAvg(device="cpu"), shared_folder=folder,
                                  node_id=f"node{i}", transport="delta(chain=4)")
        cb = FederatedCallback(node, num_examples_per_epoch=2 * BATCH)
        trainer.fit(lambda e: lm_batch_iterator(shards[i], batch_size=BATCH, seq_len=SEQ,
                                                seed=i, epoch=e),
                    epochs=3, steps_per_epoch=2, callbacks=[cb])
        # a fast node may finish before its peer deposits anything: keep
        # federating until it has aggregated once
        deadline = time.monotonic() + 60.0
        while node.num_aggregations == 0 and time.monotonic() < deadline:
            node.update_parameters(trainer.host_params(), num_examples=BATCH)
            time.sleep(0.02)
        return {"loss": trainer.log[-1]["loss"], "aggs": node.num_aggregations,
                "stats": node.transport_stats()}

    results = run_threaded([lambda i=i: client(i) for i in range(2)])
    assert all(r.error is None for r in results), [r.traceback for r in results]
    for r in results:
        assert r.result["aggs"] >= 1 and np.isfinite(r.result["loss"])
        assert r.result["stats"]["bytes_written"] > 0 and r.result["stats"]["bytes_read"] > 0


def test_adapter_only_federation_semantics():
    """families=('adapters',) federates exactly the LoRA leaves: adapter
    leaves average across nodes, every other leaf stays the node's own,
    bit-exact."""
    _, p_a = _tiny_params(seed=0)
    p_b = jax.tree.map(lambda x: x + np.float32(0.01), p_a)
    folder = InMemoryFolder()
    node_a = AsyncFederatedNode(shared_folder=folder, node_id="a", families=("adapters",),
                                device="cpu")
    node_b = AsyncFederatedNode(shared_folder=folder, node_id="b", families=("adapters",),
                                device="cpu")
    assert isinstance(node_a.strategy, PartialFedAvg)
    assert node_a.update_parameters(p_a, num_examples=1) is None  # no peers yet
    agg = node_b.update_parameters(p_b, num_examples=1)
    assert agg is not None
    spec = LeafSpec.of(p_b)
    view = spec.family_view(("adapters",))
    assert view.num_params > 0
    for fam, out, la, lb, path in zip(view.leaf_names, tree_leaves(tree_to_numpy(agg)),
                                      tree_leaves(p_a), tree_leaves(p_b), spec.paths):
        if fam == "adapters":
            np.testing.assert_allclose(out, (la + lb) / 2, rtol=1e-5, atol=1e-6, err_msg=path)
        else:
            assert np.array_equal(out, lb), f"non-federated leaf drifted: {path}"


def test_adapter_only_wire_is_smaller_than_full():
    """After the anchor round, family(adapters=full) pushes ship a small
    fraction of the full-model bytes, and a plain reader decodes them."""
    _, p = _tiny_params()
    folder = InMemoryFolder()
    store = WeightStore(folder, families=("adapters",))
    store.push(NodeUpdate(p, num_examples=1, node_id="n", counter=0))
    anchor_bytes = store.transport_stats()["bytes_written"]
    p2 = jax.tree.map(lambda x: x + np.float32(1e-3), p)
    store.push(NodeUpdate(p2, num_examples=1, node_id="n", counter=1))
    family_bytes = store.transport_stats()["bytes_written"] - anchor_bytes
    spec = LeafSpec.of(p)
    view = spec.family_view(("adapters",))
    assert family_bytes < anchor_bytes * max(0.2, 4 * view.num_params / spec.num_params)
    got = spec.flatten(WeightStore(folder).pull_node("n").params)
    np.testing.assert_allclose(got[view.indices], spec.flatten(p2)[view.indices], rtol=1e-6)


# --- FamilyView on the port's model -------------------------------------------


def test_family_view_selects_lora_leaves():
    model = build_model(TINY)
    spec = LeafSpec.of(model.init(0, device="cpu"))
    assert spec.key == JLeafSpec.of(np_params(jbuild_model(JTINY), 0)).key
    view = spec.family_view(("adapters",))
    assert view.paths and all("lora_" in path for path in view.paths)
    # both A and B matrices (layers are stacked: one leaf, leading dim L)
    assert sum("lora_a" in path for path in view.paths) == 1
    assert sum("lora_b" in path for path in view.paths) == 1
    assert view.num_params == TINY.n_layers * 2 * TINY.d_model * TINY.lora_rank
    flat = np.random.default_rng(0).normal(size=spec.num_params).astype(np.float32)
    out = np.zeros_like(flat)
    view.scatter(view.extract(flat), out)
    assert np.array_equal(out[view.indices], flat[view.indices])
    assert not out[~view.mask].any()
    np.testing.assert_array_equal(view.indices_of("adapters"), view.indices)


def test_family_view_errors():
    spec = LeafSpec.of(build_model(TINY).abstract())
    with pytest.raises(KeyError, match="unknown leaf family"):
        spec.family_view(("no_such_family",))
    no_lora = LeafSpec.of(build_model(TINY.replace(lora_rank=0)).abstract())
    with pytest.raises(ValueError, match="match no leaf"):
        no_lora.family_view(("adapters",))


def test_lora_changes_forward_pass():
    """The adapters the federation ships are live weights: perturbing the
    zero-initialised lora_b changes the loss, in the port as in the
    reference."""
    model = build_model(TINY)
    p = model.init(0, device="cpu")
    batch = {"tokens": torch.arange(8, dtype=torch.int32)[None, :],
             "labels": torch.arange(1, 9, dtype=torch.int32)[None, :]}
    loss0, _ = model.loss(p, batch)
    blocks = p["blocks"]["u0_attn"]["attn"]
    assert not blocks["lora_b"]["w"].any()
    blocks["lora_b"]["w"] += 0.5
    loss1, _ = model.loss(p, batch)
    assert not np.allclose(float(loss0), float(loss1))


# --- family transport grammar ----------------------------------------------------


@pytest.mark.parametrize("spec,want", [
    ("family(adapters)", "family(adapters=full)"),
    ("family(embeddings=quantized|zstd, adapters=full)",
     "family(adapters=full,embeddings=quantized)|zstd"),
    ("family(adapters=delta)|npz", "family(adapters=delta)|npz")])
def test_family_spec_grammar_canonicalization(spec, want):
    assert normalize_transport(spec) == jnormalize_transport(spec) == want


def test_family_spec_helper_and_rejections():
    assert family_transport_spec("adapters") == "family(adapters=full)"
    assert family_transport_spec(("norms", "adapters")) == "family(adapters=full,norms=full)"
    assert (family_transport_spec({"embeddings": "quantized", "adapters": "full"})
            == "family(adapters=full,embeddings=quantized)")
    for bad, match in (("family()", None), ("family(adapters=topk)", "sub-policy"),
                       ("family(adapters=delta(chain=2))", "whole-pipeline"),
                       ("family(adapters=full|zstd,norms=full|npz)", "envelope")):
        with pytest.raises(ValueError, match=match):
            normalize_transport(bad)
    with pytest.raises(ValueError):
        family_transport_spec(())
    with pytest.raises(ValueError, match="not both"):
        WeightStore(InMemoryFolder(), transport="delta", families=("adapters",))


# --- family subset ≡ the reference's masked per-leaf oracle -----------------------


def _property_tree(rng):
    """A small LM-shaped tree with every family, unmatched leaves and an
    int64 leaf no family touches."""
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {
        "embed": {"w": f(12, 4)},
        "blocks": {
            "u0": {"attn": {"wq": {"w": f(4, 4)}, "lora_a": {"w": f(4, 2)},
                            "lora_b": {"w": f(2, 4)}},
                   "norm1": {"scale": f(4)}},
            "u1": {"mlp": {"w": f(4, 8)}, "norm2": {"scale": f(4)}},
        },
        "unembed": {"w": f(4, 12)},
        "step": np.int64(rng.integers(0, 100)),
    }


@pytest.mark.parametrize("seed,families,n_peers", [
    (0, ("adapters",), 1), (1, ("norms",), 2), (2, ("embeddings",), 3),
    (3, ("adapters", "norms"), 4), (4, ("adapters", "embeddings", "norms"), 2)])
def test_family_subset_matches_reference_oracle(seed, families, n_peers):
    """The port's PartialFedAvg(families=...) against the reference's frozen
    per-leaf oracle driven by ``FamilyView.pattern``; personal leaves, the
    int64 one included, come back bit-exact in dtype and value."""
    rng = np.random.default_rng(seed)
    trees = [_property_tree(rng) for _ in range(n_peers + 1)]
    counts = [int(rng.integers(1, 9)) for _ in trees]
    updates = [NodeUpdate(t, num_examples=c, node_id=f"p{i}", counter=0)
               for i, (t, c) in enumerate(zip(trees, counts))]
    jupdates = [JNodeUpdate(t, num_examples=c, node_id=f"p{i}", counter=0)
                for i, (t, c) in enumerate(zip(trees, counts))]
    view = LeafSpec.of(trees[0]).family_view(families)
    ours = PartialFedAvg(families=families, device="cpu").aggregate(updates[0], updates[1:])
    oracle = PartialFedAvgRef(shared_pattern=view.pattern).aggregate(jupdates[0], jupdates[1:])
    for fam, a, b, o in zip(view.leaf_names, tree_leaves(ours), jax.tree.leaves(oracle),
                            tree_leaves(trees[0])):
        a = as_numpy(a)
        if fam is None:
            assert np.array_equal(a, np.asarray(o)) and a.dtype == np.asarray(o).dtype
        np.testing.assert_allclose(a.astype(np.float64), np.asarray(b, np.float64),
                                   rtol=1e-5, atol=1e-5)


def test_nonfederated_leaves_bitexact_through_push_pull_set_params():
    """int / f64 leaves outside the family survive push → pull →
    PartialFedAvg → Trainer.set_params without any value or dtype drift."""
    rng = np.random.default_rng(0)
    tree = {
        "attn": {"lora_a": {"w": rng.normal(size=(8, 2)).astype(np.float32)}},
        "head": {"w": rng.normal(size=(16,)).astype(np.float32)},
        "vocab_freq": (rng.integers(0, 1 << 40, size=(6,))).astype(np.int64),
        "threshold": np.float64(0.1234567890123456789),  # not f32-representable
    }
    folder = InMemoryFolder()
    WeightStore(folder, families=("adapters",)).push(
        NodeUpdate(tree, num_examples=1, node_id="n", counter=0))
    pulled = WeightStore(folder).pull_node("n")
    assert np.array_equal(pulled.params["vocab_freq"], tree["vocab_freq"])
    assert pulled.params["vocab_freq"].dtype == np.int64
    assert float(pulled.params["threshold"]) == float(tree["threshold"])
    peer = NodeUpdate(tree_map(np.copy, tree), num_examples=1, node_id="peer", counter=0)
    agg = PartialFedAvg(families=("adapters",), device="cpu").aggregate(pulled, [peer])
    assert np.array_equal(as_numpy(agg["vocab_freq"]), tree["vocab_freq"])
    trainer = Trainer(loss_fn=lambda p, b, r: (p["head"]["w"].sum(), {}), optimizer=adamw(1e-3),
                      init_params=tree, device="cpu")
    trainer.set_params(agg)
    for want, have in zip(tree_leaves(tree), tree_leaves(trainer.host_params())):
        assert np.asarray(want).dtype == np.asarray(have).dtype
        assert np.array_equal(np.asarray(want), np.asarray(have))


# --- satellite regressions ------------------------------------------------------


def test_lm_batch_iterator_reaches_last_window():
    """The final window (the only one whose labels reach the stream's last
    token) is drawn, as in the reference."""
    tokens = np.arange(20, dtype=np.int32)  # seq_len 16 → starts 0..3 valid
    starts_seen = set()
    for seed in range(40):
        batch = next(iter(lm_batch_iterator(tokens, batch_size=8, seq_len=16, seed=seed)))
        want = next(iter(jlm_batches(tokens, batch_size=8, seq_len=16, seed=seed)))
        np.testing.assert_array_equal(batch["tokens"], want["tokens"])
        starts_seen.update(int(row[0]) for row in batch["tokens"])
    assert 3 in starts_seen
    batch = next(iter(lm_batch_iterator(np.arange(17, dtype=np.int32), batch_size=4,
                                        seq_len=16, seed=0)))
    assert np.array_equal(batch["tokens"][0], np.arange(16)) and batch["labels"][0][-1] == 16
    with pytest.raises(ValueError, match="too short"):
        next(iter(lm_batch_iterator(np.arange(16, dtype=np.int32), batch_size=1, seq_len=16)))


def _scalar_trainer():
    return Trainer(loss_fn=lambda p, b, r: (p["w"].sum(), {}), optimizer=adamw(1e-3),
                   init_params={"w": np.zeros((2,), np.float32)}, device="cpu")


def test_run_epoch_defers_metric_host_copy_to_epoch_end(monkeypatch):
    """A step's metrics stay tensors until the epoch's last step has been
    queued: one host copy at the end, none per step."""
    steps, copies = {"n": 0}, []
    trainer = _scalar_trainer()

    def fake_step(params, opt_state, batch, rng):
        steps["n"] += 1
        return params, opt_state, {"loss": torch.ones(())}

    trainer._train_step = fake_step
    for name in ("cpu", "item", "tolist", "numpy", "__float__"):
        def recording(self, *a, _orig=getattr(torch.Tensor, name), **k):
            copies.append(steps["n"])
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, recording)
    logs = trainer.run_epoch([{}] * 5)
    monkeypatch.undo()
    assert steps["n"] == 5 and logs["loss"] == pytest.approx(1.0)
    assert copies and all(c == 5 for c in copies), sorted(set(copies))


def test_crashed_fit_still_runs_teardown():
    calls = []

    class Cb:
        def on_train_begin(self, t): calls.append("begin")
        def on_epoch_begin(self, t, e): pass
        def on_epoch_end(self, t, e, logs): calls.append(f"epoch{e}")
        def on_train_end(self, t): calls.append("end")

    with pytest.raises(RuntimeError, match="injected crash"):
        _scalar_trainer().fit(lambda e: [{}], epochs=4, callbacks=[Cb()], crash_at_epoch=1)
    assert calls == ["begin", "epoch0", "end"]


def test_crashed_fit_does_not_leak_prefetcher_thread():
    node = AsyncFederatedNode(strategy=FedAvg(device="cpu"), shared_folder=InMemoryFolder(),
                              node_id="leaky", prefetch_interval=0.01)
    cb = FederatedCallback(node, num_examples_per_epoch=1)
    assert any(t.name == "weightstore-prefetch" and t.is_alive() for t in threading.enumerate())
    with pytest.raises(RuntimeError, match="injected crash"):
        _scalar_trainer().fit(lambda e: [{}], epochs=5, callbacks=[cb], crash_at_epoch=1)
    assert not any(t.name == "weightstore-prefetch" and t.is_alive()
                   for t in threading.enumerate())


# --- a mixed JAX/torch fleet against an all-JAX fleet -------------------------------


def _fleet(root, kinds, *, adapters_only, epochs=3, steps=2):
    """Nodes of ``kinds`` ("jax" or "torch") share one DiskFolder under
    ``root``. Rounds run in a fixed order in one thread: each node trains an
    epoch, then its FederatedCallback pushes, pulls and aggregates. Returns
    each node's final parameters (numpy leaves) and, adapters-only, checks
    at every aggregate that the node's non-adapter leaves came back bit for
    bit."""
    init = np_params(jbuild_model(JTINY), 0)
    spec = LeafSpec.of(init)
    personal = [path for path, fam in zip(spec.paths,
                                          spec.family_view(("adapters",)).leaf_names)
                if fam is None]
    assert personal and len(personal) < len(spec.paths)
    jdata = jwikitext(vocab_size=JTINY.vocab_size, train_tokens=4_000, seed=0)
    shards = partition_sequence_dataset(jdata.train_tokens, len(kinds))
    members = []
    for i, kind in enumerate(kinds):
        node_kw = ({"families": ("adapters",)} if adapters_only
                   else {"transport": "delta(chain=4)"})
        if kind == "jax":
            model = jbuild_model(JTINY)
            trainer = JTrainer(loss_fn=lambda p, b, r, m=model: m.loss(p, b),
                               optimizer=jchain_clip(jadamw(1e-3, eps=1e-6), 1.0),
                               init_params=init, seed=i, name=f"node{i}")
            if not adapters_only:
                from repro.core.strategies import FedAvg as JFedAvg
                node_kw["strategy"] = JFedAvg()
            node = JAsyncNode(shared_folder=JDiskFolder(str(root)), node_id=f"node{i}",
                              **node_kw)
            cb = JFederatedCallback(node, num_examples_per_epoch=steps * BATCH)
            batches = lambda e, i=i: jlm_batches(shards[i], batch_size=BATCH, seq_len=SEQ,  # noqa: E731
                                                 seed=i, epoch=e)
        else:
            model = build_model(TINY)
            trainer = Trainer(loss_fn=lambda p, b, r, m=model: m.loss(p, b),
                              optimizer=chain_clip(adamw(1e-3, eps=1e-6), 1.0),
                              init_params=load_jax_params(model, init, device="cpu"), seed=i,
                              name=f"node{i}", device="cpu")
            if not adapters_only:
                node_kw["strategy"] = FedAvg(device="cpu")
            node = AsyncFederatedNode(shared_folder=DiskFolder(str(root)), node_id=f"node{i}",
                                      device="cpu", **node_kw)
            cb = FederatedCallback(node, num_examples_per_epoch=steps * BATCH)
            batches = lambda e, i=i: lm_batch_iterator(shards[i], batch_size=BATCH,  # noqa: E731
                                                       seq_len=SEQ, seed=i, epoch=e)
        members.append((trainer, node, cb, batches))
    aggregates = 0
    for epoch in range(epochs):
        for trainer, node, cb, batches in members:
            logs = trainer.run_epoch(batches(epoch), steps)
            before = dict(zip(spec.paths, map(np.copy, tree_leaves(trainer.host_params()))))
            n = node.num_aggregations
            cb.on_epoch_end(trainer, epoch, logs)
            after = dict(zip(spec.paths, tree_leaves(trainer.host_params())))
            if node.num_aggregations > n:
                aggregates += 1
                if adapters_only:
                    for path in personal:
                        assert np.array_equal(after[path], before[path]), path
    for trainer, node, cb, _ in members:
        cb.on_train_end(trainer)
    assert aggregates == len(kinds) * epochs - 1  # all but the very first push
    return [[np.asarray(x) for x in tree_leaves(trainer.host_params())]
            for trainer, *_ in members]


@pytest.mark.parametrize("adapters_only", [False, True])
def test_mixed_jax_and_torch_fleet_matches_all_jax_fleet(tmp_path, adapters_only):
    """node0 in JAX and node1 in the port on one DiskFolder end where the
    all-JAX fleet's nodes end, at 1e-4, under delta(chain=4) FedAvg and under
    adapters-only federation (family(adapters=full) + PartialFedAvg)."""
    all_jax = _fleet(tmp_path / "jax", ["jax", "jax"], adapters_only=adapters_only)
    mixed = _fleet(tmp_path / "mixed", ["jax", "torch"], adapters_only=adapters_only)
    for node, (want, got) in enumerate(zip(all_jax, mixed)):
        assert len(want) == len(got)
        for a, b in zip(want, got):
            np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL, err_msg=f"node{node}")


# --- the two example twins ----------------------------------------------------------


def test_federated_llm_example_runs_on_the_cpu():
    """``main`` of the twin at its smoke size (10 steps an epoch), cut to 2
    nodes × 2 epochs, full (delta(chain=4)) and adapters-only: every node
    pushes each epoch, the nodes aggregate, and after the anchor an
    adapters-only push writes < 1% of a full one."""
    argv = ["--smoke", "--device", "cpu", "--nodes", "2", "--epochs", "2"]
    full = federated_llm.main(argv)
    adapters = federated_llm.main(argv + ["--adapters-only"])
    for records in (full, adapters):
        assert [r["node"] for r in records] == ["node0", "node1"]
        assert all(r["pushes"] == 2 and len(r["push_bytes"]) == 2 for r in records)
        assert sum(r["aggregations"] for r in records) >= 1
        assert all(np.isfinite(r["eval_loss"]) and r["spans"]["train"]["count"] == 2
                   for r in records)
    full_push = np.mean([b for r in full for b in r["push_bytes"]])
    adapter_push = max(b for r in adapters for b in r["push_bytes"][1:])
    assert adapter_push < 0.01 * full_push, (adapter_push, full_push)


def test_federated_serving_example_runs_on_the_cpu():
    """``main`` of the twin at its smoke size: the server deploys within the
    example's 120 s, swaps at least once, serves while the trainers run,
    and the dashboard shows the serving row."""
    out = federated_serving.main(["--smoke", "--device", "cpu", "--new-tokens", "4"])
    assert out["first_deploy_s"] < federated_serving.FIRST_DEPLOY_S
    assert out["stats"]["swaps"] >= 1 and out["batches"]
    assert all(r["pushes"] == 2 for r in out["trainers"])
    assert out["stats"]["tokens"] == 4 * 4 * len(out["batches"])
