"""Sharded and hierarchical gossip: the port against the reference.

Group assignment, the summary-tree topology (branching, elected holders,
scopes, diameter), the summary, super-summary and roster blobs, the summary
each package writes for one group state, shard-URI routing and its errors,
and a mixed fleet of JAX and torch ``SyncFederatedNode``s on one
``shard2x2+`` store whose writers use the delta and top-k transports.
"""
import jax
import numpy as np
import pytest

import repro.api as japi
import repro.core as jcore
from repro import optim as joptim
from repro.core import gossip as jgossip
from repro.core import serialize as jser
from repro.core import store as jstore
from repro.core import strategies as jstrat
from repro.data import batch_iterator as j_batches
from repro.models import cnn as jcnn
from repro.training import Trainer as JTrainer
from repro_torch import api as tapi
from repro_torch import optim
from repro_torch.core import FederatedCallback, NodeUpdate, SyncFederatedNode, run_threaded
from repro_torch.core import gossip as tgossip
from repro_torch.core import serialize as tser
from repro_torch.core import store as tstore
from repro_torch.core.partition import partition_dataset
from repro_torch.core.strategies import FedAvg
from repro_torch.core.tree import as_numpy, tree_leaves
from repro_torch.data import batch_iterator, make_synthetic_mnist
from repro_torch.models.cnn import MnistCNN, load_jax_params
from repro_torch.training import Trainer

from _torch_parity import np_params

IDS = [f"node-{i}" for i in range(60)] + ["a/b", "x__y", "group:3", ""]


@pytest.mark.parametrize("num_groups", [1, 2, 3, 8, 17, 64])
def test_group_assignment_matches_reference(num_groups):
    for node in IDS:
        assert tgossip.default_group_of(node, num_groups) == jgossip.default_group_of(node, num_groups)
    assert tgossip.balanced_groups(IDS, num_groups) == jgossip.balanced_groups(IDS[::-1], num_groups)


@pytest.mark.parametrize("groups,levels", [(1, 1), (2, 2), (4, 1), (7, 2), (16, 2), (27, 3),
                                           (64, 2), (100, 3), (5, 4), (1000, 3)])
def test_hierarchy_matches_reference(groups, levels):
    t, j = tgossip.GossipHierarchy(groups, levels), jgossip.GossipHierarchy(groups, levels)
    assert (t.branching, t.counts, t.diameter()) == (j.branching, j.counts, j.diameter())
    assert repr(t) == repr(j)
    for level in range(levels):
        for origin in range(t.counts[level]):
            assert t.holder(level, origin) == j.holder(level, origin)
            assert t.ring(level, origin) == j.ring(level, origin)
            if level:
                assert t.children(level, origin) == j.children(level, origin)
    for g in range(groups):
        assert t.path(g) == j.path(g)
        assert t.scope(g) == j.scope(g)


def _summary_params(rng):
    return {"conv": {"w": rng.normal(size=(3, 3, 2, 4)).astype(np.float32)},
            "fc": {"b": rng.normal(size=(5,)).astype(np.float32)}}


def _assert_same_tree(a, b):
    la, lb = tree_leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(as_numpy(x), np.asarray(y))


def test_summary_super_summary_and_roster_blobs_cross_packages(tmp_path):
    rng = np.random.default_rng(0)
    group = dict(num_examples=42, origin=3, version=17, version_vector={"a": 4, "b/c": 11},
                 timestamp=2.25)
    sup = dict(num_examples=120, origin=2, level=1, version=31,
               child_versions={"6": 14, "7": 17},
               version_vector={"group:6": 4, "group:7": 9}, timestamp=3.5)
    for kind, fields in (("group", group), ("super", sup)):
        params = _summary_params(rng)
        tcls, jcls = ((tser.GroupSummary, jser.GroupSummary) if kind == "group"
                      else (tser.SuperSummary, jser.SuperSummary))
        dump = "serialize_group_summary" if kind == "group" else "serialize_super_summary"
        load = "deserialize_group_summary" if kind == "group" else "deserialize_super_summary"
        for write, read in ((getattr(tser, dump), getattr(jser, load)),
                            (getattr(jser, dump), getattr(tser, load))):
            cls = tcls if write.__module__.startswith("repro_torch") else jcls
            got = read(write(cls(params=params, **fields), compress="zstd"))
            _assert_same_tree(got.params, params)
            assert {k: getattr(got, k) for k in fields} == fields
        with pytest.raises(ValueError):  # one family never reads as the other
            getattr(tser, load)(jser.serialize_update(jser.NodeUpdate(params, 1, "n")))
    # rosters: epochs written by either package read in the other
    tfolder, jfolder = tstore.DiskFolder(str(tmp_path)), jstore.DiskFolder(str(tmp_path))
    assert tgossip.write_roster(tfolder, ["b", "a", "a"]) == 0
    assert jgossip.read_roster(jfolder) == (0, ["a", "b"])
    assert jgossip.write_roster(jfolder, ["a", "b"]) == 0  # unchanged set: no bump
    assert jgossip.write_roster(jfolder, ["a", "c"]) == 1
    assert tgossip.read_roster(tfolder) == (1, ["a", "c"])
    kind, payload = tser.deserialize_fleet_blob(jfolder.get("fleet/roster/000001"))
    assert kind == "roster" and payload["nodes"] == ["a", "c"]
    assert jser.deserialize_fleet_blob(tser.serialize_fleet_blob("spec", {"x": 1})) == (
        "spec", {"x": 1})


@pytest.mark.parametrize("transport", ["full", "delta(chain=2)", "topk(adaptive)|npz"])
def test_both_packages_summarize_one_group_state_alike(tmp_path, transport):
    """The same pushes into a torch and a JAX sharded store (three nodes in
    group 0, one in group 1) leave summaries that decode to the same bits,
    version vector and weight, whichever package reads them; a torch reader
    of the JAX folder pulls the same peers and pseudo-peers as a JAX reader."""
    groups = {"n0": 0, "n1": 0, "n2": 0, "m0": 1}
    rng = np.random.default_rng(3)
    trees = {n: _summary_params(rng) for n in groups}
    kw = dict(group_of=groups, transport=transport)
    t = tgossip.ShardedWeightStore(f"shard2+{tmp_path}/t", **kw)
    j = jgossip.ShardedWeightStore(f"shard2+{tmp_path}/j", **kw)
    for counter in range(3):
        for i, (node, tree) in enumerate(trees.items()):
            tree["conv"]["w"][counter, 0, 0, i] += 1.0
            t.push(NodeUpdate(jax.tree.map(np.copy, tree), 10 + i, node, counter=counter,
                              timestamp=float(counter)))
            j.push(jser.NodeUpdate(jax.tree.map(np.copy, tree), 10 + i, node,
                                   counter=counter, timestamp=float(counter)))
    for group, origin in ((0, 0), (1, 0), (0, 1), (1, 1)):  # own and forwarded copies
        ts, js = t.load_summary(group, origin), j.load_summary(group, origin)
        _assert_same_tree(ts.params, js.params)
        for field in ("num_examples", "origin", "version", "version_vector", "timestamp"):
            assert getattr(ts, field) == getattr(js, field), field
    assert t.load_summary(0, 0).version_vector == {"n0": 2, "n1": 2, "n2": 2}
    # the summary is the example-weighted mean of the group's latest params
    members = [trees[n] for n in ("n0", "n1", "n2")]
    want = jax.tree.map(lambda *x: np.average(np.stack(x), axis=0, weights=[10, 11, 12]),
                        *members)
    for x, y in zip(tree_leaves(t.load_summary(0, 0).params), jax.tree.leaves(want)):
        np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-6)
    # a fresh torch reader of the JAX-written folders sees what a JAX reader sees
    tr = tgossip.ShardedWeightStore(f"shard2+{tmp_path}/j", group_of=groups)
    jr = jgossip.ShardedWeightStore(f"shard2+{tmp_path}/j", group_of=groups)
    tp, jp = tr.pull(exclude="n0"), jr.pull(exclude="n0")
    assert [u.node_id for u in tp] == [u.node_id for u in jp] == ["n1", "n2", "group:1"]
    for a, b in zip(tp, jp):
        assert a.spec.key == b.spec.key and (a.counter, a.num_examples) == (b.counter, b.num_examples)
        np.testing.assert_array_equal(a.flat, b.flat)
    assert tr.state_hash() == jr.state_hash()
    assert tr.state_hash(exclude_node="n0") == jr.state_hash(exclude_node="n0")


def test_shard_uris_route_and_validate_as_reference(tmp_path):
    for uri in (f"shard4+{tmp_path}/a", f"shard2+cache+{tmp_path}/b", "shard8+memory://",
                f"shard16x2+retry+{tmp_path}/c", "shard3+memory://named"):
        t, j = tstore.make_folder(uri), jstore.make_folder(uri)
        assert isinstance(t, tgossip.ShardedFolders)
        assert (t.num_groups, t.levels, t.uri) == (j.num_groups, j.levels, j.uri)
        for g in (0, t.num_groups - 1):
            assert t.group_uri(g) == j.group_uri(g)
            assert type(t.group_folder(g)).__name__ == type(j.group_folder(g)).__name__
        store = tapi.connect(uri, transport="delta(chain=4)")
        assert isinstance(store, tgossip.ShardedWeightStore)
        assert store.transport == japi.connect(uri, transport="delta(chain=4)").transport
    assert isinstance(tstore.make_folder(str(tmp_path / "shardware")), tstore.DiskFolder)
    for bad in ("cache+shard2+memory://", "shard2+shard2+memory://", "shard2x0+memory://",
                "shard0+memory://"):
        with pytest.raises(ValueError):
            jstore.make_folder(bad)
        with pytest.raises(ValueError):
            tstore.make_folder(bad)
    for mod in (jgossip, tgossip):
        with pytest.raises(ValueError):
            mod.ShardedFolders.from_uri("cache+memory://")
        for kwargs in ({"transport": "gzip"}, {"gossip_fanout": 0}, {"summary_sample": 0}):
            with pytest.raises(ValueError):
                mod.ShardedWeightStore("shard2+memory://", **kwargs)
    with pytest.raises(ValueError, match="prefetch"):
        tapi.connect("shard2+memory://", prefetch=True)
    store = tapi.connect("shard2+memory://", prefetch=(0.05, "n"))
    store.stop_prefetch()
    store = tgossip.ShardedWeightStore("shard2+memory://", group_of=lambda n: 7)
    with pytest.raises(ValueError):
        store.push(NodeUpdate({"w": np.zeros(3, np.float32)}, 1, "n"))
    with pytest.raises(NotImplementedError, match="13a"):
        tapi.connect("shard2+s3://bucket/p").push(NodeUpdate({"w": np.zeros(3, np.float32)}, 1, "n"))


# --- a mixed fleet on hierarchical shards --------------------------------------

EPOCHS, STEPS, BATCH = 3, 2, 32
GROUPS = {"jax0": 0, "torch0": 0, "jax1": 1, "torch1": 1}
# top-k allows only a bare '|delta' after it, so the two transports ride apart
TRANSPORTS = {"jax0": "topk(adaptive)|zstd", "jax1": "delta(chain=4)|zstd",
              "torch0": "delta(chain=4)|zstd", "torch1": "topk(adaptive)|zstd"}


def _fit(trainer, node, shard, batches, seed, record):
    update = node.update_parameters

    def recorded(*args, **kwargs):
        out = update(*args, **kwargs)
        record.append(out)
        return out

    node.update_parameters = recorded
    x, y = shard
    trainer.fit(lambda e: batches(x, y, batch_size=BATCH, seed=seed, epoch=e), epochs=EPOCHS,
                steps_per_epoch=STEPS,
                callbacks=[FederatedCallback(node, num_examples_per_epoch=STEPS * BATCH)])
    return node.num_aggregations


def _jax_client(name, init, uri, shard, record):
    model = jcnn.MnistCNN()
    # eps=1e-6: see tests/test_torch_models_train.py
    trainer = JTrainer(loss_fn=lambda p, b, r: model.loss(p, b),
                       optimizer=joptim.adam(1e-3, eps=1e-6), init_params=init, seed=1)
    store = japi.connect(uri, transport=TRANSPORTS[name], keep_history=True, group_of=GROUPS)
    node = jcore.SyncFederatedNode(num_nodes=2, strategy=jstrat.FedAvg(), node_id=name,
                                   store=store, timeout=120)
    return _fit(trainer, node, shard, j_batches, 1, record)


def _torch_client(name, init, uri, shard, record):
    model = MnistCNN()
    trainer = Trainer(loss_fn=lambda p, b, r: model.loss(p, b),
                      optimizer=optim.adam(1e-3, eps=1e-6),
                      init_params=load_jax_params(model, init, device="cpu"), seed=1,
                      device="cpu")
    store = tapi.connect(uri, transport=TRANSPORTS[name], keep_history=True, group_of=GROUPS)
    node = SyncFederatedNode(num_nodes=2, strategy=FedAvg(device="cpu"), node_id=name,
                             store=store, timeout=120, device="cpu")
    return _fit(trainer, node, shard, batch_iterator, 1, record)


def test_mixed_fleet_on_hierarchical_shards_agrees_every_round(tmp_path):
    """JAX and torch nodes share each group of a ``shard2x2+`` store; within
    a group they aggregate the same round set (FedAvg, 1e-6 each round), and
    afterwards both packages read the same peers, pseudo-peers and state
    hashes from every group."""
    uri = f"shard2x2+{tmp_path}"
    init = np_params(jcnn.MnistCNN(), 4)
    data = make_synthetic_mnist(num_train=256, num_test=16, seed=2)
    shards = partition_dataset(data.x_train, data.y_train, num_nodes=2, skew=0.8, seed=2)
    records = {n: [] for n in GROUPS}
    clients = [lambda n=n: (_jax_client if n.startswith("jax") else _torch_client)(
        n, init, uri, shards[GROUPS[n]], records[n]) for n in GROUPS]
    for r in run_threaded(clients, names=list(GROUPS)):
        assert r.error is None, r.traceback
        assert r.result == EPOCHS
    for g in (0, 1):
        jrec, trec = records[f"jax{g}"], records[f"torch{g}"]
        assert len(jrec) == len(trec) == EPOCHS
        for r, (a, b) in enumerate(zip(jrec, trec)):
            for x, y in zip(jax.tree.leaves(a), tree_leaves(b)):
                np.testing.assert_allclose(as_numpy(y), np.asarray(x), rtol=1e-6, atol=1e-6,
                                           err_msg=f"group {g} round {r}")
    tr = tapi.connect(uri, group_of=GROUPS)
    jr = japi.connect(uri, group_of=GROUPS)
    assert tr.state_hash() == jr.state_hash()
    for node in GROUPS:
        assert tr.state_hash(exclude_node=node) == jr.state_hash(exclude_node=node)
        tp, jp = tr.pull(exclude=node), jr.pull(exclude=node)
        assert [u.node_id for u in tp] == [u.node_id for u in jp]
        assert f"group:{1 - GROUPS[node]}" in [u.node_id for u in tp]
        for a, b in zip(tp, jp):
            assert a.counter == b.counter and a.spec.key == b.spec.key
            np.testing.assert_array_equal(a.flat, b.flat)
    metas = [jser.peek_meta(jser.maybe_decompress(jstore.DiskFolder(
        f"{tmp_path}/group{GROUPS[n]:04d}").get(f"latest/{n}"))) for n in GROUPS]
    assert all("delta_of" in m for m in metas)  # every writer's last push was a delta
