"""The port's federation loop end to end, against the reference and beside it.

(a) The same two-client synchronous MnistCNN federation, run once by each
    package from one init, ends within 1e-4.
(b) A mixed fleet — one JAX client and one torch client on one DiskFolder —
    finishes, and both aggregate to the same weights every round.
(c) The port imports neither JAX nor the reference package.
(d) Asking for CUDA without a card raises instead of running on the CPU.
"""
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro import optim as joptim
from repro.core import store as jstore
from repro.core import strategies as jstrat
from repro.data import batch_iterator as j_batches
from repro.models import cnn as jcnn
from repro.training import Trainer as JTrainer
from repro_torch import api, optim
from repro_torch.core import (
    AsyncFederatedNode,
    FederatedCallback,
    FederationTimeout,
    InMemoryFolder,
    ShardedWeightStore,
    SyncFederatedNode,
    run_threaded,
    simulate_timeline,
    straggler_speedup,
)
from repro_torch.core.partition import partition_dataset
from repro_torch.core.store import DiskFolder
from repro_torch.core.strategies import FedAdam, FedAvg
from repro_torch.core.tree import as_numpy, tree_leaves
from repro_torch.data import batch_iterator, make_synthetic_mnist
from repro_torch.kernels import _build
from repro_torch.models.cnn import MnistCNN, load_jax_params
from repro_torch.training import Trainer

from _torch_parity import np_params

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
EPOCHS, STEPS, BATCH = 2, 2, 32


def _shards():
    data = make_synthetic_mnist(num_train=256, num_test=16, seed=1)
    return partition_dataset(data.x_train, data.y_train, num_nodes=2, skew=0.8, seed=1)


def _jax_client(i, init, folder, shards, record=None):
    model = jcnn.MnistCNN()
    # eps=1e-6: see tests/test_torch_models_train.py (Adam at eps=1e-8 turns
    # gradient entries within rounding noise of zero into steps of ±lr)
    trainer = JTrainer(loss_fn=lambda p, b, r: model.loss(p, b),
                       optimizer=joptim.adam(1e-3, eps=1e-6), init_params=init, seed=i)
    node = jcore.SyncFederatedNode(num_nodes=2, strategy=jstrat.FedAvg(), node_id=f"jax{i}",
                                   shared_folder=folder, timeout=120)
    return _fit(trainer, node, shards[i], j_batches, i, record)


def _torch_client(i, init, folder, shards, record=None):
    model = MnistCNN()
    trainer = Trainer(loss_fn=lambda p, b, r: model.loss(p, b),
                      optimizer=optim.adam(1e-3, eps=1e-6),
                      init_params=load_jax_params(model, init, device="cpu"), seed=i,
                      device="cpu")
    node = SyncFederatedNode(num_nodes=2, strategy=FedAvg(device="cpu"), node_id=f"torch{i}",
                             shared_folder=folder, timeout=120, device="cpu")
    return _fit(trainer, node, shards[i], batch_iterator, i, record)


def _fit(trainer, node, shard, batches, i, record):
    if record is not None:
        update = node.update_parameters

        def recorded(*args, **kwargs):
            out = update(*args, **kwargs)
            record.append(out)
            return out

        node.update_parameters = recorded
    x, y = shard
    trainer.fit(lambda e: batches(x, y, batch_size=BATCH, seed=i, epoch=e), epochs=EPOCHS,
                steps_per_epoch=STEPS,
                callbacks=[FederatedCallback(node, num_examples_per_epoch=STEPS * BATCH)])
    return trainer.host_params(), node.num_aggregations


def test_sync_federation_matches_reference_run(tmp_path):
    """(a) Barrier + sorted aggregation order make each run deterministic;
    the two packages' runs from one init end within 1e-4."""
    init, shards = np_params(jcnn.MnistCNN(), 0), _shards()
    jfolder = jstore.DiskFolder(str(tmp_path / "jax"))
    tfolder = DiskFolder(str(tmp_path / "torch"))
    jres = jcore.run_threaded([lambda i=i: _jax_client(i, init, jfolder, shards) for i in (0, 1)])
    tres = run_threaded([lambda i=i: _torch_client(i, init, tfolder, shards) for i in (0, 1)])
    for jr, tr in zip(jres, tres):
        assert jr.error is None, jr.traceback
        assert tr.error is None, tr.traceback
        (jparams, jaggs), (tparams, taggs) = jr.result, tr.result
        assert jaggs == taggs == EPOCHS
        for a, b in zip(jax.tree.leaves(jparams), tree_leaves(tparams)):
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)


def test_mixed_jax_and_torch_fleet_agrees_every_round(tmp_path):
    """(b) One JAX node and one torch node share a DiskFolder; after each
    round their FedAvg aggregates agree within 1e-6."""
    init, shards = np_params(jcnn.MnistCNN(), 2), _shards()
    jrec, trec = [], []
    res = run_threaded([
        lambda: _jax_client(0, init, jstore.DiskFolder(str(tmp_path)), shards, jrec),
        lambda: _torch_client(1, init, DiskFolder(str(tmp_path)), shards, trec),
    ])
    for r in res:
        assert r.error is None, r.traceback
    assert len(jrec) == len(trec) == EPOCHS
    for r, (a, b) in enumerate(zip(jrec, trec)):
        for x, y in zip(jax.tree.leaves(a), tree_leaves(b)):
            np.testing.assert_allclose(as_numpy(y), np.asarray(x), rtol=1e-6, atol=1e-6,
                                       err_msg=f"round {r}")
    # both packages agree on the folder's state
    assert (jstore.WeightStore(jstore.DiskFolder(str(tmp_path))).state_hash()
            == api.connect(str(tmp_path)).state_hash())


def test_port_imports_neither_jax_nor_reference():
    """(c) Every module of repro_torch imports with no jax* and no repro[.*]
    in sys.modules, and no source file names them in an import."""
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'repro')\n"
        "       or k.startswith('jax')]\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 20
    for path in (SRC / "repro_torch").rglob("*.py"):
        text = path.read_text()
        for banned in ("import jax", "from jax", "import repro.", "from repro.",
                       "from repro import", "import repro\n"):
            assert banned not in text, f"{path}: {banned!r}"


def test_cuda_requested_without_a_card_raises(monkeypatch):
    """(d) Entry points default to cuda; with no card they raise rather than
    run on the CPU, and a missing nvcc raises at build time."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FedAvg()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MnistCNN().init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(loss_fn=lambda p, b, r: None, optimizer=optim.sgd(0.1),
                init_params={"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AsyncFederatedNode(shared_folder=InMemoryFolder())
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    import torch.utils.cpp_extension as cpp_ext

    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def _p(v):
    return {"w": np.full((4,), float(v), np.float32)}


def test_async_nodes_aggregate_and_skip_unchanged_store():
    folder = InMemoryFolder()
    a = AsyncFederatedNode(shared_folder=folder, node_id="a", device="cpu")
    b = AsyncFederatedNode(shared_folder=folder, node_id="b", device="cpu")
    assert a.update_parameters(_p(0.0), 10) is None  # first node keeps training
    out = b.update_parameters(_p(2.0), 10)
    np.testing.assert_allclose(as_numpy(out["w"]), 1.0)
    pulls = b.num_pulls
    assert b.update_parameters(_p(3.0), 10) is None  # only own deposit changed
    assert b.num_pulls == pulls and b.num_skipped_pulls >= 1
    a.update_parameters(_p(4.0), 10)
    np.testing.assert_allclose(as_numpy(b.update_parameters(_p(2.0), 10)["w"]), 3.0)


def test_sync_barrier_times_out_without_peers():
    t = [0.0]
    node = SyncFederatedNode(num_nodes=2, shared_folder=InMemoryFolder(), node_id="a",
                             timeout=5.0, poll_interval=0.0, clock=lambda: t.__setitem__(0, t[0] + 1.0) or t[0],
                             device="cpu")
    with pytest.raises(FederationTimeout):
        node.update_parameters(_p(1.0), 1)


def test_resume_restores_counter_and_strategy_state():
    store = api.connect("memory://")
    strat = FedAdam(server_lr=0.1, device="cpu")
    a = AsyncFederatedNode(strategy=strat, store=store, node_id="a",
                           persist_strategy_state=True, device="cpu")
    b = AsyncFederatedNode(store=store, node_id="b", device="cpu")
    a.update_parameters(_p(0.0), 1)
    b.update_parameters(_p(1.0), 1)
    a.update_parameters(_p(0.5), 1)
    restarted = FedAdam(server_lr=0.1, device="cpu")
    again = AsyncFederatedNode(strategy=restarted, store=store, node_id="a",
                               persist_strategy_state=True, device="cpu")
    assert again.counter == 2 and again.resumed is not None
    torch.testing.assert_close(restarted.x, strat.x)
    torch.testing.assert_close(restarted.v, strat.v)


def test_connect_uris():
    shared = api.connect("memory://fleet-a")
    shared.push(jcore.NodeUpdate(_p(1.0), 1, "n"))
    assert api.connect("memory://fleet-a").node_ids() == ["n"]
    assert api.connect("memory://").node_ids() == []
    for uri in ("cache+memory://x", "retry+cache+memory://y"):
        assert api.connect(uri, transport="quantized|npz").transport == "quantized|npz"
    sharded = api.connect("shard4+memory://z", transport="delta")
    assert isinstance(sharded, ShardedWeightStore) and sharded.num_groups == 4
    sharded.push(jcore.NodeUpdate(_p(2.0), 1, "n"))
    assert sharded.node_ids() == ["n"] and sharded.transport == "delta"
    with pytest.raises(ImportError, match="boto3"):  # S3Folder, without boto3 here
        api.connect("s3://bucket/prefix")
    with pytest.raises(ValueError):
        api.connect("memory://", transport="bogus")


def test_timeline_model_matches_reference():
    durations = [[1.0, 1.0, 1.0], [3.0, 2.5, 3.0], [1.5, 1.0, 2.0]]
    for mode in ("sync", "async"):
        t = simulate_timeline(durations, mode=mode, comm_time=0.1)
        j = jcore.simulate_timeline(durations, mode=mode, comm_time=0.1)
        assert (t.wall_clock, t.per_node_finish, t.per_node_idle) == (
            j.wall_clock, j.per_node_finish, j.per_node_idle)
    assert straggler_speedup(durations) == jcore.straggler_speedup(durations)
