"""Processes, checkpoints, S3Folder and the quickstart twin: the port against
the reference.

The process harness (``run_multiprocess``, ``ProcessSupervisor``: results and
errors, SIGKILL injection, restart with resume, kill timers), checkpoints
that load bit for bit in the other package, ``S3Folder``'s import guard, a
mixed JAX/torch ``SyncFederatedNode`` fleet of real processes held to an
all-JAX run, and the torch quickstart held to the JAX quickstart's accuracy.

Children start under ``spawn`` and import ``tests/_torch_children.py``; each
wait has its own timeout.
"""
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.checkpoint as jckpt
import repro.core as jcore
from repro.core.strategies import FedAvg as JFedAvg
from repro.data import batch_iterator as j_batches
from repro.data import make_synthetic_mnist as j_mnist
from repro.models.cnn import MnistCNN as JMnistCNN
from repro.optim import adam as j_adam
from repro.training import Trainer as JTrainer
import repro_torch.checkpoint as tckpt
from repro_torch.core import (
    DiskFolder,
    ProcessCrashed,
    ProcessSupervisor,
    WeightStore,
    run_multiprocess,
)
from repro_torch.core import simulation as tsim
from repro_torch.core.store import S3Folder, make_folder
from repro_torch.core.tree import as_numpy, tree_leaves
from repro_torch.examples import quickstart

import _torch_children as kids

SRC = Path(__file__).resolve().parents[1] / "src"


def _no_timer_threads():
    return not any(isinstance(t, threading.Timer) and t.is_alive()
                   for t in threading.enumerate())


# --- the process harness -------------------------------------------------------


def test_run_multiprocess_collects_results_errors_and_cancels_unfired_kills():
    """Results and errors come back; a client that finishes before its
    scheduled kill leaves no timer thread behind."""
    before = set(threading.enumerate())
    res = run_multiprocess([(kids.returns_value, (21,)), kids.raises], names=["ok", "bad"],
                           kill_after={0: 300.0}, join_timeout=120.0)
    assert res[0].error is None and res[0].result == 42 and res[0].exitcode == 0
    assert isinstance(res[1].error, ProcessCrashed)
    assert "injected failure" in res[1].traceback
    leaked = [t for t in threading.enumerate() if t not in before and t.is_alive()]
    assert not leaked, f"threads survived run_multiprocess: {leaked}"


def test_run_multiprocess_sigkill_injection():
    t0 = time.monotonic()
    res = run_multiprocess([kids.hangs_forever], kill_after={0: 0.5}, join_timeout=120.0)
    assert isinstance(res[0].error, ProcessCrashed)
    assert res[0].exitcode == -signal.SIGKILL
    assert time.monotonic() - t0 < 100.0  # did not wait out the join timeout


def test_supervisor_restart_resumes_client(tmp_path):
    """Spawn, SIGKILL on the parked client's first deposit, respawn under the
    same name: the second incarnation resumes its counter and weights from
    the first one's deposits, and the first one's result stays as history."""
    sup = ProcessSupervisor()
    try:
        sup.spawn("phoenix", kids.resumable_client, (str(tmp_path), "phoenix", 50),
                  {"die_after_pushes": 2})
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:  # wait for the park, then kill
            pulled = WeightStore(DiskFolder(str(tmp_path))).pull_node("phoenix")
            if pulled is not None and pulled.counter >= 1:
                break
            time.sleep(0.05)
        sup.kill("phoenix")
        sup.join(60.0)
        assert sup.result("phoenix").exitcode == -signal.SIGKILL
        assert isinstance(sup.result("phoenix").error, ProcessCrashed)

        sup.spawn("phoenix", kids.resumable_client, (str(tmp_path), "phoenix", 2))
        assert sup.incarnation("phoenix") == 1
        sup.join(120.0)
        reborn = sup.result("phoenix")
        assert reborn.error is None, reborn.traceback
        r = reborn.result
        assert r["start_counter"] == 2 and r["resumed_from"] == 2.0
        assert r["final_counter"] == 4 and r["w0"] == 4.0  # progress continued
        assert isinstance(sup.history("phoenix")[0].error, ProcessCrashed)
    finally:
        sup.shutdown()


def test_supervisor_cancel_scheduled_kills_lets_client_finish():
    sup = ProcessSupervisor()
    try:
        sup.spawn("survivor", kids.sleeps_then_returns, (1.0, 7))
        sup.schedule_kill("survivor", 0.4)  # would land mid-sleep (or mid-import)
        sup.cancel_scheduled_kills("survivor")
        sup.join(120.0)
        res = sup.result("survivor")
        assert res.error is None, res.traceback
        assert res.result == 7 and res.exitcode == 0
    finally:
        sup.shutdown()
    assert _no_timer_threads()


def test_run_multiprocess_rejects_bad_arguments():
    with pytest.raises(ValueError):
        run_multiprocess([kids.returns_value], kill_after={5: 1.0})
    with pytest.raises(ValueError):
        run_multiprocess([kids.returns_value, kids.returns_value], names=["only-one"])
    with pytest.raises(ValueError):
        run_multiprocess([kids.returns_value, kids.returns_value], names=["a", "a"])


def test_fork_after_cuda_init_raises(monkeypatch):
    """A forked child of a process with a CUDA context cannot use the card:
    the supervisor refuses rather than hand out children that hang."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="fork"):
        ProcessSupervisor(start_method="fork")
    with pytest.raises(RuntimeError, match="fork"):
        run_multiprocess([kids.returns_value], start_method="fork")
    assert tsim._start_context("spawn").get_start_method() == "spawn"


def test_mixed_sync_process_fleet_matches_all_jax(tmp_path):
    """One JAX and one torch ``SyncFederatedNode``, each in its own process
    on one ``DiskFolder``: the final weights match two JAX nodes run in
    threads within 1e-6."""
    rounds, targets = 4, {"a": 0.0, "b": 3.0}
    res = run_multiprocess(
        [(kids.sync_client, ("jax", str(tmp_path), "a", targets["a"], 2, rounds)),
         (kids.sync_client, ("torch", str(tmp_path), "b", targets["b"], 2, rounds))],
        names=["a", "b"], join_timeout=240.0)
    for r in res:
        assert r.error is None, r.traceback
    folder = jcore.DiskFolder(str(tmp_path / "jax"))
    ref = jcore.run_threaded([
        lambda n=n: kids.sync_rounds(jcore.SyncFederatedNode(
            num_nodes=2, timeout=120.0, strategy=JFedAvg(), shared_folder=folder, node_id=n),
            targets[n], rounds) for n in ("a", "b")])
    for r, want in zip(res, ref):
        assert want.error is None, want.traceback
        np.testing.assert_allclose(r.result, want.result, rtol=1e-6, atol=1e-6)
    assert abs(res[0].result[0] - res[1].result[0]) < 1e-6  # one consensus


# --- checkpoints ----------------------------------------------------------------


def _ckpt_tree(rng):
    return {"conv": {"w": rng.normal(size=(3, 3, 2, 4)).astype(np.float32),
                     "b": rng.normal(size=(4,)).astype(np.float32)},
            "count": np.arange(5, dtype=np.int32),
            "fc": {"w": rng.normal(size=(7, 3)).astype(np.float32)}}


def _assert_bits(a, b):
    la, lb = tree_leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = as_numpy(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def test_checkpoints_load_bit_exact_across_packages(tmp_path):
    rng = np.random.default_rng(0)
    tree = _ckpt_tree(rng)
    ttree = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()} if isinstance(v, dict)
                 else torch.from_numpy(v)) for k, v in tree.items()}
    tckpt.save_checkpoint(str(tmp_path / "t"), 7, ttree, extra={"who": "torch"})
    jckpt.save_checkpoint(str(tmp_path / "j"), 7, tree, extra={"who": "jax"})
    # each package reads the other's file, and the files are the same bytes
    jt, jmeta = jckpt.load_checkpoint(str(tmp_path / "t"))
    tj, tmeta = tckpt.load_checkpoint(str(tmp_path / "j"))
    assert jmeta == {"step": 7, "who": "torch"} and tmeta == {"step": 7, "who": "jax"}
    _assert_bits(ttree, jt)
    _assert_bits(tj, tree)
    assert all(isinstance(leaf, torch.Tensor) and leaf.device.type == "cpu"
               for leaf in tree_leaves(tj))
    # one tree and one meta make one file, byte for byte
    tckpt.save_checkpoint(str(tmp_path / "t2"), 7, ttree, extra={"who": "jax"})
    assert ((tmp_path / "t2" / "step_00000007.npz").read_bytes()
            == (tmp_path / "j" / "step_00000007.npz").read_bytes())


def test_bf16_checkpoint_crosses_packages(tmp_path):
    import ml_dtypes

    rng = np.random.default_rng(1)
    w = rng.normal(size=(16, 8)).astype(np.float32)
    tckpt.save_checkpoint(str(tmp_path), 1, {"w": torch.from_numpy(w).to(torch.bfloat16)})
    jt, _ = jckpt.load_checkpoint(str(tmp_path))
    assert jt["w"].dtype == ml_dtypes.bfloat16
    back, _ = tckpt.load_checkpoint(str(tmp_path), device="cpu")
    assert back["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(back["w"].float().numpy(), jt["w"].astype(np.float32))
    np.testing.assert_array_equal(back["w"].float().numpy(),
                                  torch.from_numpy(w).to(torch.bfloat16).float().numpy())


def test_checkpoint_keep_latest_and_missing(tmp_path):
    d = str(tmp_path / "ck")
    assert tckpt.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        tckpt.load_checkpoint(d)
    for step in (3, 10, 4, 12):
        tckpt.save_checkpoint(d, step, {"w": torch.full((3,), float(step))}, keep=2)
    assert sorted(os.listdir(d)) == ["step_00000010.npz", "step_00000012.npz"]
    assert tckpt.latest_step(d) == jckpt.latest_step(d) == 12
    params, meta = tckpt.load_checkpoint(d, 10)
    assert meta["step"] == 10 and params["w"].tolist() == [10.0] * 3
    # the newest checkpoint is a store deposit's bytes: a node can bootstrap from it
    jparams, _ = jckpt.load_checkpoint(d)
    np.testing.assert_array_equal(np.asarray(jparams["w"]), [12.0] * 3)


# --- S3Folder --------------------------------------------------------------------


def test_s3_folder_raises_import_error_without_boto3():
    """The store module imports without boto3; an S3 folder raises at
    construction (here and through ``make_folder``), as the reference does."""
    code = ("import sys; sys.modules['boto3'] = None\n"
            "import repro_torch.core.store as s\n"
            "for make in (lambda: s.S3Folder('bucket/prefix'),\n"
            "             lambda: s.make_folder('s3://bucket/prefix')):\n"
            "    try:\n"
            "        make()\n"
            "    except ImportError as e:\n"
            "        assert 'boto3' in str(e), e\n"
            "    else:\n"
            "        raise AssertionError('no ImportError')\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], env={**os.environ, "PYTHONPATH": str(SRC)},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    with pytest.raises(ImportError, match="boto3"):
        S3Folder("bucket/prefix")
    with pytest.raises(ImportError, match="boto3"):
        make_folder("cache+s3://bucket/prefix")


# --- the quickstart twin ---------------------------------------------------------

QS = dict(epochs=4, steps=20, batch=32, num_train=1500, num_test=300)


def _jax_quickstart(shared_dir, *, epochs, steps, batch, num_train, num_test):
    """``examples/quickstart.py``'s two clients, at the given cut."""
    data = j_mnist(num_train=num_train, num_test=num_test)
    shards = jcore.partition_dataset(data.x_train, data.y_train, num_nodes=2, skew=0.9)

    def client(i):
        model = JMnistCNN()
        trainer = JTrainer(loss_fn=lambda p, b, r: model.loss(p, b), optimizer=j_adam(1e-3),
                           init_params=model.init(jax.random.PRNGKey(0)), seed=i,
                           name=f"client{i}")
        node = jcore.AsyncFederatedNode(strategy=JFedAvg(),
                                        shared_folder=jcore.DiskFolder(shared_dir),
                                        node_id=f"client{i}")
        x, y = shards[i]
        trainer.fit(lambda e: j_batches(x, y, batch_size=batch, seed=i, epoch=e), epochs=epochs,
                    steps_per_epoch=steps,
                    callbacks=[jcore.FederatedCallback(node, num_examples_per_epoch=steps * batch)])
        logits = model.apply(trainer.params, data.x_test)
        return float((np.argmax(np.asarray(logits), -1) == data.y_test).mean())

    res = jcore.run_threaded([lambda: client(0), lambda: client(1)])
    for r in res:
        assert r.error is None, r.traceback
    return [r.result for r in res]


def test_quickstart_twin_accuracy_within_band_of_jax(tmp_path, capsys):
    """Same data seed, same cut (4 of the quickstart's 5 epochs, 1,500 of its
    2,000 examples): the two clients' mean test accuracy of the torch twin is
    within 0.2 of the JAX quickstart's, and both learn (> 0.4; chance is 0.1).
    The band is wide because the runs are not step-for-step alike: the
    packages draw their inits from different generators, and which peer
    deposit an async client sees at each epoch end depends on thread timing
    (three JAX runs of this cut gave means 0.56–0.74, torch 0.64–0.67)."""
    torch_acc = quickstart.run(str(tmp_path / "t"), device="cpu", **QS)
    jax_acc = _jax_quickstart(str(tmp_path / "j"), **QS)
    assert "client0: test accuracy" in capsys.readouterr().out
    t, j = float(np.mean(torch_acc)), float(np.mean(jax_acc))
    assert t > 0.4 and j > 0.4, (torch_acc, jax_acc)
    assert abs(t - j) <= 0.2, (torch_acc, jax_acc)
