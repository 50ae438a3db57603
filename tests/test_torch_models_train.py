"""Models, optimizers, trainer and data of the port against the reference.

Both packages start from the same parameters — the reference's init, carried
across with ``load_jax_params`` — and see the same numpy batches.
Tolerances: MnistCNN logits 1e-5; ResNet logits 1e-4 (GroupNorm's variance
accumulates in another order); parameters after three Adam steps 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.core.partition import partition_dataset as j_partition
from repro.data import batch_iterator as j_batches
from repro.data import make_synthetic_cifar as j_cifar
from repro.data import make_synthetic_mnist as j_mnist
from repro.models import cnn as jcnn
from repro.training import Trainer as JTrainer
from repro_torch import optim as toptim
from repro_torch.core.partition import partition_dataset
from repro_torch.core.tree import tree_leaves
from repro_torch.data import batch_iterator, make_synthetic_cifar, make_synthetic_mnist
from repro_torch.models import cnn as tcnn
from repro_torch.models.cnn import MnistCNN, ResNet, load_jax_params
from repro_torch.training import Trainer

from _torch_parity import np_params


def _assert_trees_close(port, ref, rtol, atol):
    for a, b in zip(tree_leaves(port), jax.tree.leaves(ref)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=rtol, atol=atol)


def test_mnist_cnn_logits_match_reference():
    params = np_params(jcnn.MnistCNN(), 0)
    x = np.random.default_rng(0).normal(size=(5, 28, 28, 1)).astype(np.float32)
    want = np.asarray(jax.jit(jcnn.MnistCNN().apply)(params, x))
    got = MnistCNN().apply(load_jax_params(MnistCNN(), params, device="cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)


def test_resnet_logits_match_reference():
    jm, tm = jcnn.ResNet(blocks_per_stage=1), ResNet(blocks_per_stage=1)
    params = np_params(jm, 1)
    x = np.random.default_rng(1).normal(size=(2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(params, x))
    got = tm.apply(load_jax_params(tm, params, device="cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("hw,k,stride", [(32, 3, 2), (16, 3, 2), (7, 3, 2), (32, 1, 2),
                                         (9, 3, 1), (8, 3, 3)])
def test_same_padding_matches_jax_including_stride_2(hw, k, stride):
    """JAX's SAME pads stride-2 convolutions on even inputs 0 before / 1
    after; a symmetric padding=1 would shift every output pixel."""
    rng = np.random.default_rng(hw * 10 + k)
    x = rng.normal(size=(2, hw, hw, 4)).astype(np.float32)
    p = {"w": rng.normal(size=(k, k, 4, 5)).astype(np.float32),
         "b": rng.normal(size=(5,)).astype(np.float32)}
    want = np.asarray(jcnn._conv(p, jnp.asarray(x), stride))
    got = tcnn._conv({n: torch.from_numpy(a) for n, a in p.items()},
                     torch.from_numpy(x).permute(0, 3, 1, 2), stride).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if (hw, k, stride) == (32, 3, 2):
        assert tcnn._same_pads(32, 3, 2) == (0, 1)


def test_groupnorm_matches_reference():
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(2, 4, 4, 16)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.normal(size=(16,)).astype(np.float32),
         "bias": rng.normal(size=(16,)).astype(np.float32)}
    want = np.asarray(jcnn._groupnorm(p, jnp.asarray(x)))
    got = tcnn._groupnorm({n: torch.from_numpy(a) for n, a in p.items()},
                          torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_load_jax_params_rejects_other_layouts():
    params = np_params(jcnn.MnistCNN(), 0)
    bad = jax.tree.map(lambda a: a, params)
    bad["conv1"]["w"] = np.transpose(bad["conv1"]["w"], (3, 2, 0, 1))  # OIHW
    with pytest.raises(ValueError, match="layout mismatch"):
        load_jax_params(MnistCNN(), bad, device="cpu")
    del bad["fc2"]
    with pytest.raises(ValueError, match="layout mismatch"):
        load_jax_params(MnistCNN(), bad, device="cpu")


def test_loss_and_metrics_match_reference():
    params = np_params(jcnn.MnistCNN(), 4)
    rng = np.random.default_rng(4)
    batch = {"x": rng.normal(size=(8, 28, 28, 1)).astype(np.float32),
             "y": rng.integers(0, 10, size=8).astype(np.int32)}
    want_loss, want_m = jcnn.MnistCNN().loss(params, batch)
    tparams = load_jax_params(MnistCNN(), params, device="cpu")
    loss, m = MnistCNN().loss(tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert float(m["accuracy"]) == float(want_m["accuracy"])


# eps=1e-6, not Adam's default 1e-8: with 1e-8, a gradient entry within f32
# rounding noise of zero (|g| ~ 1e-8, summed in another order by each
# package) is normalized to a step of up to lr either way, so one fc1 entry
# of 401,408 drifts 1.3e-4 apart in three steps (ROADMAP Queue 3). eps=1e-6
# keeps such entries' steps proportional to g, and the comparison meaningful.
@pytest.mark.parametrize("make_j,make_t", [
    (lambda: joptim.adam(1e-3, eps=1e-6), lambda: toptim.adam(1e-3, eps=1e-6)),
    (lambda: joptim.adamw(1e-3, eps=1e-6, weight_decay=0.1),
     lambda: toptim.adamw(1e-3, eps=1e-6, weight_decay=0.1)),
    (lambda: joptim.sgd(0.05, momentum=0.9, nesterov=True),
     lambda: toptim.sgd(0.05, momentum=0.9, nesterov=True)),
])
def test_trainer_steps_match_reference(make_j, make_t):
    """Three optimizer steps of the port's Trainer on the same batches land
    within 1e-4 of the reference's."""
    jm = jcnn.MnistCNN()
    params = np_params(jm, 5)
    data = j_mnist(num_train=96, num_test=8, seed=5)
    jt = JTrainer(loss_fn=lambda p, b, r: jm.loss(p, b), optimizer=make_j(), init_params=params)
    tt = Trainer(loss_fn=lambda p, b, r: MnistCNN().loss(p, b), optimizer=make_t(),
                 init_params=load_jax_params(MnistCNN(), params, device="cpu"), device="cpu")
    jlog = jt.run_epoch(j_batches(data.x_train, data.y_train, batch_size=32), steps=3)
    tlog = tt.run_epoch(batch_iterator(data.x_train, data.y_train, batch_size=32), steps=3)
    assert tt.step == jt.step == 3
    _assert_trees_close(tt.params, jt.params, rtol=1e-4, atol=1e-4)
    assert set(tlog) == set(jlog)
    np.testing.assert_allclose(tlog["loss"], jlog["loss"], rtol=1e-4)


def test_schedules_match_reference():
    pairs = [
        (joptim.linear_schedule(0.1, 10, 0.2), toptim.linear_schedule(0.1, 10, 0.2)),
        (joptim.warmup_cosine_schedule(0.3, 3, 12), toptim.warmup_cosine_schedule(0.3, 3, 12)),
        (joptim.constant_schedule(0.01), toptim.constant_schedule(0.01)),
    ]
    for j, t in pairs:
        for step in range(15):
            np.testing.assert_allclose(t(step), float(j(jnp.asarray(step))), rtol=1e-6)


def test_set_params_copies_into_own_tensors_keeping_dtype():
    init = {"w": np.zeros((3,), np.float32), "n": np.zeros((2,), np.int64)}
    tt = Trainer(loss_fn=lambda p, b, r: (p["w"].sum(), {}), optimizer=toptim.sgd(0.1),
                 init_params=init, device="cpu")
    w_before = tt.params["w"]
    src = {"w": torch.arange(3, dtype=torch.float32), "n": np.array([2**40, 7], np.int64)}
    tt.set_params(src)
    assert tt.params["w"] is w_before and tt.params["w"].data_ptr() != src["w"].data_ptr()
    assert tt.params["n"].dtype == torch.int64 and int(tt.params["n"][0]) == 2**40
    src["w"] += 1.0  # the source is not adopted
    np.testing.assert_array_equal(tt.params["w"].numpy(), [0.0, 1.0, 2.0])
    with pytest.raises(ValueError):
        tt.set_params({"w": torch.zeros(3)})


def test_data_pipeline_is_identical_to_reference():
    for tmake, jmake in ((make_synthetic_mnist, j_mnist), (make_synthetic_cifar, j_cifar)):
        t, j = tmake(num_train=40, num_test=8, seed=3), jmake(num_train=40, num_test=8, seed=3)
        for name in ("x_train", "y_train", "x_test", "y_test"):
            np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    d = j_mnist(num_train=64, num_test=8)
    for (tx, ty), (jx, jy) in zip(partition_dataset(d.x_train, d.y_train, 3, 0.7, seed=1),
                                  j_partition(d.x_train, d.y_train, 3, 0.7, seed=1)):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    for tb, jb in zip(batch_iterator(d.x_train, d.y_train, batch_size=16, seed=2, epoch=1),
                      j_batches(d.x_train, d.y_train, batch_size=16, seed=2, epoch=1)):
        np.testing.assert_array_equal(tb["x"], jb["x"])
        np.testing.assert_array_equal(tb["y"], jb["y"])
