"""The plain reference against the program on the CPU, at toy sizes: the
test may import both; the reference imports nothing of the program."""
from __future__ import annotations

import numpy as np
import torch

from portbench import harness
from portbench.drivers import federated_training
from portbench.reference import mamba2 as ref_mamba2
from portbench.reference import resnet18 as ref_resnet
from portbench.reference import wire

TINY = {"num_classes": 10, "in_channels": 3, "width": 1, "blocks_per_stage": 1}


def test_resnet_reference_equals_the_program():
    from repro_torch.models.cnn import ResNet
    from repro_torch.optim import adam
    from repro_torch.training import Trainer

    init = federated_training.initial_weights(TINY, 3, "cpu")
    model = ResNet(10, 3, 1, 1)
    images = torch.randn(4, 8, 8, 3, generator=torch.Generator().manual_seed(0))
    labels = torch.tensor([1, 2, 3, 4])
    got = model.apply(harness.nested(init), images)
    want = ref_resnet.logits(init, TINY, images)
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)
    trainer = Trainer(loss_fn=lambda p, b, r: model.loss(p, b), optimizer=adam(1e-3),
                      init_params=harness.nested(init), device="cpu")
    batches = [{"x": images.numpy(), "y": labels.numpy()}] * 2
    losses = [trainer.run_epoch([b])["loss"] for b in batches]
    want_losses, _, change = ref_resnet.train_steps(init, TINY, [(images, labels)] * 2, 1e-3)
    assert np.allclose(losses, want_losses, rtol=1e-5)
    got_change = {p: t - init[p] for p, t in harness.flat_paths(trainer.params).items()}
    assert harness.worst_leaf_gap(got_change, change)[0] < 1e-4


def test_mamba2_reference_equals_the_program():
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    program = get_config("mamba2-130m").reduced()
    cfg = {k: getattr(program, k) for k in ("n_layers", "d_model", "ssm_state", "ssm_conv",
                                            "ssm_expand", "ssm_head_dim", "ssm_chunk",
                                            "vocab_size", "vocab_pad_to", "norm_eps",
                                            "dtype")}
    weights = ref_mamba2.make_weights(cfg, 5, "cpu")
    layout = {p: (tuple(t.shape), str(t.dtype).split(".")[-1])
              for p, t in harness.flat_paths(build_model(program).abstract()).items()}
    assert layout == {p: (s, d) for p, s, d in ref_mamba2.layout(cfg)}
    tokens = torch.randint(0, cfg["vocab_size"], (2, 70), generator=torch.Generator().manual_seed(1))
    got, _ = build_model(program).apply(harness.nested(weights), tokens)
    want = ref_mamba2.forward(weights, cfg, tokens)
    assert torch.allclose(got, want, atol=2e-4 * want.abs().max(), rtol=0)
    last = ref_mamba2.forward(weights, cfg, tokens, keep=slice(60, 62))
    assert torch.allclose(last, want[:, 60:62], atol=1e-6 * want.abs().max(), rtol=0)
    served = want[:, 63:69, : cfg["vocab_size"]].argmax(-1)
    gaps = ref_mamba2.served_gaps(weights, cfg, tokens[:, :64], torch.cat(
        [want[:, 63:64, : cfg["vocab_size"]].argmax(-1), tokens[:, 64:69]], dim=1))
    assert gaps.shape == (2, 6) and float(gaps[:, 0].abs().max()) == 0.0
    del served


def test_the_wire_both_ways():
    from repro_torch.core.serialize import NodeUpdate, deserialize_update, serialize_update

    leaves = {"a/b": np.arange(6, dtype=np.float32).reshape(2, 3), "c": np.ones(4, np.float32)}
    blob = wire.write_update(leaves, node_id="n", counter=3, num_examples=7)
    update = deserialize_update(blob)
    assert update.node_id == "n" and update.counter == 3 and update.num_examples == 7
    assert np.array_equal(update.params["a"]["b"], leaves["a/b"])
    back, meta = wire.read_update(serialize_update(NodeUpdate(
        params=harness.nested(leaves), num_examples=2, node_id="m", counter=1)))
    assert meta["node_id"] == "m" and all(np.array_equal(back[p], leaves[p]) for p in leaves)
