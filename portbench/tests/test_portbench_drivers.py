"""Each driver end to end on the CPU at a small size: the check passes on
the program as it is, and fails with each fault the cell can have planted
under the timed path, and for the control where it runs on the CPU."""
from __future__ import annotations

import pytest

from portbench import faults, harness
from portbench.drivers import federated_training, serving

SEED = 2**31 + 11


def _judged(out: dict) -> bool:
    return harness.judge(out["readings"], out["limits"])[0] and out["failed"] == 0


def test_training_run_is_correct(tiny_resnet):
    cfg, mix = tiny_resnet
    out = federated_training.run(cfg, mix, seed=SEED, seconds=0.5, trace=False, device="cpu")
    assert _judged(out), out["readings"]
    assert out["metrics"]["train_samples_per_s"] > 0 and out["attempted"] >= 2
    assert out["records"]["fed_agg_calls"]


@pytest.mark.parametrize("fault, record_round", [
    ("frozen_step", 0), ("half_batch", 0), ("altered", 0),
    # the first round of a stale push pushes its own parameters: judge the next
    ("stale_push", 1)])
def test_training_faults_fail_the_check(tiny_resnet, fault, record_round):
    cfg, mix = tiny_resnet
    out = federated_training.run(cfg, mix, seed=SEED, seconds=0.2, trace=False, device="cpu",
                                 patch=faults.FAULTS[fault], record_round=record_round)
    assert not _judged(out), out["readings"]


def test_serving_run_is_correct(tiny_mamba2):
    cfg, mix = tiny_mamba2
    out = serving.run(cfg, mix, seed=SEED, seconds=1.5, trace=False, device="cpu")
    assert _judged(out), out["readings"]
    assert out["metrics"]["serve_tokens_per_s"] > 0
    assert out["readings"]["first_swap_s"] > 0  # the window saw publishes, and swapped them in


@pytest.mark.parametrize("fault, seconds", [
    ("altered", 0.8), ("frozen_state", 0.8), ("half_batch", 0.8),
    # every batch is right for the set it names; only the swap lag shows the fault
    ("blocked_watcher", 1.5)])
def test_serving_faults_fail_the_check(tiny_mamba2, fault, seconds):
    cfg, mix = tiny_mamba2
    out = serving.run(cfg, mix, seed=SEED, seconds=seconds, trace=False, device="cpu",
                      patch=faults.FAULTS[fault])
    assert not _judged(out), out["readings"]


def test_serving_control_fails_the_check(tiny_mamba2):
    cfg, mix = tiny_mamba2
    out = serving.run(cfg, mix, seed=SEED, seconds=0.8, trace=False, device="cpu", control=True)
    assert out["readings"]["control_gap"] > mix["limits"]["token_gap"], out["readings"]


@pytest.mark.cuda
def test_training_control_fails_the_check(tiny_resnet):
    """The control of a float32 cell is the reference in TF32, which exists
    on the card alone: put in the program's place, it fails the check."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on a CUDA card")
    cfg, mix = tiny_resnet
    out = federated_training.run(cfg, mix, seed=SEED, seconds=0.2, trace=False, device="cuda",
                                 control=True, record_round=0)
    assert not _judged(out), out["readings"]
