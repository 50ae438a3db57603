"""Small configurations of the benchmark's cells, for the CPU."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

SRC = str(Path(__file__).resolve().parents[2] / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)


@pytest.fixture
def tiny_resnet():
    cfg = {"num_classes": 10, "in_channels": 3, "width": 1, "blocks_per_stage": 1,
           "image_hw": 8, "dtype": "float32", "tf32": False, "lr": 1e-3, "batch": 8,
           "driver": "federated_training"}
    mix = {"clients": 3, "shard_images": 40, "steps_per_epoch": 2, "peer_sets": 2,
           "peer_spread": 0.01, "peer_period_s": 0.05, "profile_from_round": 2,
           "profile_rounds": 1,
           "limits": {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3,
                      "deposit_gap": 0.0, "aggregate_gap": 1e-5}}
    return cfg, mix


@pytest.fixture
def tiny_mamba2(monkeypatch):
    """mamba2-130m cut as the program's ``reduced()`` cuts it, in f32."""
    from repro_torch.configs import get_config

    from portbench.drivers import serving

    program = get_config("mamba2-130m").reduced()
    monkeypatch.setattr(serving, "program_config", lambda cfg: program)
    sizes = {"n_layers": program.n_layers, "d_model": program.d_model,
             "ssm_state": program.ssm_state, "ssm_conv": program.ssm_conv,
             "ssm_expand": program.ssm_expand, "ssm_head_dim": program.ssm_head_dim,
             "ssm_chunk": program.ssm_chunk, "vocab_size": program.vocab_size,
             "vocab_pad_to": program.vocab_pad_to, "tie_embeddings": True,
             "norm_eps": program.norm_eps, "dtype": "float32"}
    cfg = {"arch": "mamba2-130m", "sizes": sizes, "driver": "serving"}
    mix = {"batch": 2, "prompt_tokens": [8, 40], "new_tokens": [3, 6], "sizes": 3,
           "weight_sets": 3, "publish_every_s": 0.3, "poll_interval_s": 0.05,
           "profile_from_s": 0.5, "profile_s": 0.5, "check_batches": 2,
           "limits": {"token_gap": 1e-3, "first_swap_s": 0.8}}
    return cfg, mix
