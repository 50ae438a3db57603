"""The benchmark's operation and byte counts against hand counts."""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.counts import mamba2, peaks, resnet18, roofline
from portbench.reference import resnet18 as ref


def test_fed_agg_bytes_and_flops():
    assert roofline.fed_agg_bytes_flops(2, 3) == ((2 + 1) * 3 * 4, 2 * 2 * 3)
    bound = roofline.fed_agg_bound_s(8, 11_176_970, "NVIDIA H100 80GB HBM3")
    assert abs(bound - 9 * 11_176_970 * 4 / 3.35e12) < 1e-12
    assert roofline.fed_agg_bound_s(8, 10, "a card with no row") is None


def test_ssd_counts_every_visible_pair():
    B, S, H, P, N, chunk = 2, 5, 3, 4, 2, 2
    nbytes, flops = roofline.ssd_bytes_flops(B=B, S=S, H=H, P=P, N=N, chunk=chunk, itemsize=2)
    assert nbytes == (2 * B * S * H * P + 2 * B * S * N) * 2 + B * S * H * 4 + 2 * B * H * P * N * 4
    pairs = sum(1 for c0 in range(0, S, chunk) for i in range(c0, min(S, c0 + chunk))
                for j in range(c0, i + 1))
    assert flops == B * H * (pairs * 2 * (N + P) + 4 * S * P * N)


def test_resnet_flops_equal_the_convolutions_and_the_classifier():
    cfg = {"num_classes": 10, "in_channels": 3, "width": 1, "blocks_per_stage": 1}
    params = {p: torch.zeros(s) for p, s, _, _ in ref.layout(cfg)}
    with FlopCounterMode(display=False) as counter:
        ref.logits(params, cfg, torch.zeros(1, 8, 8, 3))
    assert resnet18.forward_flops(cfg, 8) == counter.get_total_flops()
    assert resnet18.train_flops_per_sample(cfg, 8) == 3 * counter.get_total_flops()


def test_resnet18_at_cifar_size():
    cfg = {"num_classes": 10, "in_channels": 3, "width": 1, "blocks_per_stage": 2}
    # 0.556 GMACs a 32x32 image, the published count of CIFAR ResNet-18
    assert abs(resnet18.forward_flops(cfg, 32) / 2 - 0.5566e9) < 0.01e9


def test_mamba2_token_flops_by_hand():
    cfg = {"d_model": 8, "ssm_expand": 2, "ssm_head_dim": 4, "ssm_state": 3, "ssm_conv": 4,
           "ssm_chunk": 2, "vocab_size": 10, "vocab_pad_to": 8, "n_layers": 2}
    d_inner, H, N, P, V = 16, 4, 3, 4, 16
    per_token_layer = 2 * 8 * (2 * d_inner + 2 * N + H) + 2 * d_inner * 8 + 2 * 4 * (d_inner + 2 * N)
    assert mamba2.decode_flops(cfg, 1) == 2 * (per_token_layer + 4 * H * P * N) + 2 * 8 * V
    scan = roofline.ssd_bytes_flops(B=1, S=3, H=H, P=P, N=N, chunk=2, itemsize=2)[1]
    assert mamba2.prefill_flops(cfg, 1, 3) == 2 * (3 * per_token_layer + scan) + 2 * 8 * V


def test_peaks_by_card_name():
    assert peaks.rate(peaks.BF16_FLOPS, "NVIDIA H100 80GB HBM3") == 989e12
    assert peaks.rate(peaks.F32_FLOPS, "NVIDIA H100 PCIe") == 51e12
    assert peaks.rate(peaks.BANDWIDTH, "NVIDIA H100 NVL") == 3.9e12
