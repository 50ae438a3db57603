"""Operations of ResNet-18 (GroupNorm, 3x3 stem) from its convolution and
dense shapes: 2·H_out·W_out·k·k·C_in·C_out a convolution and 2·d_in·d_out the
classifier, per image. Normalisations, activations and pooling are left out,
as a utilisation over the matrix units counts them. A training step is the
forward and twice its operations for the backward (inputs' and weights'
gradients)."""
from __future__ import annotations

STAGES = ((64, 1), (128, 2), (256, 2), (512, 2))


def forward_flops(cfg: dict, hw: int) -> int:
    width, bps = cfg["width"], cfg["blocks_per_stage"]
    flops, size, cin = 0, hw, 64 * width

    def conv(k, c_in, c_out, out):
        return 2 * out * out * k * k * c_in * c_out

    flops += conv(3, cfg["in_channels"], cin, size)
    for base, stride in STAGES:
        cout = base * width
        for b in range(bps):
            st = stride if b == 0 else 1
            out = -(-size // st)
            flops += conv(3, cin, cout, out) + conv(3, cout, cout, out)
            if st != 1 or cin != cout:
                flops += conv(1, cin, cout, out)
            size, cin = out, cout
    return flops + 2 * cin * cfg["num_classes"]


def train_flops_per_sample(cfg: dict, hw: int) -> int:
    return 3 * forward_flops(cfg, hw)
