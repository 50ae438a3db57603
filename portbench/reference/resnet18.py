"""ResNet-18 for CIFAR (He et al. 2015, arXiv:1512.03385) with GroupNorm
(Wu & He 2018) and a 3x3 stem, as the paper's section 4.3 trains it, with
its loss and Adam (Kingma & Ba 2014) in plain PyTorch.

Layout: conv weights HWIO over NHWC images, dense weights (d_in, d_out).
Convolutions pad as XLA's "SAME" does: the output is ceil(in / stride) and an
odd total padding puts the extra row and column after. GroupNorm takes
min(8, C) groups, eps 1e-5. Adam's step is -lr * (m / bc1) / (sqrt(v / bc2) +
eps) with the bias corrections 1 - beta**t rounded to float32.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

STAGES = ((64, 1), (128, 2), (256, 2), (512, 2))


def layout(cfg: dict) -> list[tuple[str, tuple, str, float]]:
    """(path, shape, init kind, scale) of every leaf, in sorted path order.
    Kinds: ``normal`` (std ``scale``) and ``const`` (value ``scale``)."""
    width, bps = cfg["width"], cfg["blocks_per_stage"]
    leaves = []

    def conv(name, k, cin, cout):
        leaves.append((f"{name}/w", (k, k, cin, cout), "normal", math.sqrt(2.0 / (k * k * cin))))
        leaves.append((f"{name}/b", (cout,), "const", 0.0))

    def norm(name, c):
        leaves.append((f"{name}/scale", (c,), "const", 1.0))
        leaves.append((f"{name}/bias", (c,), "const", 0.0))

    cin = 64 * width
    conv("stem", 3, cfg["in_channels"], cin)
    norm("gn0", cin)
    for s, (base, stride) in enumerate(STAGES):
        cout = base * width
        for b in range(bps):
            st = stride if b == 0 else 1
            conv(f"s{s}b{b}/conv1", 3, cin, cout)
            norm(f"s{s}b{b}/gn1", cout)
            conv(f"s{s}b{b}/conv2", 3, cout, cout)
            norm(f"s{s}b{b}/gn2", cout)
            if st != 1 or cin != cout:
                conv(f"s{s}b{b}/proj", 1, cin, cout)
            cin = cout
    leaves.append(("fc/w", (cin, cfg["num_classes"]), "normal", math.sqrt(1.0 / cin)))
    leaves.append(("fc/b", (cfg["num_classes"],), "const", 0.0))
    return sorted(leaves)


def _same(size: int, k: int, stride: int) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(p: dict, name: str, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    w = p[f"{name}/w"]
    k = w.shape[0]
    top, bottom = _same(x.shape[2], k, stride)
    left, right = _same(x.shape[3], k, stride)
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w.permute(3, 2, 0, 1).contiguous(), p[f"{name}/b"], stride=stride)


def _gn(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.group_norm(x, min(8, x.shape[1]), p[f"{name}/scale"], p[f"{name}/bias"], eps=1e-5)


def logits(p: dict, cfg: dict, images: torch.Tensor) -> torch.Tensor:
    """images (B, H, W, C) -> logits (B, classes)."""
    x = images.permute(0, 3, 1, 2).contiguous()
    x = F.relu(_gn(p, "gn0", _conv(p, "stem", x)))
    for s, (_, stride) in enumerate(STAGES):
        for b in range(cfg["blocks_per_stage"]):
            st = stride if b == 0 else 1
            name = f"s{s}b{b}"
            h = F.relu(_gn(p, f"{name}/gn1", _conv(p, f"{name}/conv1", x, st)))
            h = _gn(p, f"{name}/gn2", _conv(p, f"{name}/conv2", h))
            short = _conv(p, f"{name}/proj", x, st) if f"{name}/proj/w" in p else x
            x = F.relu(h + short)
    return x.mean(dim=(2, 3)) @ p["fc/w"] + p["fc/b"]


def loss(p: dict, cfg: dict, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy."""
    return F.cross_entropy(logits(p, cfg, images), labels.long())


class Adam:
    """Adam over a dict of f32 tensors, moments kept in f32."""

    def __init__(self, params: dict, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(self.t))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(self.t))
        for k, g in grads.items():
            self.m[k].mul_(self.b1).add_((1 - self.b1) * g)
            self.v[k].mul_(self.b2).add_((1 - self.b2) * g * g)
            params[k].add_(-(self.lr * (self.m[k] / bc1) / (torch.sqrt(self.v[k] / bc2)
                                                              + self.eps)))


def train_steps(init: dict, cfg: dict, batches: list, lr: float, *, half_batch: bool = False
                ) -> tuple[list[float], dict, dict]:
    """Adam from ``init`` over ``batches`` ((images, labels) on the device):
    -> (each step's loss, the first step's gradient, the parameters' change
    after the last step). ``half_batch`` takes each step's loss over the
    first half of its rows only (a fault the checks must catch)."""
    params = {k: v.detach().clone().float() for k, v in init.items()}
    opt = Adam(params, lr)
    losses, first_grad = [], None
    for images, labels in batches:
        if half_batch:
            images, labels = images[: len(images) // 2], labels[: len(labels) // 2]
        for v in params.values():
            v.requires_grad_(True)
        value = loss(params, cfg, images, labels)
        names = list(params)
        grads = dict(zip(names, torch.autograd.grad(value, [params[k] for k in names])))
        for v in params.values():
            v.requires_grad_(False)
        losses.append(value.item())
        if first_grad is None:
            first_grad = {k: g.clone() for k, g in grads.items()}
        opt.step(params, grads)
    change = {k: params[k] - init[k].float() for k in params}
    return losses, first_grad, change
