"""Paper-experiment vision models: the MNIST CNN (§4.2) and the GroupNorm
ResNet-18 for CIFAR (§4.3) — the port of ``repro.models.cnn``.

Parameters are nested dicts of tensors in the reference's layout, so the wire
format and ``LeafSpec.key`` match it: conv weights are HWIO over NHWC
activations, dense weights are (d_in, d_out). ``apply`` takes NHWC input like
the reference. Inside, an NHWC activation is carried as its NCHW permutation
(the same bytes: a channels-last tensor), which is what ``F.conv2d`` and
``F.group_norm`` take; weights are permuted to OIHW at each call.

Padding reproduces JAX's ``"SAME"``: out = ceil(in / stride), and the total
padding is split with the extra row/column *after*. With stride 2 on an even
input that is asymmetric (3×3 on 32×32: 0 before, 1 after), which
``F.conv2d(padding=1)`` would get wrong — such convolutions are padded
explicitly with ``F.pad``. GroupNorm is ``min(8, C)`` groups of consecutive
channels, population variance, eps 1e-5. Max-pooling is 2×2 VALID.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.tree import tree_map
from repro_torch.kernels import resolve_device
from repro_torch.models.common import load_jax_params  # noqa: F401  (re-exported)


def _generator(rng: "int | torch.Generator | None") -> torch.Generator | None:
    if rng is None or isinstance(rng, torch.Generator):
        return rng
    return torch.Generator().manual_seed(int(rng))


# The init helpers draw on the CPU from ``gen``; ``gen=None`` builds meta
# tensors instead (shapes and dtypes only, no memory).
def _normal(gen, shape, std):
    if gen is None:
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, dtype=torch.float32) * std


def _const(gen, shape, value):
    return torch.full(shape, value, dtype=torch.float32, device="meta" if gen is None else "cpu")


def _conv_init(gen, kh, kw, cin, cout):
    fan_in = kh * kw * cin
    return {"w": _normal(gen, (kh, kw, cin, cout), math.sqrt(2.0 / fan_in)),
            "b": _const(gen, (cout,), 0.0)}


def _dense_init(gen, d_in, d_out):
    return {"w": _normal(gen, (d_in, d_out), math.sqrt(1.0 / d_in)),
            "b": _const(gen, (d_out,), 0.0)}


def _groupnorm_init(gen, c):
    return {"scale": _const(gen, (c,), 1.0), "bias": _const(gen, (c,), 0.0)}


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """JAX "SAME" padding of one spatial dim: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(p, x, stride=1):
    """x: (B, C, H, W) view of NHWC activations; p["w"]: HWIO."""
    kh, kw = p["w"].shape[:2]
    top, bottom = _same_pads(x.shape[2], kh, stride)
    left, right = _same_pads(x.shape[3], kw, stride)
    w = p["w"].permute(3, 2, 0, 1)  # HWIO → OIHW
    if top == bottom and left == right:
        return F.conv2d(x, w, p["b"], stride=stride, padding=(top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, p["b"], stride=stride)


def _dense(p, x):
    return x @ p["w"] + p["b"]


def _groupnorm(p, x, groups=8):
    return F.group_norm(x, min(groups, x.shape[1]), p["scale"], p["bias"], eps=1e-5)


def _maxpool(x, k=2):
    return F.max_pool2d(x, k, k)


def _nchw(x_nhwc) -> torch.Tensor:
    return torch.as_tensor(x_nhwc).permute(0, 3, 1, 2)


def _classification_loss(logits, labels):
    labels = labels.long()
    logp = F.log_softmax(logits, dim=-1)
    ce = -logp.gather(-1, labels[:, None]).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return ce, {"accuracy": acc}


class _Model:
    """init / abstract / apply / loss over a parameter dict."""

    def _build(self, gen) -> dict:
        raise NotImplementedError

    def init(self, rng: "int | torch.Generator" = 0, *,
             device: "str | torch.device" = "cuda") -> dict:
        """Random parameters from a seed (or a CPU ``torch.Generator``),
        drawn on the CPU so every device gets the same values."""
        dev = resolve_device(device)
        return tree_map(lambda t: t.to(dev), self._build(_generator(rng)))

    def abstract(self) -> dict:
        """The parameter tree's shapes and dtypes, as meta tensors."""
        return self._build(None)

    def loss(self, params, batch, rng=None):
        return _classification_loss(self.apply(params, batch["x"]), batch["y"])


# ---------------------------------------------------------------------------
# MNIST CNN (paper §4.2)
# ---------------------------------------------------------------------------


class MnistCNN(_Model):
    """conv(32)→pool→relu → conv(64)→pool→relu → dense(128) → dense(10)."""

    def __init__(self, num_classes: int = 10, in_channels: int = 1, hw: int = 28):
        self.num_classes = num_classes
        self.in_channels = in_channels
        self.flat = (hw // 4) ** 2 * 64

    def _build(self, gen) -> dict:
        return {
            "conv1": _conv_init(gen, 3, 3, self.in_channels, 32),
            "conv2": _conv_init(gen, 3, 3, 32, 64),
            "fc1": _dense_init(gen, self.flat, 128),
            "fc2": _dense_init(gen, 128, self.num_classes),
        }

    def apply(self, params, x):
        x = F.relu(_maxpool(_conv(params["conv1"], _nchw(x))))
        x = F.relu(_maxpool(_conv(params["conv2"], x)))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flatten in NHWC order
        x = F.relu(_dense(params["fc1"], x))
        return _dense(params["fc2"], x)


# ---------------------------------------------------------------------------
# ResNet (paper §4.3 uses ResNet-18 on CIFAR-10)
# ---------------------------------------------------------------------------


def _block_init(gen, cin, cout, stride):
    p = {
        "conv1": _conv_init(gen, 3, 3, cin, cout),
        "gn1": _groupnorm_init(gen, cout),
        "conv2": _conv_init(gen, 3, 3, cout, cout),
        "gn2": _groupnorm_init(gen, cout),
    }
    if stride != 1 or cin != cout:
        p["proj"] = _conv_init(gen, 1, 1, cin, cout)
    return p


def _block(p, x, stride):
    h = F.relu(_groupnorm(p["gn1"], _conv(p["conv1"], x, stride)))
    h = _groupnorm(p["gn2"], _conv(p["conv2"], h))
    shortcut = _conv(p["proj"], x, stride) if "proj" in p else x
    return F.relu(h + shortcut)


class ResNet(_Model):
    """ResNet-18 topology (2-2-2-2 basic blocks), GroupNorm, CIFAR stem."""

    STAGES = [(64, 1), (128, 2), (256, 2), (512, 2)]

    def __init__(self, num_classes: int = 10, in_channels: int = 3, width: int = 1,
                 blocks_per_stage: int = 2):
        self.num_classes = num_classes
        self.in_channels = in_channels
        self.width = width
        self.bps = blocks_per_stage

    def _build(self, gen) -> dict:
        params = {
            "stem": _conv_init(gen, 3, 3, self.in_channels, 64 * self.width),
            "gn0": _groupnorm_init(gen, 64 * self.width),
        }
        cin = 64 * self.width
        for s, (cout_base, stride) in enumerate(self.STAGES):
            cout = cout_base * self.width
            for b in range(self.bps):
                params[f"s{s}b{b}"] = _block_init(gen, cin, cout, stride if b == 0 else 1)
                cin = cout
        params["fc"] = _dense_init(gen, cin, self.num_classes)
        return params

    def apply(self, params, x):
        x = F.relu(_groupnorm(params["gn0"], _conv(params["stem"], _nchw(x))))
        for s, (_, stride) in enumerate(self.STAGES):
            for b in range(self.bps):
                x = _block(params[f"s{s}b{b}"], x, stride if b == 0 else 1)
        return _dense(params["fc"], x.mean(dim=(2, 3)))
