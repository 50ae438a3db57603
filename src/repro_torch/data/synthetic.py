"""Synthetic stand-ins for the paper's datasets (nothing is downloaded).

The paper's claims are *comparative* (sync vs async, skew trends, node-count
trends), so the datasets only need (a) the right shapes/cardinalities and
(b) genuine learnable class/sequence structure so accuracy differences are
meaningful. Generators are deterministic given a seed.

* ``make_synthetic_mnist``   — 28×28×1, 10 classes: class-conditional stroke
  prototypes + elastic jitter + noise. Linearly non-trivial, CNN-learnable.
* ``make_synthetic_cifar``   — 32×32×3, 10 classes: class-conditional color/
  texture/frequency prototypes with augment-style perturbations.
* ``make_synthetic_wikitext``— token stream from a seeded order-2 Markov
  grammar over a configurable vocab; next-token prediction has a learnable
  ceiling well below 1.0, like real text.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SyntheticImageDataset:
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    num_classes: int


@dataclass
class SyntheticTokenStream:
    train_tokens: np.ndarray
    test_tokens: np.ndarray
    vocab_size: int


def _class_prototypes(rng: np.random.Generator, num_classes: int, h: int, w: int, c: int) -> np.ndarray:
    """Smooth low-frequency class prototypes: random Fourier features."""
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    protos = np.zeros((num_classes, h, w, c), np.float32)
    for k in range(num_classes):
        img = np.zeros((h, w), np.float32)
        for _ in range(6):
            fx, fy = rng.uniform(0.5, 4.0, size=2)
            px, py = rng.uniform(0, 2 * np.pi, size=2)
            amp = rng.uniform(0.4, 1.0)
            img += amp * np.sin(2 * np.pi * (fx * xx + fy * yy) + px + py)
        img = (img - img.min()) / (np.ptp(img) + 1e-6)
        for ch in range(c):
            protos[k, :, :, ch] = img * rng.uniform(0.5, 1.0)
    return protos


def _make_image_dataset(
    *, num_train: int, num_test: int, h: int, w: int, c: int, num_classes: int,
    noise: float, seed: int,
) -> SyntheticImageDataset:
    rng = np.random.default_rng(seed)
    protos = _class_prototypes(rng, num_classes, h, w, c)

    def sample(n: int, rng: np.random.Generator):
        y = rng.integers(0, num_classes, size=n)
        x = protos[y].copy()
        # random shift (±2 px) + multiplicative jitter + additive noise
        for i in range(n):
            dx, dy = rng.integers(-2, 3, size=2)
            x[i] = np.roll(np.roll(x[i], dx, axis=0), dy, axis=1)
        x *= rng.uniform(0.8, 1.2, size=(n, 1, 1, 1)).astype(np.float32)
        x += rng.normal(0, noise, size=x.shape).astype(np.float32)
        return x.astype(np.float32), y.astype(np.int32)

    x_tr, y_tr = sample(num_train, rng)
    x_te, y_te = sample(num_test, rng)
    return SyntheticImageDataset(x_tr, y_tr, x_te, y_te, num_classes)


def make_synthetic_mnist(num_train: int = 12000, num_test: int = 2000, seed: int = 0) -> SyntheticImageDataset:
    return _make_image_dataset(
        num_train=num_train, num_test=num_test, h=28, w=28, c=1, num_classes=10,
        noise=0.35, seed=seed + 101,
    )


def make_synthetic_cifar(num_train: int = 12000, num_test: int = 2000, seed: int = 0) -> SyntheticImageDataset:
    return _make_image_dataset(
        num_train=num_train, num_test=num_test, h=32, w=32, c=3, num_classes=10,
        noise=0.45, seed=seed + 202,
    )


def make_synthetic_wikitext(
    *, vocab_size: int = 512, train_tokens: int = 200_000, test_tokens: int = 20_000, seed: int = 0,
    branching: int = 4,
) -> SyntheticTokenStream:
    """Order-2 Markov 'language': each bigram context allows ``branching``
    successors with Zipf-ish probabilities. Entropy > 0 ⇒ accuracy ceiling < 1."""
    rng = np.random.default_rng(seed + 303)
    # successor table: for hash(context) pick `branching` candidate tokens
    succ = rng.integers(0, vocab_size, size=(vocab_size, branching))
    probs = np.array([1.0 / (i + 1) for i in range(branching)])
    probs /= probs.sum()

    def gen(n: int, rng: np.random.Generator) -> np.ndarray:
        # pre-draw all branch choices at once (per-step rng.choice is ~100×
        # slower); the chain itself is inherently sequential but cheap
        choices = rng.choice(branching, size=n, p=probs)
        out = np.empty(n, np.int32)
        a, b = rng.integers(0, vocab_size, size=2)
        for i in range(n):
            nxt = succ[(a * 31 + b * 7) % vocab_size, choices[i]]
            out[i] = nxt
            a, b = b, nxt
        return out

    return SyntheticTokenStream(gen(train_tokens, rng), gen(test_tokens, rng), vocab_size)
