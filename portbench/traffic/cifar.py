"""Synthetic CIFAR-10 (32x32x3, 10 classes): class-conditional prototypes of
random Fourier features, each image shifted by up to 2 pixels, scaled by
U[0.8, 1.2] and given N(0, 0.45) noise. A copy of the program's
``data/synthetic.py`` generator, so that the inputs do not change when the
program does."""
from __future__ import annotations

import numpy as np


def _class_prototypes(rng: np.random.Generator, num_classes: int, h: int, w: int,
                      c: int) -> np.ndarray:
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


def images(n: int, seed: int, *, hw: int = 32, channels: int = 3, num_classes: int = 10,
           noise: float = 0.45) -> tuple[np.ndarray, np.ndarray]:
    """-> (x (n, hw, hw, channels) f32, y (n,) int32)."""
    rng = np.random.default_rng(seed)
    protos = _class_prototypes(rng, num_classes, hw, hw, channels)
    y = rng.integers(0, num_classes, size=n)
    x = protos[y].copy()
    for i in range(n):
        dx, dy = rng.integers(-2, 3, size=2)
        x[i] = np.roll(np.roll(x[i], dx, axis=0), dy, axis=1)
    x *= rng.uniform(0.8, 1.2, size=(n, 1, 1, 1)).astype(np.float32)
    x += rng.normal(0, noise, size=x.shape).astype(np.float32)
    return x.astype(np.float32), y.astype(np.int32)
