"""Plain PyTorch versions of fed_agg / fed_opt: the CPU path and the oracle
the CUDA kernels are held against on the card."""
from __future__ import annotations

import torch


def fed_agg_ref(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(K, N) × (K,) → (N,): Σ_k w_k · x_k in f32."""
    return torch.einsum("k,kn->n", weights.to(torch.float32), stacked.to(torch.float32))


def fed_opt_ref(stacked, weights, x, m, v, *, lr, b1, b2, tau, variant="adam"):
    """Unfused chain of the adaptive aggregation (Reddi et al. 2021):
    weighted mean → pseudo-gradient → moment updates → server step."""
    avg = fed_agg_ref(stacked, weights)
    d = x.to(torch.float32) - avg
    m = b1 * m.to(torch.float32) + (1.0 - b1) * d
    d2 = d * d
    v = v.to(torch.float32)
    if variant == "adam":
        v = b2 * v + (1.0 - b2) * d2
    elif variant == "yogi":
        v = v - (1.0 - b2) * d2 * torch.sign(v - d2)
    elif variant == "adagrad":
        v = v + d2
    else:
        raise ValueError(f"unknown fed_opt variant {variant!r}")
    return x - lr * m / (torch.sqrt(v) + tau), m, v
