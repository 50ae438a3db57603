"""Public fed_agg / fed_opt ops: the flat-vector aggregation entry points.

``aggregate_flat`` is every strategy's combine: one weighted sum over the
(K, N) stacked client flats. ``fed_opt_flat`` is the fused adaptive-strategy
chain (the FedAdam / FedYogi / FedAdagrad state update in one pass).

Both dispatch on the stack's device: a CPU tensor takes the plain version in
``ref.py``; a CUDA tensor takes the hand-written kernel, for any K >= 1, or
raises. There is no flag or fallback that routes a CUDA tensor elsewhere.
"""
from __future__ import annotations

import numpy as np
import torch

from . import kernel
from .ref import fed_agg_ref, fed_opt_ref


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fed_agg ops run on cpu or cuda tensors, got {t.device}")
    return t.device.type == "cuda"


def _coeffs(weights, like: torch.Tensor) -> torch.Tensor:
    """(K,) f32 coefficients on the stack's device (host numpy is uploaded)."""
    if isinstance(weights, np.ndarray):
        weights = torch.from_numpy(np.ascontiguousarray(weights, np.float32))
    return torch.as_tensor(weights, dtype=torch.float32).to(like.device).contiguous()


def aggregate_flat(stacked: torch.Tensor, weights, *,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """(K, N) stacked flats × (K,) coefficients → (N,) Σ_k w_k·x_k, into
    ``out`` when given."""
    w = _coeffs(weights, stacked)
    if _on_cuda(stacked):
        return kernel.fed_agg(stacked, w, out=out)
    result = fed_agg_ref(stacked, w)
    return result if out is None else out.copy_(result)


def fed_opt_flat(stacked: torch.Tensor, weights, x: torch.Tensor, m: torch.Tensor,
                 v: torch.Tensor, *, variant: str, server_lr: float, beta1: float,
                 beta2: float, tau: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused pseudo-gradient + moment + server-step chain over stacked flats;
    returns fresh (x', m', v') on the stack's device."""
    w = _coeffs(weights, stacked)
    kwargs = dict(lr=float(server_lr), b1=float(beta1), b2=float(beta2),
                  tau=float(tau), variant=variant)
    if _on_cuda(stacked):
        return kernel.fed_opt(stacked, w, x, m, v, **kwargs)
    return fed_opt_ref(stacked, w, x, m, v, **kwargs)
