"""Plain PyTorch Mamba2 mixer arithmetic around the SSD scan: the CPU path of
``ops.prefill_in`` / ``ops.prefill_out`` and the oracle the CUDA kernels are
held against on the card.

``ssd_inputs`` and ``gate`` are the port of the elementwise steps of
``repro.models.ssm``; ``repro_torch.models.ssm`` takes them from here for its
training forward, its decode and its mesh prefill, so one body of each
exists. ``conv_silu`` and ``rms_norm`` are ``repro_torch.models.common``'s,
which RG-LRU and every block norm share: an edit to either changes those
models too. ``prefill_in`` and ``prefill_out`` compose the steps as serving's
bulk prefill does, on plain tensors or on DTensors (the mesh prefill and the
training forward call them too): ``prefill_in`` concatenates the x/B/C
projections behind the conv cache, convolves, splits and updates the cache
in place; ``prefill_out`` adds the ``D`` skip, gates by ``silu(z)`` and
RMS-normalises in f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import conv_silu, rms_norm

__all__ = ["conv_silu", "ssd_inputs", "gate", "rms_norm", "prefill_in", "prefill_out"]


def ssd_inputs(xs: torch.Tensor, dt_raw: torch.Tensor, dt_bias: torch.Tensor,
               A_log: torch.Tensor, head_dim: int):
    """x channels of the conv output (B,S,d_inner) and raw dt (B,S,H) →
    (xh (B,S,H,P), xdt = xh * dt in the model dtype, dA = dt * A f32)."""
    B, S, d_inner = xs.shape
    dt = F.softplus(dt_raw.float() + dt_bias)                          # (B,S,H)
    A = -torch.exp(A_log)                                              # (H,)
    xh = xs.reshape(B, S, d_inner // head_dim, head_dim)
    xdt = xh * dt[..., None].to(xh.dtype)
    return xh, xdt, dt * A


def gate(y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """(y + xh * D) * silu(z), y/xh (B,S,H,P), z (B,S,d_inner) → (B,S,d_inner),
    each step rounded to the model dtype."""
    B, S = y.shape[:2]
    y = y + xh * D[None, None, :, None].to(y.dtype)
    return y.reshape(B, S, -1) * F.silu(z)


def prefill_in(xs: torch.Tensor, Bp: torch.Tensor, Cp: torch.Tensor, dt_raw: torch.Tensor,
               conv_cache: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
               dt_bias: torch.Tensor, A_log: torch.Tensor, *, head_dim: int):
    """Projections xs (B,S,d_inner), Bp/Cp (B,S,N), dt_raw (B,S,H) and the conv
    cache (B,K-1,C) → (xh, xdt (B,S,H,P), dA (B,S,H) f32, Bm, Cm (B,S,N)); the
    cache becomes the trailing K-1 raw rows of cache ++ xBC."""
    S, d_inner, N = xs.shape[1], xs.shape[-1], Bp.shape[-1]
    xBC = torch.cat([xs, Bp, Cp], dim=-1)
    window = torch.cat([conv_cache.to(xBC.dtype), xBC], dim=1)         # (B,K-1+S,C)
    conv_out = conv_silu(window, conv_w, conv_b, S)
    xs, Bm, Cm = conv_out.split([d_inner, N, N], dim=-1)
    xh, xdt, dA = ssd_inputs(xs, dt_raw, dt_bias, A_log, head_dim)
    conv_cache.copy_(window[:, S:])
    return xh, xdt, dA, Bm, Cm


def prefill_out(y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor, D: torch.Tensor,
                scale: torch.Tensor, eps: float) -> torch.Tensor:
    """The scan's y and xh (B,S,H,P), z (B,S,d_inner) → rms_norm(gate) (B,S,d_inner),
    the input of out_proj."""
    return rms_norm(gate(y, xh, z, D), scale, eps)
