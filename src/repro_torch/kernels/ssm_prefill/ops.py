"""Public Mamba2 prefill elementwise ops with device dispatch: a CPU tensor
takes the plain composition in ``ref.py``; a CUDA tensor takes the
hand-written kernel, or raises. There is no flag or fallback that routes a
CUDA tensor elsewhere. A DTensor raises (``local_only``): the mesh prefill
composes ``ref``'s steps on DTensors itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import local_only

from . import kernel, ref


def prefill_in(xs: torch.Tensor, Bp: torch.Tensor, Cp: torch.Tensor, dt_raw: torch.Tensor,
               conv_cache: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
               dt_bias: torch.Tensor, A_log: torch.Tensor, *, head_dim: int):
    """``ref.prefill_in``'s contract: → (xh, xdt, dA, Bm, Cm), the conv cache
    updated in place."""
    args = (xs, Bp, Cp, dt_raw, conv_cache, conv_w, conv_b, dt_bias, A_log)
    local_only("ssm_prefill_in", *args)
    fn = kernel.prefill_in if xs.is_cuda else ref.prefill_in
    return fn(*args, head_dim=head_dim)


def prefill_out(y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor, D: torch.Tensor,
                scale: torch.Tensor, eps: float) -> torch.Tensor:
    """``ref.prefill_out``'s contract: → the input of out_proj (B,S,d_inner)."""
    local_only("ssm_prefill_out", y, xh, z, D, scale)
    fn = kernel.prefill_out if y.is_cuda else ref.prefill_out
    return fn(y, xh, z, D, scale, eps)
