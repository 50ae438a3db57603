"""Public flash attention op with device dispatch: a CPU tensor takes the
plain version in ``ref.py``; a CUDA tensor takes the hand-written kernel, for
any S, or raises. There is no flag or fallback that routes a CUDA tensor
elsewhere."""
from __future__ import annotations

import torch

from repro_torch.kernels import local_only

from . import kernel
from .ref import flash_attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0) -> torch.Tensor:
    """(B,S,KV,G,hd)×(B,S,KV,hd)² → (B,S,KV,G,hd) causal attention."""
    local_only("flash_attention", q, k, v)
    if q.is_cuda:
        return kernel.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                      window=window)
    return flash_attention_ref(q, k, v, window=window)
