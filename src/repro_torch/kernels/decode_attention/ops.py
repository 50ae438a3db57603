"""Public decode-attention op with device dispatch.

Called from ``repro_torch.models.attention.attn_decode`` with the
(B,1,KV,G,hd)-shaped q of a single decode step. A CPU tensor takes the plain
version in ``ref.py``; a CUDA tensor takes the hand-written kernel, or raises.
Like the TPU kernel, it has no logit softcap (``attn_decode`` decides).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import local_only

from . import kernel
from .ref import decode_attention_ref


def decode_attention(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """qg: (B,1,KV,G,hd) (model layout) → (B,1,KV,G,hd)."""
    local_only("decode_attention", qg, k, v, valid)
    q = qg[:, 0]
    if q.is_cuda:
        out = kernel.decode_attention(q.contiguous(), k, v, valid)
    else:
        out = decode_attention_ref(q, k, v, valid)
    return out[:, None]
