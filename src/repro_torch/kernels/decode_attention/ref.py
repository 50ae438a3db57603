"""Plain PyTorch decode_attention: the CPU path and the oracle the CUDA
kernel is held against on the card."""
from __future__ import annotations

import math

import torch


def decode_attention_ref(q, k, v, valid) -> torch.Tensor:
    """q:(B,KV,G,hd) k/v:(B,C,KV,hd) valid:(C,) → (B,KV,G,hd)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bkgh,bckh->bkgc", q.float(), k.float()) * scale
    scores = torch.where(valid[None, None, None, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgc,bckh->bkgh", probs, v.float())
    return out.to(q.dtype)
