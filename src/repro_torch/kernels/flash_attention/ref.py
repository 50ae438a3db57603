"""Plain PyTorch flash_attention (masked softmax attention): the CPU path
and the oracle the CUDA kernel is held against on the card."""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q, k, v, *, window: int = 0) -> torch.Tensor:
    """q: (B,S,KV,G,hd); k/v: (B,S,KV,hd) → (B,S,KV,G,hd), causal."""
    S, hd = q.shape[1], q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bskgh,btkh->bkgst", q.float(), k.float()) * scale
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    scores = torch.where(mask[None, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    return out.to(q.dtype)
