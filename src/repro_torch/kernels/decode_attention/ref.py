"""Plain PyTorch decode_attention: the CPU path and the oracle the CUDA
kernel is held against on the card; beside it, the kernel's split-K
arithmetic (partials per slice of the cache, then the merge) in plain
PyTorch, which the CPU tests hold against both references."""
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


def split_bounds(C: int, n_split: int) -> list[tuple[int, int]]:
    """The kernel's slices of the cache: ceil(C / n_split) entries each, the
    last one ragged (and any past C empty)."""
    chunk = -(-C // n_split)
    return [(min(C, i * chunk), min(C, (i + 1) * chunk)) for i in range(n_split)]


def decode_attention_split_ref(q, k, v, valid, n_split: int) -> torch.Tensor:
    """The split-K arithmetic of the CUDA kernel in plain PyTorch: a partial
    (m, l, acc) per slice of the cache (an invalid slot scores -1e30, an empty
    slice has m = -inf and weighs 0), then the merge: rescale each partial by
    exp(m_i - m), sum, divide by max(l, 1e-30). Same shapes as
    ``decode_attention_ref``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bkgh,bckh->bkgc", q.float(), k.float()) * scale
    scores = torch.where(valid[None, None, None, :], scores, -1e30)
    ms, ls, accs = [], [], []
    for lo, hi in split_bounds(k.shape[1], n_split):
        if lo == hi:
            ms.append(torch.full(scores.shape[:-1], -math.inf, device=q.device))
            ls.append(torch.zeros(scores.shape[:-1], device=q.device))
            accs.append(torch.zeros(q.shape, device=q.device))
            continue
        m = scores[..., lo:hi].amax(-1)
        p = torch.exp(scores[..., lo:hi] - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bkgc,bckh->bkgh", p, v[:, lo:hi].float()))
    m_all = torch.stack(ms).amax(0)
    num = torch.zeros(q.shape, device=q.device)
    den = torch.zeros(scores.shape[:-1], device=q.device)
    for m, l, acc in zip(ms, ls, accs):
        f = torch.where(m == -math.inf, 0.0, torch.exp(m - m_all))
        num += f[..., None] * acc
        den += f * l
    return (num / den.clamp_min(1e-30)[..., None]).to(q.dtype)
