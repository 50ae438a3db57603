"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427) — the
port of ``repro.models.rglru``.

Block: two branches — (linear → GeLU) gate branch and (linear → causal conv1d
→ RG-LRU) recurrent branch — merged multiplicatively then projected out.

RG-LRU recurrence (per channel):
    r_t = σ(W_a x_t),  i_t = σ(W_x x_t)
    a_t = exp(-c · softplus(Λ) · r_t)
    h_t = a_t h_{t-1} + sqrt(1 − a_t²) · (i_t ⊙ x_t)

Training and prefill run the recurrence as a log-depth scan in plain tensor
code (``rglru_scan``: ⌈log2 S⌉ elementwise combine steps, where the reference
has ``jax.lax.associative_scan``); the reference has no kernel here. Decode is
a single step carrying (conv_state, h). Unlike the reference's pure
functions, decode and prefill update the cache in place (and return it).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import ModelConfig, _full, _normal, _uniform, dense_apply, dense_init
from .ssm import _conv_silu, causal_conv1d


def init_rglru(gen, cfg: ModelConfig, lead: tuple = ()) -> dict:
    d = cfg.d_model
    dr = d  # lru width = d_model
    dt = cfg.torch_dtype
    # Λ init so that a ∈ [0.9, 0.999] at r=1 (Griffin appendix); kept in f32
    u = _uniform(gen, (*lead, dr), 0.9, 0.999)
    lam = torch.log(torch.expm1(-torch.log(u) / cfg.rglru_c))  # softplus^{-1}
    return {
        "w_gate": dense_init(gen, d, dr, dt, lead=lead),     # GeLU branch
        "w_rec": dense_init(gen, d, dr, dt, lead=lead),      # recurrent branch input
        "conv_w": _normal(gen, (*lead, cfg.conv1d_width, dr), dt, 0.1),
        "conv_b": _full(gen, (*lead, dr), dt, 0.0),
        "w_a": dense_init(gen, dr, dr, dt, scale=0.02, lead=lead),
        "w_x": dense_init(gen, dr, dr, dt, scale=0.02, lead=lead),
        "lambda": lam,
        "w_out": dense_init(gen, dr, d, dt, lead=lead),
    }


def _gates(p: dict, cfg: ModelConfig, x: torch.Tensor):
    r = torch.sigmoid(dense_apply(p["w_a"], x).float())
    i = torch.sigmoid(dense_apply(p["w_x"], x).float())
    a = torch.exp(-cfg.rglru_c * F.softplus(p["lambda"]) * r)
    gated_in = torch.sqrt(torch.clamp_min(1.0 - a.square(), 1e-12)) * (i * x.float())
    return a, gated_in


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor | None = None) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along axis 1, as a log-depth scan: at step
    ``off`` every position t ≥ off combines the prefix ending at t − off,
    (a1, b1) ∘ (a2, b2) = (a1·a2, a2·b1 + b2); ⌈log2 S⌉ steps in all.
    Without autograd (serving) each step writes into one of two preallocated
    (a, b) pairs, swapped between steps, instead of concatenating new ones."""
    if h0 is not None:
        # fold initial state into the first element
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    S, off = a.shape[1], 1
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        while off < S:
            b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], dim=1)
            a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], dim=1)
            off *= 2
        return b
    pairs = [(torch.empty_like(a), torch.empty_like(b)) for _ in range(2)]
    while off < S:
        a_out, b_out = pairs[0]
        b_out[:, :off].copy_(b[:, :off])
        torch.addcmul(b[:, off:], a[:, off:], b[:, :-off], out=b_out[:, off:])
        if 2 * off < S:  # the last step needs no products of a
            a_out[:, :off].copy_(a[:, :off])
            torch.mul(a[:, :-off], a[:, off:], out=a_out[:, off:])
        pairs.reverse()
        a, b = a_out, b_out
        off *= 2
    return b


def rglru_full(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (B,S,D) → (B,S,D)."""
    gate = F.gelu(dense_apply(p["w_gate"], x), approximate="tanh")
    u = causal_conv1d(dense_apply(p["w_rec"], x), p["conv_w"], p["conv_b"])
    a, b = _gates(p, cfg, u)
    h = rglru_scan(a, b).to(x.dtype)
    return dense_apply(p["w_out"], h * gate)


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype=None, *,
                     device: "str | torch.device" = "cpu", lead: tuple = ()) -> dict:
    dr = cfg.d_model
    dt = dtype or cfg.torch_dtype
    return {
        "conv": torch.zeros((*lead, batch, cfg.conv1d_width - 1, dr), dtype=dt, device=device),
        "h": torch.zeros((*lead, batch, dr), dtype=torch.float32, device=device),
    }


def rglru_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 cache: dict) -> tuple[torch.Tensor, dict]:
    """x: (B,1,D) → (out (B,1,D), cache), the cache updated in place."""
    gate = F.gelu(dense_apply(p["w_gate"], x), approximate="tanh")
    u = dense_apply(p["w_rec"], x)                                    # (B,1,dr)
    window = torch.cat([cache["conv"], u], dim=1)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"])[:, None]
    a, b = _gates(p, cfg, conv_out)
    h = a[:, 0] * cache["h"] + b[:, 0]
    cache["conv"].copy_(window[:, 1:])
    cache["h"].copy_(h)
    return dense_apply(p["w_out"], h[:, None].to(x.dtype) * gate), cache


def rglru_prefill(p: dict, cfg: ModelConfig, x: torch.Tensor,
                  cache: dict) -> tuple[torch.Tensor, dict]:
    """``rglru_full`` that also produces the decode cache — serving's bulk
    prefill: the scan seeded with the cached h, the depthwise conv over the
    cached raw-u window (zeros == fresh). x: (B,S,D)."""
    S = x.shape[1]
    gate = F.gelu(dense_apply(p["w_gate"], x), approximate="tanh")
    u = dense_apply(p["w_rec"], x)
    window = torch.cat([cache["conv"].to(u.dtype), u], dim=1)        # (B,K-1+S,dr)
    conv_out = _conv_silu(window, p["conv_w"], p["conv_b"], S)
    a, b = _gates(p, cfg, conv_out)
    h = rglru_scan(a, b, h0=cache["h"])
    out = dense_apply(p["w_out"], h.to(x.dtype) * gate)
    cache["conv"].copy_(window[:, S:])
    cache["h"].copy_(h[:, -1])
    return out, cache
