"""Mixture-of-Experts layer — GShard/Switch-style capacity-based dispatch; the
port of ``repro.models.moe``.

Routing is two einsums against a one-hot dispatch tensor (token → expert,
capacity slot), with the experts stacked on a leading E axis; or, with
``cfg.moe_dispatch == "gather"``, index arithmetic (a stable sort by expert,
a gather into the (E·C, D) expert buffer, a scatter-add back). Tokens
overflowing an expert's capacity are dropped (standard Switch behaviour); the
router adds the usual load-balance auxiliary loss. The expert products are
plain batched matmuls: the reference has no kernel here.

Supports top-1 (llama4-scout, 16e) and top-2 (grok-1, 8e) routing plus
optional shared experts (llama4).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import ModelConfig, _normal, dense_init, mlp_apply, mlp_init


def init_moe(gen, cfg: ModelConfig, lead: tuple = ()) -> dict:
    dt = cfg.torch_dtype
    E, D, F_ = cfg.num_experts, cfg.d_model, cfg.d_ff
    p = {
        "router": dense_init(gen, D, E, dt, scale=0.02, lead=lead),
        "wi": {"w": _normal(gen, (*lead, E, D, F_), dt, 1.0 / math.sqrt(D))},   # (E, D, F)
        "wg": {"w": _normal(gen, (*lead, E, D, F_), dt, 1.0 / math.sqrt(D))},
        "wo": {"w": _normal(gen, (*lead, E, F_, D), dt, 1.0 / math.sqrt(F_))},  # (E, F, D)
    }
    if cfg.num_shared_experts:
        p["shared"] = mlp_init(gen, cfg, d_ff=F_ * cfg.num_shared_experts, lead=lead)
    return p


def _top_k_gating(logits: torch.Tensor, k: int):
    """logits: (N, E) → (gates (N,k), indices (N,k), all gates (N,E)); the
    top-k gates renormalized. Equal gates keep the lower expert first, as
    ``jax.lax.top_k`` does (a stable descending sort)."""
    gates_all = torch.softmax(logits.float(), dim=-1)
    gates, idx = torch.sort(gates_all, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :k], idx[:, :k]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return gates, idx, gates_all


def _capacity(cfg: ModelConfig, n: int) -> int:
    # Decode calls see only N = batch tokens; capacity-dropping there would
    # diverge from the full-sequence forward, so small token counts get full
    # capacity (no drops). Training keeps the standard Switch capacity rule.
    k, E = cfg.experts_per_token, cfg.num_experts
    return n if n <= 64 else max(1, int(cfg.moe_capacity_factor * k * n / E))


def _experts(p: dict, cfg: ModelConfig, expert_in: torch.Tensor) -> torch.Tensor:
    """(E, C, D) → (E, C, D) through each expert's MLP."""
    h = torch.einsum("ecd,edf->ecf", expert_in, p["wi"]["w"])
    if cfg.activation in ("swiglu", "geglu"):
        g = torch.einsum("ecd,edf->ecf", expert_in, p["wg"]["w"])
        h = (F.silu(h) if cfg.activation == "swiglu" else F.gelu(h, approximate="tanh")) * g
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.einsum("ecf,efd->ecd", h, p["wo"]["w"])


def _aux_loss(idx: torch.Tensor, gates_all: torch.Tensor, E: int) -> torch.Tensor:
    """Load-balance aux loss (Switch): E * Σ_e fraction_e · router_prob_e."""
    frac = F.one_hot(idx[:, 0], E).float().mean(0)
    return E * (frac * gates_all.mean(0)).sum()


def moe_apply_gather(p: dict, cfg: ModelConfig, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort/gather-based dispatch: argsort (token, choice) pairs by expert,
    compute each pair's position within its expert via one cumsum, gather
    tokens into the (E·C, D) expert buffer and scatter-add the gated outputs
    back. Same capacity-drop semantics as the einsum path."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    N = B * S
    xt = x.reshape(N, D)
    gates, idx, gates_all = _top_k_gating(xt @ p["router"]["w"], k)
    capacity = _capacity(cfg, N)

    flat_expert = idx.reshape(N * k)                       # expert of each (token, choice)
    flat_token = torch.arange(N, device=x.device).repeat_interleave(k)
    order = torch.argsort(flat_expert, stable=True)
    s_expert, s_token, s_gate = flat_expert[order], flat_token[order], gates.reshape(N * k)[order]
    # position of each entry within its expert's run of the sorted array
    counts = torch.bincount(flat_expert, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(N * k, device=x.device) - starts[s_expert]
    kept = pos < capacity
    slot = torch.where(kept, s_expert * capacity + pos, E * capacity)  # overflow slot

    # gather tokens into expert buffers; slot E*C is a scratch row
    token_for_slot = torch.full((E * capacity + 1,), N, dtype=torch.long, device=x.device)
    token_for_slot[slot] = torch.where(kept, s_token, N)
    x_pad = torch.cat([xt, xt.new_zeros((1, D))], dim=0)
    expert_in = x_pad[token_for_slot[: E * capacity]].reshape(E, capacity, D)
    expert_out = _experts(p, cfg, expert_in).reshape(E * capacity, D)

    # scatter gated outputs back to tokens
    contrib = expert_out[torch.where(kept, slot, 0)] * torch.where(
        kept, s_gate, 0.0)[:, None].to(x.dtype)
    out = torch.zeros((N, D), dtype=x.dtype, device=x.device).index_add(0, s_token, contrib)
    if "shared" in p:
        out = out + mlp_apply(p["shared"], xt, cfg.activation)
    return out.reshape(B, S, D), _aux_loss(idx, gates_all, E)


def moe_apply(p: dict, cfg: ModelConfig, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) → (out, aux_loss). Dispatch per cfg.moe_dispatch."""
    if cfg.moe_dispatch == "gather":
        return moe_apply_gather(p, cfg, x)
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    N = B * S
    xt = x.reshape(N, D)
    gates, idx, gates_all = _top_k_gating(xt @ p["router"]["w"], k)
    capacity = _capacity(cfg, N)
    # position of each (token, choice) within its expert's capacity buffer
    flat_choice = F.one_hot(idx, E).reshape(N * k, E)          # (N*k, E)
    pos_in_expert = torch.cumsum(flat_choice, 0) * flat_choice - 1
    pos = pos_in_expert.reshape(N, k, E).amax(-1)                # (N, k)
    kept = (pos < capacity) & (pos >= 0)
    gates = gates * kept.to(gates.dtype)

    # dispatch / combine (N, E, C): one-hot over both expert and capacity slot
    expert_hot = F.one_hot(idx, E).to(x.dtype)[..., None]                       # (N,k,E,1)
    slot_hot = F.one_hot(torch.where(kept, pos, capacity), capacity + 1).to(x.dtype)
    slot_hot = slot_hot[..., :-1][:, :, None, :]                                 # (N,k,1,C)
    dispatch = (expert_hot * slot_hot).sum(1)
    combine = (gates.to(x.dtype)[..., None, None] * expert_hot * slot_hot).sum(1)

    expert_in = torch.einsum("nec,nd->ecd", dispatch, xt)       # (E, C, D)
    out = torch.einsum("nec,ecd->nd", combine, _experts(p, cfg, expert_in))
    if "shared" in p:
        out = out + mlp_apply(p["shared"], xt, cfg.activation)
    return out.reshape(B, S, D), _aux_loss(idx, gates_all, E)
