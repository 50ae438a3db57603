"""Attention variants: GQA/MQA (+qk_norm, LoRA on q, sliding window,
softcap) and MLA — the port of ``repro.models.attention``.

Two entry points, as in the reference:
  * full-sequence causal (training / prefill): ``attn_full`` / ``attn_prefill``,
  * single-token decode against a fixed-capacity ring KV cache: ``attn_decode``
    (capacity C = max_len for full attention, = window for sliding attention).

``use_flash`` is the reference's switch between the kernel and plain
attention. Training leaves it off (``attn_full``'s default, as in the
reference): attention is then plain tensor code under autograd, the masked
softmax ``_sdpa`` or, above ``CHUNKED_THRESHOLD``, ``chunked_sdpa``, which
recomputes each query block in the backward (``torch.utils.checkpoint`` where
the reference has ``jax.checkpoint``). The kernels are forward-only. Serving
turns it on: on CUDA tensors bulk prefill runs the ``flash_attention`` op and
decode the ``decode_attention`` op, the port's hand-written kernels. CPU
tensors take the ops' plain versions, which compute the reference's
``_sdpa``. On a mesh (DTensors) each op runs through ``local_map`` on each
rank's KV heads (``models.sharded``). Neither TPU kernel has a logit
softcap, and the reference never sends a capped config to one: a nonzero
``attn_logit_softcap`` (grok-1) takes ``_sdpa``/``chunked_sdpa`` with the cap
on every device, as MLA does.

Granite 4.0's GQA (``position_embedding="nope"``, ``attention_multiplier``)
takes no rotary embedding and scales its scores by the multiplier in place of
1/sqrt(head_dim): the plain paths take the scale as it is, and q is pre-scaled
before either kernel, which keeps its fixed 1/sqrt(head_dim) (``_kernel_q``).

Unlike the reference's pure functions, the cache is updated *in place* (and
returned): a cache is a few GB at serving's batch sizes, and a functional
update would copy it every token.

MLA (multi-head latent attention, MiniCPM3/DeepSeek-V2) caches the compressed
latent (kv_lora_rank + rope_dim per token) instead of per-head K/V, with a
naive decode (reconstruct K/V each step) and an *absorbed* one (fold W_uk into
the query and W_uv into the output). The reference runs MLA through its plain
``_sdpa``/``chunked_sdpa``, never a TPU kernel (its qk width, nope + rope = 96,
is not a kernel head size), and so does the port, on every device: MLA never
reaches the ``flash_attention`` or ``decode_attention`` op.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.flash_attention import ops as flash_ops

from .common import ModelConfig, apply_rope, dense_apply, dense_init, rmsnorm_apply, rmsnorm_init
from .sharded import fsdp_gather, merge_dims, on_local_shards, replicated, split_dim, write_at

NEG_INF = -1e30


def _maybe_softcap(scores: torch.Tensor, cap: float) -> torch.Tensor:
    if cap > 0:
        scores = torch.tanh(scores / cap) * cap
    return scores


def _sdpa(q, k, v, mask, softcap: float, scale: float | None = None) -> torch.Tensor:
    """q: (B,S,KV,G,hd), k/v: (B,T,KV,hd), mask: (B,S,T) or (S,T); scores
    scaled by ``scale`` (default 1/sqrt(hd))."""
    scale = scale or 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bskgh,btkh->bkgst", q.float(), k.float()) * scale
    scores = _maybe_softcap(scores, softcap)
    mask_b = mask[None, None, None] if mask.dim() == 2 else mask[:, None, None]
    scores = torch.where(mask_b, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    return out.to(v.dtype)


def chunked_sdpa(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                 window: int = 0, softcap: float = 0.0, qblock: int = 256,
                 probs_bf16: bool = False, scale: float | None = None) -> torch.Tensor:
    """Memory-bounded attention: a loop over query blocks, full softmax per
    row against (a slice of) K. Never materializes the S×T score matrix.
    With a sliding ``window``, each q-block only reads a (window + qblock)
    K/V slice. Under autograd each block is recomputed in the backward
    instead of saving its f32 (B,KV,G,qblock,T) probabilities.
    qg: (B,S,KV,G,hd), k/v: (B,T,KV,hd); scores scaled by ``scale``
    (default 1/sqrt(hd))."""
    B, S, KV, G, hd = qg.shape
    T = k.shape[1]
    scale = scale or 1.0 / math.sqrt(hd)
    if S % qblock != 0:
        qblock = math.gcd(S, qblock) or S
    use_slice = window > 0 and causal
    span = min(T, window + qblock) if use_slice else T

    def body(qblk: torch.Tensor, q0: int) -> torch.Tensor:
        start = min(max(q0 + qblock - span, 0), T - span) if use_slice else 0
        ks, vs = k[:, start:start + span], v[:, start:start + span]
        kpos = start + torch.arange(span, device=k.device)
        scores = torch.einsum("bskgh,btkh->bkgst", qblk.float(), ks.float()) * scale
        scores = _maybe_softcap(scores, softcap)
        qpos = q0 + torch.arange(qblock, device=k.device)
        mask = torch.ones((qblock, span), dtype=torch.bool, device=k.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window > 0:
            mask &= kpos[None, :] > qpos[:, None] - window
        probs = torch.softmax(torch.where(mask[None, None, None], scores, NEG_INF), dim=-1)
        if probs_bf16:
            dt = torch.promote_types(torch.bfloat16, vs.dtype)
            out = torch.einsum("bkgst,btkh->bskgh", probs.to(torch.bfloat16).to(dt), vs.to(dt))
        else:
            out = torch.einsum("bkgst,btkh->bskgh", probs, vs.float())
        return out.to(v.dtype)

    outs = []
    for q0 in range(0, S, qblock):
        qblk = qg[:, q0:q0 + qblock]
        if torch.is_grad_enabled():
            outs.append(checkpoint(body, qblk, q0, use_reentrant=False))
        else:
            outs.append(body(qblk, q0))
    return torch.cat(outs, dim=1)


# sequences longer than this use the chunked path in attn_full
CHUNKED_THRESHOLD = 1024


def causal_mask(seq: int, window: int = 0, offset: int = 0, device=None) -> torch.Tensor:
    """(S, T) causal mask; optional sliding window; offset for prefix caches."""
    qpos = torch.arange(seq, device=device)[:, None] + offset
    kpos = torch.arange(seq + offset, device=device)[None, :]
    mask = kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------


def init_attention(gen, cfg: ModelConfig, lead: tuple = ()) -> dict:
    hd = cfg.head_dim_
    dt = cfg.torch_dtype
    p = {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * hd, dt, lead=lead),
        "wk": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dt, lead=lead),
        "wv": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dt, lead=lead),
        "wo": dense_init(gen, cfg.n_heads * hd, cfg.d_model, dt, lead=lead),
    }
    if cfg.lora_rank:
        # LoRA adapter on the q projection: B starts at zero so the adapter
        # is initially a no-op (standard LoRA init).
        p["lora_a"] = dense_init(gen, cfg.d_model, cfg.lora_rank, dt, lead=lead)
        p["lora_b"] = dense_init(gen, cfg.lora_rank, cfg.n_heads * hd, dt, scale=0.0,
                                 lead=lead)
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(gen, hd, dt, lead=lead)
        p["k_norm"] = rmsnorm_init(gen, hd, dt, lead=lead)
    return p


def _project_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    B, S, _ = x.shape
    hd = cfg.head_dim_
    q_flat = dense_apply(p["wq"], x)
    if "lora_a" in p:
        q_flat = q_flat + dense_apply(p["lora_b"], dense_apply(p["lora_a"], x))
    q = split_dim(q_flat, -1, (cfg.n_heads, hd))
    k = split_dim(dense_apply(p["wk"], x), -1, (cfg.n_kv_heads, hd))
    v = split_dim(dense_apply(p["wv"], x), -1, (cfg.n_kv_heads, hd))
    if cfg.qk_norm:
        q = rmsnorm_apply(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm_apply(p["k_norm"], k, cfg.norm_eps)
    if cfg.position_embedding != "nope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _kernel_q(cfg: ModelConfig, q: torch.Tensor) -> torch.Tensor:
    """q for a kernel, which scales scores by 1/sqrt(hd): where
    ``attention_multiplier`` is set, pre-scaled by the multiplier times
    sqrt(hd), so the scores come out scaled by the multiplier.
    granite-4.0-h's 1/64 at hd 64 gives 0.125, a power of two: exact in bf16."""
    if not cfg.attention_multiplier:
        return q
    return q * (cfg.attention_multiplier * math.sqrt(q.shape[-1]))


def _plain_causal(qg, k, v, *, window: int, softcap: float, qblock: int,
                  probs_bf16: bool, scale: float | None = None) -> torch.Tensor:
    """Plain causal attention: ``_sdpa``, or ``chunked_sdpa`` above
    ``CHUNKED_THRESHOLD``."""
    S = qg.shape[1]
    if S > CHUNKED_THRESHOLD:
        return chunked_sdpa(qg, k, v, causal=True, window=window, softcap=softcap,
                            qblock=qblock, probs_bf16=probs_bf16, scale=scale)
    return _sdpa(qg, k, v, causal_mask(S, window, device=qg.device), softcap, scale)


def _full_causal_out(cfg: ModelConfig, qg, k, v, *, window: int, use_flash: bool):
    """Full-sequence causal dispatch shared by attn_full / attn_prefill; on a
    mesh, each rank attends over its own batch rows and KV heads."""
    if use_flash and cfg.attn_logit_softcap == 0:
        return on_local_shards(flash_ops.flash_attention, (_kernel_q(cfg, qg), k, v),
                               heads=(2, 2, 2), window=window)
    return on_local_shards(_plain_causal, (qg, k, v), heads=(2, 2, 2), window=window,
                           softcap=cfg.attn_logit_softcap, qblock=cfg.attn_qblock,
                           probs_bf16=cfg.attn_probs_bf16, scale=cfg.attention_multiplier)


def attn_full(p: dict, cfg: ModelConfig, x: torch.Tensor, *, window: int | None = None,
              use_flash: bool = False) -> torch.Tensor:
    """Full-sequence causal attention (train / prefill without a cache)."""
    B, S, _ = x.shape
    window = cfg.sliding_window if window is None else window
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, cfg, x, positions)
    G = cfg.n_heads // cfg.n_kv_heads
    qg = split_dim(q, 2, (cfg.n_kv_heads, G))
    out = _full_causal_out(cfg, qg, k, v, window=window, use_flash=use_flash)
    return dense_apply(p["wo"], merge_dims(out, 2))


def fill_ring(cache: dict, entries: dict, seq: int) -> dict:
    """Scatter a length-``seq`` prefix (positions 0..seq-1) into a ring cache,
    in place. Only the last min(seq, capacity) positions survive — exactly
    the state a token-at-a-time decode loop would have left behind after
    wrapping; restricting the scatter to them keeps slot indices unique."""
    slot_pos = cache["slot_pos"]
    capacity = slot_pos.shape[0]
    keep = min(seq, capacity)
    pos = torch.arange(seq - keep, seq, dtype=torch.int32, device=slot_pos.device)
    slots = (pos % capacity).long()
    for name, val in entries.items():
        write_at(cache[name], 1, slots, val[:, seq - keep:].to(cache[name].dtype))
    write_at(slot_pos, 0, slots, pos)
    return cache


def init_attn_cache(cfg: ModelConfig, batch: int, capacity: int, dtype=None, *,
                    device: "str | torch.device" = "cpu", lead: tuple = ()) -> dict:
    """Ring-buffer KV cache. ``capacity`` = window for sliding attention,
    = max_len for full attention."""
    dt = dtype or cfg.torch_dtype
    hd = cfg.head_dim_
    shape = (*lead, batch, capacity, cfg.n_kv_heads, hd)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "slot_pos": torch.full((*lead, capacity), -1, dtype=torch.int32, device=device),
    }


def _sdpa_valid(qg, k, v, valid, *, softcap: float, scale: float | None = None) -> torch.Tensor:
    """``_sdpa`` of one decode query against a ring whose (C,) ``valid`` mask
    the batch shares."""
    return _sdpa(qg, k, v, valid[None, None, :], softcap, scale)


def attn_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict, pos: int, *,
                window: int | None = None) -> tuple[torch.Tensor, dict]:
    """One-token decode. x: (B,1,D); pos: the global position (a host int).
    Writes the token's k/v into slot pos % C of ``cache`` in place."""
    B = x.shape[0]
    hd = cfg.head_dim_
    pos = int(pos)
    window = cfg.sliding_window if window is None else window
    positions = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, positions)
    slot_pos = cache["slot_pos"]
    slot = pos % slot_pos.shape[0]
    write_at(cache["k"], 1, slice(slot, slot + 1), k)
    write_at(cache["v"], 1, slice(slot, slot + 1), v)
    write_at(slot_pos, 0, slot, pos)
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if window and window > 0:
        valid &= slot_pos > pos - window
    G = cfg.n_heads // cfg.n_kv_heads
    qg = split_dim(q, 2, (cfg.n_kv_heads, G))
    if cfg.attn_logit_softcap == 0:
        out = on_local_shards(dec_ops.decode_attention,
                              (_kernel_q(cfg, qg), cache["k"], cache["v"], valid),
                              heads=(2, 2, 2, None))
    else:
        out = on_local_shards(_sdpa_valid, (qg, cache["k"], cache["v"], valid),
                              heads=(2, 2, 2, None), softcap=cfg.attn_logit_softcap,
                              scale=cfg.attention_multiplier)
    out = out.reshape(B, 1, cfg.n_heads * hd)
    return dense_apply(p["wo"], out), cache


def attn_prefill(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict, *,
                 window: int | None = None) -> tuple[torch.Tensor, dict]:
    """``attn_full`` that also fills the decode ring cache — serving's bulk
    prefill. Equivalent to pushing the prompt through ``attn_decode`` one
    token at a time (same projections, same rope positions, same ring
    occupancy) at full-sequence matmul cost, through the flash kernel on the
    card (serving never takes gradients). ``cache`` must be fresh
    (``init_attn_cache``); positions start at 0."""
    B, S, _ = x.shape
    window = cfg.sliding_window if window is None else window
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, cfg, x, positions)
    G = cfg.n_heads // cfg.n_kv_heads
    qg = split_dim(q, 2, (cfg.n_kv_heads, G))
    out = _full_causal_out(cfg, qg, k, v, window=window, use_flash=True)
    out = dense_apply(p["wo"], out.reshape(B, S, cfg.n_heads * cfg.head_dim_))
    return out, fill_ring(cache, {"k": k, "v": v}, S)


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention)
# ---------------------------------------------------------------------------


def init_mla(gen, cfg: ModelConfig, lead: tuple = ()) -> dict:
    dt = cfg.torch_dtype
    qk_dim = cfg.qk_nope_dim + cfg.qk_rope_dim
    return {
        # query path: down-project → norm → up-project to per-head (nope+rope)
        "wq_a": dense_init(gen, cfg.d_model, cfg.q_lora_rank, dt, lead=lead),
        "q_a_norm": rmsnorm_init(gen, cfg.q_lora_rank, dt, lead=lead),
        "wq_b": dense_init(gen, cfg.q_lora_rank, cfg.n_heads * qk_dim, dt, lead=lead),
        # kv path: shared compressed latent + shared rope key
        "wkv_a": dense_init(gen, cfg.d_model, cfg.kv_lora_rank, dt, lead=lead),
        "kv_a_norm": rmsnorm_init(gen, cfg.kv_lora_rank, dt, lead=lead),
        "wk_rope": dense_init(gen, cfg.d_model, cfg.qk_rope_dim, dt, lead=lead),
        "wk_b": dense_init(gen, cfg.kv_lora_rank, cfg.n_heads * cfg.qk_nope_dim, dt, lead=lead),
        "wv_b": dense_init(gen, cfg.kv_lora_rank, cfg.n_heads * cfg.v_head_dim, dt, lead=lead),
        "wo": dense_init(gen, cfg.n_heads * cfg.v_head_dim, cfg.d_model, dt, lead=lead),
    }


def _mla_q(p, cfg: ModelConfig, x, positions):
    B, S, _ = x.shape
    qk_dim = cfg.qk_nope_dim + cfg.qk_rope_dim
    q_lat = rmsnorm_apply(p["q_a_norm"], dense_apply(p["wq_a"], x), cfg.norm_eps)
    q = split_dim(dense_apply(p["wq_b"], q_lat), -1, (cfg.n_heads, qk_dim))
    q_nope, q_rope = q[..., : cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latent(p, cfg: ModelConfig, x, positions):
    c_kv = rmsnorm_apply(p["kv_a_norm"], dense_apply(p["wkv_a"], x), cfg.norm_eps)
    k_rope = apply_rope(dense_apply(p["wk_rope"], x)[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def _mla_attend(cfg: ModelConfig, qg, k, v, window: int) -> torch.Tensor:
    """Plain causal attention for MLA's unified heads (never a kernel)."""
    return on_local_shards(_plain_causal, (qg, k, v), heads=(2, 2, 2), window=window or 0,
                           softcap=0.0, qblock=cfg.attn_qblock, probs_bf16=cfg.attn_probs_bf16)


def mla_full_absorbed(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                      window: int | None = None) -> torch.Tensor:
    """Absorbed-matmul MLA for the full-sequence path: W_uk folds into the
    query (per-head latent queries) and W_uv into the output, so scores and
    context are computed against the (S, kv_rank) latent, shared by every
    head (MQA, kv = 1)."""
    B, S, _ = x.shape
    window = cfg.sliding_window if window is None else window
    positions = torch.arange(S, device=x.device)[None, :]
    q_nope, q_rope = _mla_q(p, cfg, x, positions)            # (B,S,H,dn), (B,S,H,dr)
    c_kv, k_rope = _mla_latent(p, cfg, x, positions)         # (B,S,R), (B,S,dr)
    H, R, dr = cfg.n_heads, cfg.kv_lora_rank, cfg.qk_rope_dim
    wk_b = split_dim(fsdp_gather(p["wk_b"]["w"]), -1, (H, cfg.qk_nope_dim))
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, wk_b.to(q_nope.dtype))
    q_full = torch.cat([q_lat, q_rope], dim=-1)              # (B,S,H,R+dr)
    k_full = torch.cat([c_kv, k_rope], dim=-1)               # (B,S,R+dr)
    # the score scale must be the naive path's 1/sqrt(nope + rope), but the
    # attention scales by 1/sqrt(R + dr): pre-scale q to compensate
    fix = math.sqrt(R + dr) / math.sqrt(cfg.qk_nope_dim + dr)
    qg = (q_full * fix).reshape(B, S, 1, H, R + dr)
    # context in latent space: pad the latent "values" to key width
    v_lat = F.pad(c_kv, (0, dr))[:, :, None, :]
    ctx = _mla_attend(cfg, qg, k_full[:, :, None, :], v_lat, window)
    ctx_lat = merge_dims(ctx, 2).reshape(B, S, H, R + dr)[..., :R]
    wv_b = split_dim(fsdp_gather(p["wv_b"]["w"]), -1, (H, cfg.v_head_dim))
    out = torch.einsum("bshr,rhd->bshd", ctx_lat, wv_b.to(ctx_lat.dtype))
    return dense_apply(p["wo"], merge_dims(out, 2))


def mla_full(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
             window: int | None = None) -> torch.Tensor:
    if cfg.mla_absorb:
        return mla_full_absorbed(p, cfg, x, window=window)
    B, S, _ = x.shape
    window = cfg.sliding_window if window is None else window
    positions = torch.arange(S, device=x.device)[None, :]
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c_kv, k_rope = _mla_latent(p, cfg, x, positions)
    H, dr = cfg.n_heads, cfg.qk_rope_dim
    k_nope = split_dim(dense_apply(p["wk_b"], c_kv), -1, (H, cfg.qk_nope_dim))
    v = split_dim(dense_apply(p["wv_b"], c_kv), -1, (H, cfg.v_head_dim))
    # one head_dim of nope + rope; k_rope is shared across heads (MQA-style)
    q_full = torch.cat([q_nope, q_rope], dim=-1)                      # (B,S,H,dn+dr)
    k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, dr)], dim=-1)
    # pad v up to the qk head_dim so the shapes line up, slice after
    qk_dim = cfg.qk_nope_dim + dr
    vp = F.pad(v, (0, qk_dim - cfg.v_head_dim))
    out = _mla_attend(cfg, q_full.reshape(B, S, H, 1, qk_dim), k_full, vp, window)
    out = out[:, :, :, 0, : cfg.v_head_dim]
    return dense_apply(p["wo"], merge_dims(out, 2))


def init_mla_cache(cfg: ModelConfig, batch: int, capacity: int, dtype=None, *,
                   device: "str | torch.device" = "cpu", lead: tuple = ()) -> dict:
    """Ring-buffer latent cache: the compressed c_kv and the shared rope key
    per position."""
    dt = dtype or cfg.torch_dtype
    return {
        "c_kv": torch.zeros((*lead, batch, capacity, cfg.kv_lora_rank), dtype=dt, device=device),
        "k_rope": torch.zeros((*lead, batch, capacity, cfg.qk_rope_dim), dtype=dt, device=device),
        "slot_pos": torch.full((*lead, capacity), -1, dtype=torch.int32, device=device),
    }


def _mla_decode_attend(wk_b, wv_b, cfg: ModelConfig, q_nope, q_rope, c_kv, k_rope, valid,
                       absorb: bool) -> torch.Tensor:
    """One decode query per head against the latent ring → (B,1,H,v_head_dim)
    f32 context."""
    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    ckv = c_kv.float()        # (B,C,R)
    krope = k_rope.float()    # (B,C,r)
    H, R = cfg.n_heads, cfg.kv_lora_rank
    if absorb:
        # fold W_uk into the query: per-head latent query (B,1,H,R)
        q_lat = torch.einsum("bshd,rhd->bshr", q_nope.float(),
                             wk_b.float().reshape(R, H, cfg.qk_nope_dim))
        scores = torch.einsum("bshr,bcr->bhsc", q_lat, ckv)
        scores = scores + torch.einsum("bshd,bcd->bhsc", q_rope.float(), krope)
        scores = torch.where(valid[None, None, None], scores * scale, NEG_INF)
        ctx_lat = torch.einsum("bhsc,bcr->bshr", torch.softmax(scores, dim=-1), ckv)
        return torch.einsum("bshr,rhd->bshd", ctx_lat,
                            wv_b.float().reshape(R, H, cfg.v_head_dim))
    B, C = ckv.shape[:2]
    k_nope = (c_kv @ wk_b).reshape(B, C, H, cfg.qk_nope_dim)
    v = (c_kv @ wv_b).reshape(B, C, H, cfg.v_head_dim)
    scores = torch.einsum("bshd,bchd->bhsc", q_nope.float(), k_nope.float())
    scores = scores + torch.einsum("bshd,bcd->bhsc", q_rope.float(), krope)
    scores = torch.where(valid[None, None, None], scores * scale, NEG_INF)
    return torch.einsum("bhsc,bchd->bshd", torch.softmax(scores, dim=-1), v.float())


def mla_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict, pos: int, *,
               window: int | None = None, absorb: bool = False) -> tuple[torch.Tensor, dict]:
    """One-token MLA decode; writes the token's latent into slot pos % C of
    ``cache`` in place.

    naive (absorb=False): reconstruct per-head K/V from all cached latents.
    absorbed (absorb=True): score directly in the latent space by folding
    W_uk into the query and W_uv into the output — no K/V materialization.
    """
    B = x.shape[0]
    pos = int(pos)
    window = cfg.sliding_window if window is None else window
    positions = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c_kv_new, k_rope_new = _mla_latent(p, cfg, x, positions)
    slot_pos = cache["slot_pos"]
    slot = pos % slot_pos.shape[0]
    write_at(cache["c_kv"], 1, slice(slot, slot + 1), c_kv_new)
    write_at(cache["k_rope"], 1, slice(slot, slot + 1), k_rope_new)
    write_at(slot_pos, 0, slot, pos)
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if window and window > 0:
        valid &= slot_pos > pos - window
    # on a mesh, plain code on whole tensors: DTensor has no rule for these
    # products over heads sharded on "model"
    out = replicated(_mla_decode_attend)(p["wk_b"]["w"], p["wv_b"]["w"], cfg, q_nope, q_rope,
                                         cache["c_kv"], cache["k_rope"], valid, absorb)
    out = out.to(x.dtype).reshape(B, 1, cfg.n_heads * cfg.v_head_dim)
    return dense_apply(p["wo"], out), cache


def mla_prefill(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict, *,
                window: int | None = None) -> tuple[torch.Tensor, dict]:
    """``mla_full`` that also fills the latent decode cache (fresh, positions
    from 0). The latent projection is recomputed for the ring fill, as in the
    reference."""
    out = mla_full(p, cfg, x, window=window)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    c_kv, k_rope = _mla_latent(p, cfg, x, positions)
    return out, fill_ring(cache, {"c_kv": c_kv, "k_rope": k_rope}, x.shape[1])
