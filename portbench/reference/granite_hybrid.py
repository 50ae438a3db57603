"""Granite 4.0-H (IBM, ``granitemoehybrid``; hf:ibm-granite/granite-4.0-h-micro)
as a decoder-only language model, forward only, in plain PyTorch float32.

Layer i is a Mamba2 layer or a GQA attention layer, as the period
``layer_pattern`` says (``ssm_mlp`` or ``attn``), and every layer, whatever
its mixer, is followed by a SwiGLU MLP. With r = ``residual_multiplier``:

    x   = embed(tokens) * embedding_multiplier
    x   = x + r * mixer(rmsnorm(x))
    x   = x + r * (silu(h W_gate) * (h W_up)) W_down,    h = rmsnorm(x)
    out = rmsnorm(x) E^T / logits_scaling                 (E: the tied embedding)

The Mamba2 mixer is ``reference.mamba2``'s: z, x, B, C (one group shared by
every head) and dt from the normed input, a depthwise causal convolution of
width ``ssm_conv`` with bias and SiLU over x, B and C, the selective scan
    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t + D x_t
in chunks of ``ssm_chunk`` (A = -exp(A_log), dt = softplus(dt_raw +
dt_bias)), then rmsnorm(y * silu(z)) and an output projection. The attention
mixer has ``n_heads`` query heads and ``n_kv_heads`` key/value heads of
``head_dim`` (query head j reads key/value head j // (n_heads / n_kv_heads)),
no position embedding (NoPE), causal softmax(q k^T * attention_multiplier) v,
then an output projection. Attention is computed in blocks of
``QUERY_BLOCK`` queries, each against the keys up to its last, so that a
32,768-position check fits on one card. Every RMSNorm has eps ``norm_eps``
and a scale.

Departures from the published model, each also what the served model holds:
  * separate ``w_z``/``w_x``/``w_B``/``w_C``/``w_dt`` leaves where the
    published model has one fused ``in_proj`` (the same products, split);
  * separate gate (``mlp/wi``) and up (``mlp/wg``) leaves where it has one
    ``input_linear`` whose output halves are gate and up;
  * random weights (``make_weights``), not the published checkpoint;
  * the embedding multiplier is rounded to the served type (12 is exact).

``quant="fp8"`` is the control: every matrix product's weight and input are
rounded to float8 e4m3 with one absmax scale per tensor, as an fp8 serving
path would compute.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .mamba2 import _mm, _rmsnorm, ssd

QUERY_BLOCK = 512


def dims(cfg: dict) -> dict:
    d_inner = cfg["ssm_expand"] * cfg["d_model"]
    pad = cfg["vocab_pad_to"]
    return {"d_inner": d_inner, "H": d_inner // cfg["ssm_head_dim"], "N": cfg["ssm_state"],
            "P": cfg["ssm_head_dim"], "conv_ch": d_inner + 2 * cfg["ssm_state"],
            "padded_vocab": -(-cfg["vocab_size"] // pad) * pad,
            "groups": cfg["n_layers"] // len(cfg["layer_pattern"])}


def _block(u: int, kind: str) -> str:
    return f"blocks/u{u}_{kind}"


def layout(cfg: dict) -> list[tuple[str, tuple, str]]:
    """(path, shape, dtype name) of every leaf, sorted by path. Each position
    u of the period has its leaves stacked along a leading axis over the
    periods (``n_layers`` is a whole number of them)."""
    d, ff, hd = cfg["d_model"], cfg["d_ff"], cfg["head_dim"]
    m = dims(cfg)
    G, served = m["groups"], cfg["dtype"]
    leaves = [("embed/table", (m["padded_vocab"], d), served), ("final_norm/scale", (d,), served)]
    for u, kind in enumerate(cfg["layer_pattern"]):
        b = _block(u, kind)
        leaves += [(f"{b}/norm1/scale", (G, d), served), (f"{b}/norm2/scale", (G, d), served),
                   (f"{b}/mlp/wi/w", (G, d, ff), served), (f"{b}/mlp/wg/w", (G, d, ff), served),
                   (f"{b}/mlp/wo/w", (G, ff, d), served)]
        if kind == "attn":
            q, kv = cfg["n_heads"] * hd, cfg["n_kv_heads"] * hd
            leaves += [(f"{b}/attn/wq/w", (G, d, q), served),
                       (f"{b}/attn/wk/w", (G, d, kv), served),
                       (f"{b}/attn/wv/w", (G, d, kv), served),
                       (f"{b}/attn/wo/w", (G, q, d), served)]
        elif kind == "ssm_mlp":
            s = f"{b}/ssm"
            leaves += [
                (f"{s}/A_log", (G, m["H"]), "float32"), (f"{s}/D", (G, m["H"]), "float32"),
                (f"{s}/dt_bias", (G, m["H"]), "float32"),
                (f"{s}/conv_b", (G, m["conv_ch"]), served),
                (f"{s}/conv_w", (G, cfg["ssm_conv"], m["conv_ch"]), served),
                (f"{s}/norm/scale", (G, m["d_inner"]), served),
                (f"{s}/out_proj/w", (G, m["d_inner"], d), served),
                (f"{s}/w_B/w", (G, d, m["N"]), served), (f"{s}/w_C/w", (G, d, m["N"]), served),
                (f"{s}/w_dt/w", (G, d, m["H"]), served),
                (f"{s}/w_x/w", (G, d, m["d_inner"]), served),
                (f"{s}/w_z/w", (G, d, m["d_inner"]), served)]
        else:
            raise ValueError(f"no {kind!r} layer in Granite 4.0-H")
    return sorted(leaves)


def _std(path: str, shape: tuple, cfg: dict) -> float:
    """The normal draw's scale of a leaf: the embedding ``embed_std``, the
    convolution 0.1, q and k projections ``qk_gain``/sqrt(d_in), every other
    projection 1/sqrt(d_in)."""
    if path == "embed/table":
        return cfg["embed_std"]
    if path.endswith("conv_w"):
        return 0.1
    if path.endswith(("attn/wq/w", "attn/wk/w")):
        return cfg["qk_gain"] / math.sqrt(shape[-2])
    return 1.0 / math.sqrt(shape[-2])


def make_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Random weights from ``seed``, drawn on ``device`` in a few large calls:
    one normal draw for every matrix, scaled per leaf (``_std``), and one
    uniform draw for the per-head A = U[1, 16] and dt = exp(U[log 1e-3,
    log 1e-1]) of Mamba2's initialisation (dt_bias = softplus^-1(dt)). Norm
    scales and D are 1, the convolution's bias 0."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2**63))
    dtype = getattr(torch, cfg["dtype"])
    leaves = layout(cfg)
    normal = [(p, s) for p, s, _ in leaves
              if p.endswith("/w") or p.endswith("conv_w") or p == "embed/table"]
    sizes = [math.prod(s) for _, s in normal]
    scales = torch.tensor([_std(p, s, cfg) for p, s in normal], device=device)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    flat.mul_(torch.repeat_interleave(scales, torch.tensor(sizes, device=device)))
    out, pos = {}, 0
    for (path, shape), n in zip(normal, sizes):
        out[path] = flat[pos:pos + n].view(shape).to(dtype)
        pos += n
    del flat
    ssm_blocks = [_block(u, k) + "/ssm" for u, k in enumerate(cfg["layer_pattern"])
                  if k == "ssm_mlp"]
    G, H = dims(cfg)["groups"], dims(cfg)["H"]
    u = torch.rand(2, len(ssm_blocks), G, H, generator=gen, device=device)
    dt = torch.exp(math.log(1e-3) + (math.log(1e-1) - math.log(1e-3)) * u[1])
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    for i, blk in enumerate(ssm_blocks):
        out[f"{blk}/A_log"] = torch.log(1.0 + 15.0 * u[0, i])
        out[f"{blk}/dt_bias"] = dt_bias[i]
    for path, shape, dname in leaves:
        if path not in out:
            value = 0.0 if path.endswith("conv_b") else 1.0
            out[path] = torch.full(shape, value, dtype=getattr(torch, dname), device=device)
    return out


def _mamba(p: dict, cfg: dict, h: torch.Tensor, quant: str | None) -> torch.Tensor:
    m = dims(cfg)
    K, S, eps = cfg["ssm_conv"], h.shape[1], cfg["norm_eps"]
    z = _mm(h, p["ssm/w_z/w"], quant)
    xbc = torch.cat([_mm(h, p["ssm/w_x/w"], quant), _mm(h, p["ssm/w_B/w"], quant),
                     _mm(h, p["ssm/w_C/w"], quant)], dim=-1)
    dt_raw = _mm(h, p["ssm/w_dt/w"], quant)
    padded = F.pad(xbc, (0, 0, K - 1, 0))
    conv = F.silu(sum(padded[:, j:j + S] * p["ssm/conv_w"][j] for j in range(K))
                  + p["ssm/conv_b"])
    del padded, xbc
    xs, Bm, Cm = conv.split([m["d_inner"], m["N"], m["N"]], dim=-1)
    dt = F.softplus(dt_raw + p["ssm/dt_bias"])                          # (b,S,H)
    A = -torch.exp(p["ssm/A_log"])
    xh = xs.reshape(*xs.shape[:2], m["H"], m["P"])
    y = ssd(xh * dt[..., None], dt * A, Bm, Cm, cfg["ssm_chunk"])
    y = y + xh * p["ssm/D"][:, None]
    y = _rmsnorm(y.reshape(*y.shape[:2], -1) * F.silu(z), p["ssm/norm/scale"], eps)
    return _mm(y, p["ssm/out_proj/w"], quant)


def _attention(p: dict, cfg: dict, h: torch.Tensor, quant: str | None,
               scale: float) -> torch.Tensor:
    b, S, _ = h.shape
    hd, KV = cfg["head_dim"], cfg["n_kv_heads"]
    G = cfg["n_heads"] // KV
    q = _mm(h, p["attn/wq/w"], quant).reshape(b, S, KV, G, hd)
    k = _mm(h, p["attn/wk/w"], quant).reshape(b, S, KV, hd)
    v = _mm(h, p["attn/wv/w"], quant).reshape(b, S, KV, hd)
    out = torch.empty_like(q)
    for q0 in range(0, S, QUERY_BLOCK):
        q1 = min(S, q0 + QUERY_BLOCK)
        scores = torch.einsum("bskgh,btkh->bkgst", q[:, q0:q1], k[:, :q1]) * scale
        keys, queries = torch.arange(q1, device=h.device), torch.arange(q0, q1, device=h.device)
        causal = keys[None] <= queries[:, None]
        probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
        out[:, q0:q1] = torch.einsum("bkgst,btkh->bskgh", probs, v[:, :q1])
    return _mm(out.reshape(b, S, -1), p["attn/wo/w"], quant)


def forward(w: dict, cfg: dict, tokens: torch.Tensor, *, quant: str | None = None,
            keep: slice = slice(None), attention_scale: float | None = None) -> torch.Tensor:
    """tokens (b, S) -> float32 logits (b, S', padded_vocab) at the positions
    ``keep`` selects. ``attention_scale`` replaces ``attention_multiplier``
    (a fault's reading)."""
    dtype = getattr(torch, cfg["dtype"])
    eps, r = cfg["norm_eps"], cfg["residual_multiplier"]
    scale = attention_scale or cfg["attention_multiplier"]
    pattern = cfg["layer_pattern"]
    table = w["embed/table"].float()
    x = table[tokens.long()] * float(torch.tensor(cfg["embedding_multiplier"], dtype=dtype))
    for i in range(cfg["n_layers"]):
        u, kind = i % len(pattern), pattern[i % len(pattern)]
        blk = _block(u, kind)
        p = {k[len(blk) + 1:]: v[i // len(pattern)].float()
             for k, v in w.items() if k.startswith(blk + "/")}
        h = _rmsnorm(x, p["norm1/scale"], eps)
        mixed = _mamba(p, cfg, h, quant) if kind == "ssm_mlp" else _attention(p, cfg, h, quant,
                                                                               scale)
        x = x + r * mixed
        h = _rmsnorm(x, p["norm2/scale"], eps)
        up = F.silu(_mm(h, p["mlp/wi/w"], quant)) * _mm(h, p["mlp/wg/w"], quant)
        x = x + r * _mm(up, p["mlp/wo/w"], quant)
        del h, up, mixed
    x = _rmsnorm(x[:, keep], w["final_norm/scale"].float(), eps)
    return _mm(x, table.t(), quant) / cfg["logits_scaling"]


def served_gaps(w: dict, cfg: dict, prompts: torch.Tensor, served: torch.Tensor, *,
                control: bool = False) -> torch.Tensor:
    """The reference over each prompt followed by its served tokens, one
    prompt at a time: at every served position, how far the served token's
    logit lies below the reference's best (``control``: the token an fp8
    forward puts first in its place). prompts (b, S), served (b, T) -> (b, T)
    gaps, in logit units (after ``logits_scaling``)."""
    V = cfg["vocab_size"]
    S, T = prompts.shape[1], served.shape[1]
    keep = slice(S - 1, S - 1 + T)
    rows = []
    for prompt, tokens in zip(prompts, served):
        seq = torch.cat([prompt, tokens[:-1]])[None]
        ref = forward(w, cfg, seq, keep=keep)[0, :, :V]
        if control:
            pick = forward(w, cfg, seq, quant="fp8", keep=keep)[0, :, :V].argmax(-1)
        else:
            pick = tokens.long()
        rows.append(ref.max(-1).values - ref.gather(-1, pick[:, None])[:, 0])
    return torch.stack(rows)
