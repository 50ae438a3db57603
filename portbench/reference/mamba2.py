"""Mamba2 (Dao & Gu 2024, arXiv:2405.21060) as a decoder-only language
model, forward only, in plain PyTorch float32.

Each of ``n_layers`` blocks is x + mixer(rmsnorm(x)). The mixer projects the
normed input to z, x, B, C (one group shared by every head) and dt, runs a
depthwise causal convolution of width ``ssm_conv`` with SiLU over x, B and C,
and the selective scan with per-head scalar decay
    h_t = exp(dt_t * A) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t + D x_t,
then rmsnorm(y * silu(z)) and an output projection. A = -exp(A_log) and
dt = softplus(dt_raw + dt_bias) are float32. The scan is computed in chunks of
``ssm_chunk`` positions (the state-space dual form). Embeddings are tied.

Two departures of the repository's Mamba2 from the published model, kept
here because they are what the served model computes: the token embedding is
multiplied by sqrt(d_model) rounded to the served type, and the logits cover
the vocabulary padded to ``vocab_pad_to`` (argmax is taken over the first
``vocab_size``).

``quant="fp8"`` is the control: every matrix product's weight and input are
rounded to float8 e4m3 with one absmax scale per tensor, as an fp8 serving
path would compute.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

def dims(cfg: dict) -> dict:
    d_inner = cfg["ssm_expand"] * cfg["d_model"]
    heads = d_inner // cfg["ssm_head_dim"]
    pad = cfg["vocab_pad_to"]
    return {"d_inner": d_inner, "H": heads, "N": cfg["ssm_state"], "P": cfg["ssm_head_dim"],
            "conv_ch": d_inner + 2 * cfg["ssm_state"],
            "padded_vocab": -(-cfg["vocab_size"] // pad) * pad}


def layout(cfg: dict) -> list[tuple[str, tuple, str]]:
    """(path, shape, dtype name) of every leaf, sorted by path. The blocks'
    leaves are stacked along a leading layer axis."""
    d, L = cfg["d_model"], cfg["n_layers"]
    m = dims(cfg)
    served = cfg["dtype"]
    blk = "blocks/u0_ssm"
    leaves = [
        ("embed/table", (m["padded_vocab"], d), served),
        ("final_norm/scale", (d,), served),
        (f"{blk}/norm1/scale", (L, d), served),
        (f"{blk}/ssm/A_log", (L, m["H"]), "float32"),
        (f"{blk}/ssm/D", (L, m["H"]), "float32"),
        (f"{blk}/ssm/conv_b", (L, m["conv_ch"]), served),
        (f"{blk}/ssm/conv_w", (L, cfg["ssm_conv"], m["conv_ch"]), served),
        (f"{blk}/ssm/dt_bias", (L, m["H"]), "float32"),
        (f"{blk}/ssm/norm/scale", (L, m["d_inner"]), served),
        (f"{blk}/ssm/out_proj/w", (L, m["d_inner"], d), served),
        (f"{blk}/ssm/w_B/w", (L, d, m["N"]), served),
        (f"{blk}/ssm/w_C/w", (L, d, m["N"]), served),
        (f"{blk}/ssm/w_dt/w", (L, d, m["H"]), served),
        (f"{blk}/ssm/w_x/w", (L, d, m["d_inner"]), served),
        (f"{blk}/ssm/w_z/w", (L, d, m["d_inner"]), served),
    ]
    return sorted(leaves)


def make_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Random weights from ``seed``, drawn on ``device`` in a few large calls:
    one normal draw for every matrix, scaled per leaf (embeddings 0.02, a
    projection 1/sqrt(d_in), the convolution 0.1), and one uniform draw for
    the per-head A = U[1, 16] and dt = exp(U[log 1e-3, log 1e-1]) of Mamba2's
    initialisation (dt_bias = softplus^-1(dt)). Norm scales and D are 1, the
    convolution's bias 0."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2**63))
    dtype = getattr(torch, cfg["dtype"])
    leaves = layout(cfg)
    std = {"embed/table": 0.02, "ssm/conv_w": 0.1}
    normal = [(p, s) for p, s, d in leaves
              if p.endswith("/w") or p.endswith("conv_w") or p == "embed/table"]
    sizes = [math.prod(s) for _, s in normal]
    scales = torch.tensor([std.get(p, std.get(p.split("/", 2)[-1], None))
                           or 1.0 / math.sqrt(s[-2]) for p, s in normal], device=device)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    flat.mul_(torch.repeat_interleave(scales, torch.tensor(sizes, device=device)))
    out, pos = {}, 0
    for (path, shape), n in zip(normal, sizes):
        out[path] = flat[pos:pos + n].view(shape).to(dtype)
        pos += n
    del flat
    L, H = cfg["n_layers"], dims(cfg)["H"]
    u = torch.rand(2, L, H, generator=gen, device=device)
    blk = "blocks/u0_ssm/ssm"
    out[f"{blk}/A_log"] = torch.log(1.0 + 15.0 * u[0])
    dt = torch.exp(math.log(1e-3) + (math.log(1e-1) - math.log(1e-3)) * u[1])
    out[f"{blk}/dt_bias"] = dt + torch.log(-torch.expm1(-dt))
    for path, shape, dname in leaves:
        if path not in out:
            value = 0.0 if path.endswith("conv_b") else 1.0
            out[path] = torch.full(shape, value, dtype=getattr(torch, dname), device=device)
    return out


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp_min(1e-12) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _mm(x: torch.Tensor, w: torch.Tensor, quant: str | None) -> torch.Tensor:
    if quant == "fp8":
        return _fp8(x) @ _fp8(w)
    return x @ w


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def ssd(x, dA, Bm, Cm, chunk: int) -> torch.Tensor:
    """y_t = sum_{s<=t} (C_t . B_s) exp(sum_{s<r<=t} dA_r) x_s, chunk by chunk:
    x (b,S,H,P), dA (b,S,H), B/C (b,S,N), from a zero state."""
    b, S, H, P = x.shape
    state = x.new_zeros(b, H, P, Bm.shape[-1])
    ys = []
    for c0 in range(0, S, chunk):
        xc, ac = x[:, c0:c0 + chunk], dA[:, c0:c0 + chunk]
        bc, cc = Bm[:, c0:c0 + chunk], Cm[:, c0:c0 + chunk]
        L = xc.shape[1]
        cum = ac.cumsum(1)                                                # (b,L,H)
        causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
        decay = torch.where(causal[None, :, :, None], cum[:, :, None] - cum[:, None],
                            float("-inf")).exp()                         # (b,t,s,H)
        weights = torch.einsum("btn,bsn->bts", cc, bc)[..., None] * decay
        y = torch.einsum("btsh,bshp->bthp", weights, xc)
        y = y + torch.einsum("btn,bhpn->bthp", cc, state) * cum.exp()[..., None]
        end = cum[:, -1]                                                  # (b,H)
        w_in = (end[:, None] - cum).exp()                                 # (b,L,H)
        state = state * end.exp()[..., None, None] + torch.einsum(
            "bsh,bshp,bsn->bhpn", w_in, xc, bc)
        ys.append(y)
    return torch.cat(ys, dim=1)


def forward(w: dict, cfg: dict, tokens: torch.Tensor, *, quant: str | None = None,
            keep: slice = slice(None)) -> torch.Tensor:
    """tokens (b, S) -> float32 logits (b, S', padded_vocab) at the positions
    ``keep`` selects."""
    m = dims(cfg)
    dtype = getattr(torch, cfg["dtype"])
    eps, K = cfg["norm_eps"], cfg["ssm_conv"]
    table = w["embed/table"].float()
    scale = float(torch.tensor(cfg["d_model"] ** 0.5, dtype=dtype))
    x = table[tokens.long()] * scale
    blk = "blocks/u0_ssm"
    S = tokens.shape[1]
    for i in range(cfg["n_layers"]):
        p = {k[len(blk) + 1:]: v[i].float() for k, v in w.items() if k.startswith(blk)}
        h = _rmsnorm(x, p["norm1/scale"], eps)
        z = _mm(h, p["ssm/w_z/w"], quant)
        xbc = torch.cat([_mm(h, p["ssm/w_x/w"], quant), _mm(h, p["ssm/w_B/w"], quant),
                         _mm(h, p["ssm/w_C/w"], quant)], dim=-1)
        dt_raw = _mm(h, p["ssm/w_dt/w"], quant)
        padded = F.pad(xbc, (0, 0, K - 1, 0))
        conv = sum(padded[:, j:j + S] * p["ssm/conv_w"][j] for j in range(K))
        conv = F.silu(conv + p["ssm/conv_b"])
        xs, Bm, Cm = conv.split([m["d_inner"], m["N"], m["N"]], dim=-1)
        dt = F.softplus(dt_raw + p["ssm/dt_bias"])                         # (b,S,H)
        A = -torch.exp(p["ssm/A_log"])
        xh = xs.reshape(*xs.shape[:2], m["H"], m["P"])
        y = ssd(xh * dt[..., None], dt * A, Bm, Cm, cfg["ssm_chunk"])
        y = y + xh * p["ssm/D"][:, None]
        y = _rmsnorm(y.reshape(*y.shape[:2], -1) * F.silu(z), p["ssm/norm/scale"], eps)
        x = x + _mm(y, p["ssm/out_proj/w"], quant)
    x = _rmsnorm(x[:, keep], w["final_norm/scale"].float(), eps)
    return _mm(x, table.t(), quant)


def served_gaps(w: dict, cfg: dict, prompts: torch.Tensor, served: torch.Tensor, *,
                control: bool = False) -> torch.Tensor:
    """The reference over each prompt followed by its served tokens: at every
    served position, how far the served token's logit lies below the
    reference's best (``control``: the token an fp8 forward puts first in its
    place). prompts (b, S), served (b, T) -> (b, T) gaps."""
    V = cfg["vocab_size"]
    S, T = prompts.shape[1], served.shape[1]
    seq = torch.cat([prompts, served[:, :-1]], dim=1)
    keep = slice(S - 1, S - 1 + T)
    ref = forward(w, cfg, seq, keep=keep)[..., :V]
    if control:
        pick = forward(w, cfg, seq, quant="fp8", keep=keep)[..., :V].argmax(-1)
    else:
        pick = served.long()
    return ref.max(-1).values - ref.gather(-1, pick[..., None])[..., 0]
