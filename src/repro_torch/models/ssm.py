"""Mamba2 — the state-space duality (SSD) block [arXiv:2405.21060]; the port
of ``repro.models.ssm``.

Serving's bulk prefill ``mamba2_prefill`` runs the SSD chunked dual form
through the ``ssd_scan`` op: on a CUDA tensor the hand-written kernel, on a
CPU tensor the plain ``ssd_chunked`` (the reference calls ``ssd_chunked``
directly; its TPU kernel computes the same function); on a mesh it runs
through ``local_map`` on each rank's heads. ``mamba2_full``, the
training forward, calls the plain ``ssd_chunked`` on any device, as the
reference does, so autograd differentiates it (the kernel is forward-only).
The SSD core (``segsum``, ``ssd_chunked``,
``ssd_sequential``) lives in ``repro_torch.kernels.ssd_scan.ref`` and is
re-exported here. Decode carries (conv_state, ssm_state): O(1) per token.

The reference's rounding points are kept: ``xdt = xh * dt`` in the model
dtype, the f32 decode recurrence, ``y`` cast to the model dtype before the
``D`` skip. Unlike the reference's pure functions, decode and prefill update
the cache in place (and return it): ``DecoderLM`` hands each layer views
into its stacked cache.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import segsum, ssd_chunked, ssd_sequential

from .common import ModelConfig, _full, _normal, dense_apply, dense_init, rmsnorm_apply, rmsnorm_init
from .sharded import on_local_shards

__all__ = ["segsum", "ssd_chunked", "ssd_sequential", "init_mamba2", "causal_conv1d",
           "mamba2_full", "init_ssm_cache", "mamba2_decode", "mamba2_prefill"]


def _dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_head_dim
    return d_inner, H, cfg.ssm_state


def init_mamba2(gen, cfg: ModelConfig, lead: tuple = ()) -> dict:
    """The reference's leaves: separate z/x/B/C/dt projections, a depthwise
    causal conv over x, B and C, the deterministic A_log = log(1..H),
    dt_bias = 0 and D = 1 in f32, a gated rmsnorm and out_proj."""
    d_inner, H, N = _dims(cfg)
    dt = cfg.torch_dtype
    conv_ch = d_inner + 2 * N  # x, B, C all pass through the causal conv
    device = "meta" if gen is None else gen.device
    a_log = torch.log(torch.arange(1, H + 1, dtype=torch.float32, device=device))
    return {
        "w_z": dense_init(gen, cfg.d_model, d_inner, dt, lead=lead),
        "w_x": dense_init(gen, cfg.d_model, d_inner, dt, lead=lead),
        "w_B": dense_init(gen, cfg.d_model, N, dt, lead=lead),
        "w_C": dense_init(gen, cfg.d_model, N, dt, lead=lead),
        "w_dt": dense_init(gen, cfg.d_model, H, dt, lead=lead),
        "conv_w": _normal(gen, (*lead, cfg.ssm_conv, conv_ch), dt, 0.1),
        "conv_b": _full(gen, (*lead, conv_ch), dt, 0.0),
        "A_log": a_log.expand(*lead, H).clone(),
        "dt_bias": _full(gen, (*lead, H), torch.float32, 0.0),
        "D": _full(gen, (*lead, H), torch.float32, 1.0),
        "norm": rmsnorm_init(gen, d_inner, dt, lead=lead),
        "out_proj": dense_init(gen, d_inner, cfg.d_model, dt, lead=lead),
    }


def _project_in(p: dict, cfg: ModelConfig, x: torch.Tensor):
    z = dense_apply(p["w_z"], x)
    xBC = torch.cat([dense_apply(p["w_x"], x), dense_apply(p["w_B"], x),
                     dense_apply(p["w_C"], x)], dim=-1)
    dt_raw = dense_apply(p["w_dt"], x)
    return z, xBC, dt_raw


def causal_conv1d(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along time. xBC: (B,S,C); w: (K,C)."""
    K, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    return _conv_silu(pad, w, b, S)


def _conv_silu(window: torch.Tensor, w: torch.Tensor, b: torch.Tensor, S: int) -> torch.Tensor:
    """silu(sum_i window[:, i:i+S] * w[i] + b), summed in the reference's order."""
    out = sum(window[:, i : i + S] * w[i] for i in range(w.shape[0]))
    return F.silu(out + b)


def _ssd_inputs(p: dict, cfg: ModelConfig, conv_out: torch.Tensor, dt_raw: torch.Tensor):
    """conv output and raw dt → (xh, xdt, dA, Bm, Cm); Bm/Cm stay (B,S,N)
    views shared by every head."""
    B, S, _ = conv_out.shape
    d_inner, H, N = _dims(cfg)
    xs, Bm, Cm = conv_out.split([d_inner, N, N], dim=-1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])                    # (B,S,H)
    A = -torch.exp(p["A_log"])                                         # (H,)
    xh = xs.reshape(B, S, H, cfg.ssm_head_dim)
    xdt = xh * dt[..., None].to(xh.dtype)
    return xh, xdt, dt * A, Bm, Cm


def _gated_out(p: dict, cfg: ModelConfig, y, xh, z):
    B, S = y.shape[:2]
    y = y + xh * p["D"][None, None, :, None].to(y.dtype)
    y = y.reshape(B, S, -1)
    y = rmsnorm_apply(p["norm"], y * F.silu(z), cfg.norm_eps)
    return dense_apply(p["out_proj"], y)


def mamba2_full(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    z, xBC, dt_raw = _project_in(p, cfg, x)
    xBC = causal_conv1d(xBC, p["conv_w"], p["conv_b"])
    xh, xdt, dA, Bm, Cm = _ssd_inputs(p, cfg, xBC, dt_raw)
    y = on_local_shards(_ssd_plain, (xdt, dA, Bm, Cm), heads=(2, 2, None, None),
                        chunk=cfg.ssm_chunk)
    return _gated_out(p, cfg, y, xh, z)


def _ssd_plain(x, dA, Bm, Cm, *, chunk: int) -> torch.Tensor:
    """The plain ``ssd_chunked`` from a zero state, B and C shared by every
    head → y."""
    shape = (*Bm.shape[:2], x.shape[2], Bm.shape[-1])
    return ssd_chunked(x, dA, Bm[:, :, None].expand(shape), Cm[:, :, None].expand(shape),
                       chunk)[0]


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=None, *,
                   device: "str | torch.device" = "cpu", lead: tuple = ()) -> dict:
    d_inner, H, N = _dims(cfg)
    dt = dtype or cfg.torch_dtype
    conv_ch = d_inner + 2 * N
    return {
        "conv": torch.zeros((*lead, batch, cfg.ssm_conv - 1, conv_ch), dtype=dt, device=device),
        "ssm": torch.zeros((*lead, batch, H, cfg.ssm_head_dim, N), dtype=torch.float32,
                           device=device),
    }


def mamba2_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                  cache: dict) -> tuple[torch.Tensor, dict]:
    """x: (B,1,D) → (y (B,1,D), cache), the cache updated in place."""
    B = x.shape[0]
    d_inner, H, N = _dims(cfg)
    z, xBC, dt_raw = _project_in(p, cfg, x)
    # conv over the (width-1) history + current token
    window = torch.cat([cache["conv"], xBC], dim=1)                   # (B,K,C)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"])[:, None]
    cache["conv"].copy_(window[:, 1:])
    xs, Bm, Cm = conv_out.split([d_inner, N, N], dim=-1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])[:, 0]               # (B,H)
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(B, H, cfg.ssm_head_dim).float()
    h = cache["ssm"] * torch.exp(dt * A)[..., None, None] + (
        (xh * dt[..., None])[..., :, None] * Bm[:, 0, None, None, :].float())
    cache["ssm"].copy_(h)
    y = torch.einsum("bhpn,bn->bhp", h, Cm[:, 0].float())
    y = y + xh * p["D"][None, :, None]
    y = y.reshape(B, 1, d_inner).to(x.dtype)
    y = rmsnorm_apply(p["norm"], y * F.silu(z), cfg.norm_eps)
    return dense_apply(p["out_proj"], y), cache


def _ssd_in_place(x, dA, Bm, Cm, state, *, chunk: int):
    """The ``ssd_scan`` op seeded from ``state``, its final state written back
    into ``state``."""
    return ssd_ops.ssd(x, dA, Bm, Cm, chunk=chunk, initial_state=state, state_out=state)


def mamba2_prefill(p: dict, cfg: ModelConfig, x: torch.Tensor,
                   cache: dict) -> tuple[torch.Tensor, dict]:
    """``mamba2_full`` that also produces the decode cache — serving's bulk
    prefill. Seeds from ``cache`` (zeros == fresh), so the result matches the
    recurrence ``mamba2_decode`` would have run token by token. The scan's
    final state is written straight into ``cache["ssm"]``; the conv cache
    becomes the trailing (ssm_conv-1) raw xBC rows."""
    S = x.shape[1]
    z, xBC, dt_raw = _project_in(p, cfg, x)
    window = torch.cat([cache["conv"].to(xBC.dtype), xBC], dim=1)     # (B,K-1+S,C)
    conv_out = _conv_silu(window, p["conv_w"], p["conv_b"], S)
    xh, xdt, dA, Bm, Cm = _ssd_inputs(p, cfg, conv_out, dt_raw)
    y, _ = on_local_shards(_ssd_in_place, (xdt, dA, Bm, Cm, cache["ssm"]),
                           heads=(2, 2, None, None, 1), out_like=(0, 4), chunk=cfg.ssm_chunk)
    cache["conv"].copy_(window[:, S:])
    return _gated_out(p, cfg, y, xh, z), cache
