"""Mamba2 — the state-space duality (SSD) block [arXiv:2405.21060]; the port
of ``repro.models.ssm``.

Which path runs where:
- Serving's bulk prefill ``mamba2_prefill`` on a CUDA tensor: two hand-written
  kernels around the ``ssd_scan`` kernel (``repro_torch.kernels.ssm_prefill``:
  ``prefill_in`` reads the x/B/C projections and the conv cache in place and
  writes the scan's inputs and the new conv cache; ``prefill_out`` fuses the
  ``D`` skip, the SiLU gate and the RMSNorm), then out_proj.
- The same prefill on a CPU tensor: the plain composition of those ops
  (``kernels/ssm_prefill/ref.py``) and the plain ``ssd_chunked`` (the
  reference calls ``ssd_chunked`` directly; its TPU kernel computes the same
  function).
- On a mesh (DTensor activations): the plain composition on DTensors, the
  scan through ``local_map`` on each rank's heads.
- ``mamba2_full``, the training forward, on any device: the plain
  composition and the plain ``ssd_chunked``, as the reference does, so
  autograd differentiates it (the kernels are forward-only).
- ``mamba2_decode``: plain tensor code; O(1) per token, carrying (conv_state,
  ssm_state).
The SSD core (``segsum``, ``ssd_chunked``, ``ssd_sequential``) lives in
``repro_torch.kernels.ssd_scan.ref`` and the mixer's elementwise steps in
``repro_torch.kernels.ssm_prefill.ref``; both are re-exported or used here.

The reference's rounding points are kept, on every path: each conv product
and partial sum, ``+ b`` and the SiLU in the model dtype, ``xdt = xh * dt``
in the model dtype, f32 ``softplus`` and ``dA``, the f32 decode recurrence,
``y`` cast to the model dtype before the ``D`` skip, the gate in the model
dtype and the norm in f32. Unlike the reference's pure functions, decode and
prefill update the cache in place (and return it): ``DecoderLM`` hands each
layer views into its stacked cache.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import segsum, ssd_chunked, ssd_sequential
from repro_torch.kernels.ssm_prefill import ops as prefill_ops
from repro_torch.kernels.ssm_prefill import ref as prefill_ref

from .common import (ModelConfig, _full, _normal, conv_silu, dense_apply, dense_init, rmsnorm_apply,
                     rmsnorm_init)
from .sharded import is_dtensor, on_local_shards

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


def _projections(p: dict, x: torch.Tensor):
    """(z, x, B, C, dt_raw): the mixer's five input projections."""
    return tuple(dense_apply(p[k], x) for k in ("w_z", "w_x", "w_B", "w_C", "w_dt"))


def _project_in(p: dict, cfg: ModelConfig, x: torch.Tensor):
    z, xs, Bp, Cp, dt_raw = _projections(p, x)
    return z, torch.cat([xs, Bp, Cp], dim=-1), dt_raw


def causal_conv1d(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along time. xBC: (B,S,C); w: (K,C)."""
    K, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    return conv_silu(pad, w, b, S)


def _ssd_inputs(p: dict, cfg: ModelConfig, conv_out: torch.Tensor, dt_raw: torch.Tensor):
    """conv output and raw dt → (xh, xdt, dA, Bm, Cm); Bm/Cm stay (B,S,N)
    views shared by every head."""
    d_inner, H, N = _dims(cfg)
    xs, Bm, Cm = conv_out.split([d_inner, N, N], dim=-1)
    xh, xdt, dA = prefill_ref.ssd_inputs(xs, dt_raw, p["dt_bias"], p["A_log"], cfg.ssm_head_dim)
    return xh, xdt, dA, Bm, Cm


def _gated_out(p: dict, cfg: ModelConfig, ops, y, xh, z):
    """out_proj(ops.prefill_out(y, xh, z)): the D skip, the SiLU gate and the
    norm, through ``ops`` (``prefill_ref`` or ``prefill_ops``)."""
    y = ops.prefill_out(y, xh, z, p["D"], p["norm"]["scale"], cfg.norm_eps)
    return dense_apply(p["out_proj"], y)


def mamba2_full(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    z, xBC, dt_raw = _project_in(p, cfg, x)
    xBC = causal_conv1d(xBC, p["conv_w"], p["conv_b"])
    xh, xdt, dA, Bm, Cm = _ssd_inputs(p, cfg, xBC, dt_raw)
    y = on_local_shards(_ssd_plain, (xdt, dA, Bm, Cm), heads=(2, 2, None, None),
                        chunk=cfg.ssm_chunk)
    return _gated_out(p, cfg, prefill_ref, y, xh, z)


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
    becomes the trailing (ssm_conv-1) raw xBC rows. Off a mesh the
    elementwise work runs through ``kernels.ssm_prefill``'s ops (the kernels
    on the card, their plain composition on the CPU); on a mesh the plain
    composition runs on DTensors."""
    z, xs, Bp, Cp, dt_raw = _projections(p, x)
    ops = prefill_ref if is_dtensor(xs) else prefill_ops
    xh, xdt, dA, Bm, Cm = ops.prefill_in(xs, Bp, Cp, dt_raw, cache["conv"], p["conv_w"],
                                         p["conv_b"], p["dt_bias"], p["A_log"],
                                         head_dim=cfg.ssm_head_dim)
    y, _ = on_local_shards(_ssd_in_place, (xdt, dA, Bm, Cm, cache["ssm"]),
                           heads=(2, 2, None, None, 1), out_like=(0, 4), chunk=cfg.ssm_chunk)
    return _gated_out(p, cfg, ops, y, xh, z), cache
