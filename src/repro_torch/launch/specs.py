"""Assigned input shapes, and meta-tensor stand-ins for every step's inputs —
the port of ``repro.launch.specs``.

Shapes:
    train_4k     seq=4096    global_batch=256   (training     → train_step)
    prefill_32k  seq=32768   global_batch=32    (inference    → prefill_step)
    decode_32k   seq=32768   global_batch=128   (decode       → serve_step)
    long_500k    seq=524288  global_batch=1     (long decode  → serve_step)

Carve-outs, as in the reference:
  * vlm: the ``frontend_tokens`` stub patch embeddings count against the
    token budget (text = seq − frontend_tokens); decode shapes are pure text
    continuation.
  * audio enc-dec: the seq budget is split 50/50 into encoder frames and
    decoder tokens; decode caches a fixed ``AUDIO_DECODE_FRAMES``-frame
    encoder memory.
  * long_500k: SSM/hybrid archs run natively; attention archs decode with a
    sliding window of ``cfg.long_context_window``.

Every spec is a tensor on the ``meta`` device: shapes and dtypes, no memory,
at any size (grok-1-314b included). Where the reference traces with
``jax.eval_shape``, the port runs the same code on meta tensors.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models import ModelConfig, build_model


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

AUDIO_DECODE_FRAMES = 4096  # bounded encoder memory for decode shapes


def _meta(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def decode_window_override(cfg: ModelConfig, shape: InputShape) -> int | None:
    """Sliding-window override for long-context decode on attention archs."""
    if shape.name != "long_500k":
        return None
    if cfg.arch_type == "ssm" or cfg.sliding_window:
        return None  # natively sub-quadratic / already windowed
    if cfg.attention == "none":
        return None
    return cfg.long_context_window


def input_specs(cfg: ModelConfig, shape: InputShape, *,
                batch_override: int | None = None) -> dict:
    """Meta tensors standing in for the step's data inputs (no params)."""
    B = batch_override or shape.global_batch
    S = shape.seq_len
    i32, f = torch.int32, cfg.torch_dtype

    if shape.kind in ("train", "prefill"):
        if cfg.is_encdec:
            s2 = S // 2
            specs = {"frames": _meta((B, s2, cfg.d_model), f), "tokens": _meta((B, s2), i32)}
            if shape.kind == "train":
                specs["labels"] = _meta((B, s2), i32)
            return specs
        specs = {}
        s_text = S
        if cfg.frontend == "vision":
            s_text = S - cfg.frontend_tokens
            specs["embeds"] = _meta((B, cfg.frontend_tokens, cfg.d_model), f)
        specs["tokens"] = _meta((B, s_text), i32)
        if shape.kind == "train":
            specs["labels"] = _meta((B, s_text), i32)
        return specs

    # decode: one token against a seq_len-deep cache
    return {"token": _meta((B,), i32), "pos": _meta((), i32)}


def cache_specs(cfg: ModelConfig, shape: InputShape, params_shapes: dict | None = None, *,
                batch_override: int | None = None) -> dict:
    """The decode cache as meta tensors: ``init_cache`` on the meta device.
    An enc-dec's is encoded from meta frames of ``AUDIO_DECODE_FRAMES`` over
    ``params_shapes`` (``params_specs(cfg)`` when not given)."""
    B = batch_override or shape.global_batch
    model = build_model(cfg)
    wo = decode_window_override(cfg, shape)
    if cfg.is_encdec:
        params = params_shapes if params_shapes is not None else params_specs(cfg)
        frames = _meta((B, AUDIO_DECODE_FRAMES, cfg.d_model), cfg.torch_dtype)
        with torch.inference_mode():
            return model.init_cache(params, frames, capacity=shape.seq_len, window_override=wo)
    return model.init_cache(B, capacity=shape.seq_len, window_override=wo, device="meta")


def params_specs(cfg: ModelConfig) -> dict:
    """The parameter tree as meta tensors."""
    return build_model(cfg).abstract()
