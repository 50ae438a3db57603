"""Modality frontend stubs — the port of ``repro.models.frontends``.

The [vlm] and [audio] architectures specify the transformer backbone only;
the ViT / conv-codec frontends are stubbed: ``repro_torch.launch.specs``
gives the shapes of the precomputed patch / frame embeddings, and these
helpers draw concrete ones for smoke runs and examples: N(0, 1) · 0.02 drawn
in f32, cast to the model's dtype, then scaled, as the reference does.

The draws come from a ``torch.Generator`` and cannot equal ``jax.random``'s,
so the parity tests hand both packages the same numpy arrays instead.
"""
from __future__ import annotations

import torch

from .common import ModelConfig, seeded_generator


def _stub(rng, cfg: ModelConfig, shape: tuple, device) -> torch.Tensor:
    gen = seeded_generator(rng, device)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return x.to(cfg.torch_dtype) * 0.02


def stub_patch_embeddings(rng: "int | torch.Generator", cfg: ModelConfig, batch: int, *,
                          device: "str | torch.device" = "cuda") -> torch.Tensor:
    """(B, frontend_tokens, d_model) — stands in for InternViT + MLP projector.
    ``rng`` is a seed (drawn on ``device``) or a generator (drawn on its own
    device)."""
    return _stub(rng, cfg, (batch, cfg.frontend_tokens, cfg.d_model), device)


def stub_audio_frames(rng: "int | torch.Generator", cfg: ModelConfig, batch: int,
                      n_frames: int | None = None, *,
                      device: "str | torch.device" = "cuda") -> torch.Tensor:
    """(B, n_frames, d_model), ``frontend_tokens`` frames by default — stands
    in for the mel-spectrogram + conv feature extractor."""
    return _stub(rng, cfg, (batch, n_frames or cfg.frontend_tokens, cfg.d_model), device)
