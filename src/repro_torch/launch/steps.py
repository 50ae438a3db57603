"""The serving steps — the port of ``make_bulk_prefill_step`` and
``make_serve_step`` of ``repro.launch.steps``.

Plain functions on tensors, run under ``torch.inference_mode()``; the caches
they take are updated in place (and returned, as the reference's are).
Training steps come with LM training (ROADMAP Queue 1, item 16).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import ModelConfig, build_model


def make_bulk_prefill_step(cfg: ModelConfig, *, window_override: int | None = None) -> Callable:
    """Cache-filling bulk prefill for serving: one full-sequence pass fills a
    fresh decode cache (``model.prefill``) and returns the greedy next token."""
    model = build_model(cfg)

    @torch.inference_mode()
    def bulk_prefill_step(params, tokens, cache, extra_embeds=None):
        logits, cache = model.prefill(params, tokens, cache, extra_embeds,
                                      window_override=window_override)
        return logits[:, : cfg.vocab_size].argmax(dim=-1).to(torch.int32), cache

    return bulk_prefill_step


def make_serve_step(cfg: ModelConfig, *, window_override: int | None = None) -> Callable:
    model = build_model(cfg)

    @torch.inference_mode()
    def serve_step(params, token, cache, pos):
        logits, cache = model.decode_step(params, token, cache, pos,
                                          window_override=window_override)
        return logits[:, : cfg.vocab_size].argmax(dim=-1).to(torch.int32), cache

    return serve_step
