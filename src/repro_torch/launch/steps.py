"""Step builders — the port of ``repro.launch.steps``: ``make_train_step``
(one optimizer step, optionally over micro-batches), the cache-less
``make_prefill_step`` probe, the serving steps ``make_bulk_prefill_step``
and ``make_serve_step``, and ``DecodeGraph``: one serve step captured as a
CUDA graph, for the models whose step reads no host position
(``decode_graphable``).

Plain functions on tensors, or on DTensors placed on a mesh (then under
``implicit_replication``, ``models.sharded``). The train step updates the
parameter and moment tensors in place (and returns them); its forward takes
the plain attention and SSD paths, which autograd differentiates. The serving
steps run under ``torch.inference_mode()`` (``no_grad`` on a mesh) through
the forward kernels; the caches they take are updated in place (and
returned, as the reference's are).
"""
from __future__ import annotations

import threading
from typing import Callable

import torch

from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models import ModelConfig, build_model
from repro_torch.models.sharded import mesh_mode, serving_mode, split_dim, unshard
from repro_torch.optim import Optimizer, adafactor, adamw, apply_updates
from repro_torch.training.trainer import value_and_grad

# Models whose optimizer-moment memory would not fit with full Adam on the
# production mesh use factored moments (Adafactor).
ADAFACTOR_THRESHOLD = 50_000_000_000

# torch captures one CUDA graph at a time in a process
_CAPTURE_LOCK = threading.Lock()


def default_optimizer(cfg: ModelConfig, approx_params: int | None = None) -> Optimizer:
    if approx_params is not None and approx_params >= ADAFACTOR_THRESHOLD:
        return adafactor(1e-4)
    if cfg.name.startswith("grok-1"):
        return adafactor(1e-4)
    return adamw(2e-5)


def make_train_step(cfg: ModelConfig, optimizer: Optimizer, *, remat: bool = True,
                    microbatches: int = 1) -> Callable:
    """(params, opt_state, batch) → (params, opt_state, metrics): one
    optimizer step. ``microbatches`` > 1 runs the global batch in
    micro-slices, accumulating the gradients in f32 divided by
    ``microbatches`` in slice order (the reference's ``lax.scan``); the loss
    and metrics are the slices' means."""
    model = build_model(cfg)

    def loss_fn(params, batch):
        return model.loss(params, batch, remat=remat)

    def train_step(params, opt_state, batch):
        with mesh_mode(params):
            return _train_step(params, opt_state, batch)

    def _train_step(params, opt_state, batch):
        if microbatches == 1:
            (loss, metrics), grads = value_and_grad(loss_fn, params, batch)
        else:
            micro = {k: split_dim(v, 0, (microbatches, v.shape[0] // microbatches))
                     for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            losses, metricses = [], []
            for i in range(microbatches):
                (loss_i, metrics_i), g = value_and_grad(
                    loss_fn, params, {k: v[i] for k, v in micro.items()})
                tree_map(lambda a, gi: a.add_(gi.float() / microbatches), grads, g)
                losses.append(loss_i)
                metricses.append(metrics_i)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in metricses]).mean() for k in metricses[0]}
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        return params, opt_state, {"loss": loss, **metrics}

    return train_step


def _greedy(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the valid vocab (on a mesh, gathered first: DTensor's
    argmax over a sharded dim needs the rank's offset on the host)."""
    return unshard(logits, -1)[:, : cfg.vocab_size].argmax(dim=-1).to(torch.int32)


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """(params, batch) → (next token (B,) int32, last position's logits): the
    cache-less full forward (``apply``, plain attention), over ``tokens`` and
    the enc-dec's ``frames`` or a VLM's ``embeds``."""
    model = build_model(cfg)

    def prefill_step(params, batch):
        with serving_mode(params):
            if cfg.is_encdec:
                logits, _ = model.apply(params, batch["tokens"], batch["frames"])
            else:
                logits, _ = model.apply(params, batch["tokens"], batch.get("embeds"))
            return _greedy(cfg, logits[:, -1]), logits[:, -1]

    return prefill_step


def make_bulk_prefill_step(cfg: ModelConfig, *, window_override: int | None = None) -> Callable:
    """Cache-filling bulk prefill for serving: one full-sequence pass fills a
    fresh decode cache (``model.prefill``) and returns the greedy next token.
    ``extra_embeds`` is a decoder's prefix; an enc-dec's cache already holds
    its encoded memory."""
    model = build_model(cfg)

    def bulk_prefill_step(params, tokens, cache, extra_embeds=None):
        with serving_mode(params):
            if cfg.is_encdec:
                logits, cache = model.prefill(params, tokens, cache,
                                              window_override=window_override)
            else:
                logits, cache = model.prefill(params, tokens, cache, extra_embeds,
                                              window_override=window_override)
            return _greedy(cfg, logits), cache

    return bulk_prefill_step


def make_serve_step(cfg: ModelConfig, *, window_override: int | None = None) -> Callable:
    model = build_model(cfg)

    def serve_step(params, token, cache, pos):
        with serving_mode(params):
            logits, cache = model.decode_step(params, token, cache, pos,
                                              window_override=window_override)
            return _greedy(cfg, logits), cache

    return serve_step


def decode_graphable(model, device: torch.device, mesh=None) -> bool:
    """Whether ``model``'s serve step can be replayed from a CUDA graph: on
    one card, off a mesh, and with every block ``ssm``, whose decode carries
    a cache of fixed shape and reads no host position. A hybrid with
    attention layers (granite-4.0-h) decodes eagerly: its ring write and
    mask read the host position."""
    return (device.type == "cuda" and mesh is None
            and all(kind == "ssm" for kind in (*model.pattern, *model.tail)))


class DecodeGraph:
    """One ``make_serve_step`` step of ``batch`` tokens on ``params``,
    captured as a CUDA graph over static buffers: the input token (B,)
    int32, a cache shaped as ``model.init_cache(batch)`` and the step's
    output token. The graph reads the leaves of ``params`` where they lie, so
    weights written in place are seen by the next replay; its last op copies
    the output token into the input token, so replays chain with no host
    work. Only for a model that ``decode_graphable`` admits.

    The capture warms the step up once on a side stream (on the static
    cache, not yet a batch's), then records it there in ``thread_local``
    mode, so that other threads may synchronize or allocate meanwhile."""

    def __init__(self, serve_step: Callable, params, model, batch: int, device: torch.device):
        self.device = device
        self.token = torch.zeros(batch, dtype=torch.int32, device=device)
        self.cache = model.init_cache(batch, capacity=1, device=device)
        self.graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream(device)
        with _CAPTURE_LOCK, torch.cuda.device(device):
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                serve_step(params, self.token, self.cache, 0)
            torch.cuda.current_stream(device).wait_stream(stream)
            with torch.cuda.graph(self.graph, stream=stream, capture_error_mode="thread_local"):
                out, _ = serve_step(params, self.token, self.cache, 0)
                self.token.copy_(out)

    def load(self, token: torch.Tensor, cache) -> None:
        """Set the static token and cache to a batch's (device copies)."""
        self.token.copy_(token)
        for dst, src in zip(tree_leaves(self.cache), tree_leaves(cache)):
            dst.copy_(src)

    def replay(self) -> torch.Tensor:
        """One step: the static cache advanced in place; → the static token,
        now the step's output (clone it before the next replay)."""
        with torch.cuda.device(self.device):
            self.graph.replay()
        return self.token
