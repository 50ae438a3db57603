"""Encoder-decoder transformer (seamless-m4t-medium backbone, arXiv:2308.11596)
— the port of ``repro.models.encdec``.

The speech frontend (mel-spectrogram + conv feature extractor) is a stub:
the encoder consumes precomputed frame embeddings (B, T, d_model)
(``models.frontends.stub_audio_frames``). The encoder's self-attention is
bidirectional plain attention (the reference's ``_sdpa`` with an all-true
mask: neither TPU kernel is non-causal). The decoder is a causal transformer
with cross-attention over the encoder memory. ``decode_step`` carries a
self-attention ring cache plus the per-layer cross-attention K/V of the
memory, computed once by ``init_cache``.

The parameter tree is the reference's, leaf for leaf: ``embed/table``,
``enc_layers/{norm1, attn, norm2, mlp}`` stacked over ``encoder_layers``,
``enc_norm``, ``dec_layers/{norm1, self_attn, norm_x, cross/{wq, wk, wv,
wo}, norm2, mlp}`` stacked over ``n_layers``, and ``final_norm``; so
``LeafSpec.key`` and the wire match. Where the reference scans over the
stacked axis, the port loops over the leaves' slices (views), so the
self-attention caches are updated in place, as in ``DecoderLM``.

The full forward (``apply``, ``loss``) is plain tensor code that autograd
differentiates. Serving's ``prefill`` runs the decoder's self-attention
through the ``flash_attention`` op and ``decode_step`` through the
``decode_attention`` op (the CUDA kernels on the card, their plain versions
on the CPU); cross-attention is plain, as in the reference.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from . import attention as attn_mod
from .sharded import merge_dims, on_local_shards, split_dim
from .common import (
    ModelConfig,
    dense_apply,
    dense_init,
    embedding_init,
    mlp_apply,
    mlp_init,
    rmsnorm_apply,
    rmsnorm_init,
    scaled_embedding,
    seeded_generator,
    softmax_cross_entropy,
    token_accuracy,
    unembed_apply,
    unstack,
)


def _init_cross_attn(gen, cfg: ModelConfig, lead: tuple = ()) -> dict:
    hd, dt = cfg.head_dim_, cfg.torch_dtype
    return {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * hd, dt, lead=lead),
        "wk": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dt, lead=lead),
        "wv": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dt, lead=lead),
        "wo": dense_init(gen, cfg.n_heads * hd, cfg.d_model, dt, lead=lead),
    }


def _cross_kv(p: dict, cfg: ModelConfig, memory: torch.Tensor):
    B, T, _ = memory.shape
    hd = cfg.head_dim_
    k = split_dim(dense_apply(p["wk"], memory), -1, (cfg.n_kv_heads, hd))
    v = split_dim(dense_apply(p["wv"], memory), -1, (cfg.n_kv_heads, hd))
    return k, v


def _cross_attend(p: dict, cfg: ModelConfig, x: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """Every query position against the whole memory: scores and softmax in
    f32, the context cast back to the activations' dtype."""
    hd = cfg.head_dim_
    G = cfg.n_heads // cfg.n_kv_heads
    qg = split_dim(dense_apply(p["wq"], x), -1, (cfg.n_kv_heads, G, hd))
    out = on_local_shards(_cross_softmax, (qg, k, v), heads=(2, 2, 2))
    return dense_apply(p["wo"], merge_dims(out, 2))


def _cross_softmax(qg, k, v) -> torch.Tensor:
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float()) / math.sqrt(qg.shape[-1])
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgst,btkh->bskgh", probs, v.float()).to(qg.dtype)


def _bidirectional(qg, k, v) -> torch.Tensor:
    """The reference's ``_sdpa`` with an all-true mask."""
    T = k.shape[1]
    return attn_mod._sdpa(qg, k, v, torch.ones((T, T), dtype=torch.bool, device=qg.device), 0.0)


def _enc_layer(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Pre-norm bidirectional self-attention (rope at positions 0…T−1) +
    pre-norm MLP."""
    T = x.shape[1]
    h = rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
    positions = torch.arange(T, device=x.device)[None, :]
    q, k, v = attn_mod._project_qkv(p["attn"], cfg, h, positions)
    qg = split_dim(q, 2, (cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads))
    out = on_local_shards(_bidirectional, (qg, k, v), heads=(2, 2, 2))
    x = x + dense_apply(p["attn"]["wo"], merge_dims(out, 2))
    h = rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h, cfg.activation)


def _dec_layer(p: dict, cfg: ModelConfig, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               self_attend) -> torch.Tensor:
    """Pre-norm causal self-attention (``self_attend(p, h)`` → its output),
    pre-norm cross-attention over the memory's k/v, pre-norm MLP."""
    x = x + self_attend(p["self_attn"], rmsnorm_apply(p["norm1"], x, cfg.norm_eps))
    x = x + _cross_attend(p["cross"], cfg, rmsnorm_apply(p["norm_x"], x, cfg.norm_eps), k, v)
    h = rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h, cfg.activation)


class EncDecLM:
    """Speech-to-text enc-dec; the encoder's input is stub frame embeddings."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    # -- init ----------------------------------------------------------------
    def _build(self, gen) -> dict:
        cfg = self.cfg
        dt, d = cfg.torch_dtype, cfg.d_model
        enc, dec = (cfg.encoder_layers,), (cfg.n_layers,)
        return {
            "embed": embedding_init(gen, cfg.padded_vocab, d, dt),
            "enc_layers": {
                "norm1": rmsnorm_init(gen, d, dt, lead=enc),
                "attn": attn_mod.init_attention(gen, cfg, lead=enc),
                "norm2": rmsnorm_init(gen, d, dt, lead=enc),
                "mlp": mlp_init(gen, cfg, lead=enc),
            },
            "enc_norm": rmsnorm_init(gen, d, dt),
            "dec_layers": {
                "norm1": rmsnorm_init(gen, d, dt, lead=dec),
                "self_attn": attn_mod.init_attention(gen, cfg, lead=dec),
                "norm_x": rmsnorm_init(gen, d, dt, lead=dec),
                "cross": _init_cross_attn(gen, cfg, lead=dec),
                "norm2": rmsnorm_init(gen, d, dt, lead=dec),
                "mlp": mlp_init(gen, cfg, lead=dec),
            },
            "final_norm": rmsnorm_init(gen, d, dt),
        }

    def init(self, rng: "int | torch.Generator" = 0, *,
             device: "str | torch.device" = "cuda") -> dict:
        """Random parameters drawn on ``device`` from a seed (or a generator
        on that device)."""
        return self._build(seeded_generator(rng, device))

    def abstract(self) -> dict:
        """The parameter tree as meta tensors: shapes and dtypes, no memory."""
        return self._build(None)

    # -- forward ---------------------------------------------------------------
    def encode(self, params, frames: torch.Tensor, *, remat: bool = False) -> torch.Tensor:
        """frames (B, T, D) stub embeddings → memory (B, T, D)."""
        cfg = self.cfg
        x = frames.to(cfg.torch_dtype)
        for p in unstack(params["enc_layers"], cfg.encoder_layers):
            if remat and torch.is_grad_enabled():
                x = checkpoint(_enc_layer, p, cfg, x, use_reentrant=False)
            else:
                x = _enc_layer(p, cfg, x)
        return rmsnorm_apply(params["enc_norm"], x, cfg.norm_eps)

    def _logits(self, params, x):
        x = rmsnorm_apply(params["final_norm"], x, self.cfg.norm_eps)
        return unembed_apply(params["embed"], x)

    def apply(self, params, tokens, frames, *, remat: bool = False):
        """Teacher-forced decode over the whole target sequence → (logits
        (B,S,padded_vocab), aux = 0). The decoder's self-attention is plain
        (``attn_full``), as the reference's default."""
        cfg = self.cfg
        memory = self.encode(params, frames, remat=remat)
        x = scaled_embedding(params["embed"], cfg, tokens)

        def self_attend(p, h):
            return attn_mod.attn_full(p, cfg, h)

        def layer(p, x):
            k, v = _cross_kv(p["cross"], cfg, memory)
            return _dec_layer(p, cfg, x, k, v, self_attend)

        for p in unstack(params["dec_layers"], cfg.n_layers):
            if remat and torch.is_grad_enabled():
                x = checkpoint(layer, p, x, use_reentrant=False)
            else:
                x = layer(p, x)
        return self._logits(params, x), torch.zeros((), dtype=torch.float32, device=x.device)

    def loss(self, params, batch, rng=None, *, remat: bool = False):
        """→ (loss, {"ce", "accuracy"}): mean token CE over the valid vocab."""
        logits, _ = self.apply(params, batch["tokens"], batch["frames"], remat=remat)
        ce = softmax_cross_entropy(logits, batch["labels"], valid_vocab=self.cfg.vocab_size).mean()
        return ce, {"ce": ce, "accuracy": token_accuracy(logits, batch["labels"])}

    # -- decode ----------------------------------------------------------------
    def init_cache(self, params, frames: torch.Tensor, capacity: int, *,
                   window_override: int | None = None) -> dict:
        """Encode ``frames`` once: the per-layer cross K/V of the memory,
        stacked (n_layers, B, T, KV, hd), and an empty stacked self-attention
        ring on the frames' device (its capacity the window where there is
        one)."""
        cfg = self.cfg
        memory = self.encode(params, frames)
        kv = [_cross_kv(p["cross"], cfg, memory) for p in unstack(params["dec_layers"], cfg.n_layers)]
        window = window_override if window_override is not None else cfg.sliding_window
        cap = min(capacity, window) if window else capacity
        return {"cross_k": torch.stack([k for k, _ in kv]), "cross_v": torch.stack([v for _, v in kv]),
                "self": attn_mod.init_attn_cache(cfg, frames.shape[0], cap, device=frames.device,
                                                 lead=(cfg.n_layers,))}

    def _decoder(self, params, x, cache, self_attend):
        cfg = self.cfg
        layers = zip(unstack(params["dec_layers"], cfg.n_layers),
                     unstack(cache["self"], cfg.n_layers), cache["cross_k"], cache["cross_v"])
        for p, c, k, v in layers:
            x = _dec_layer(p, cfg, x, k, v, lambda pa, h: self_attend(pa, h, c))
        return x

    def decode_step(self, params, token, cache, pos, *, window_override: int | None = None):
        """token: (B,) int; pos: the position (host int) → (logits
        (B,padded_vocab), cache). The self-attention ring is updated in place."""
        x = scaled_embedding(params["embed"], self.cfg, token[:, None])
        x = self._decoder(params, x, cache, lambda p, h, c: attn_mod.attn_decode(
            p, self.cfg, h, c, pos, window=window_override)[0])
        return self._logits(params, x[:, 0]), cache

    def prefill(self, params, tokens, cache, *, window_override: int | None = None):
        """Bulk decoder prefill against the encoded memory: one full-sequence
        pass fills a fresh self-attention ring (``init_cache``) in place →
        (last position's logits (B, padded_vocab), cache)."""
        x = scaled_embedding(params["embed"], self.cfg, tokens)
        x = self._decoder(params, x, cache, lambda p, h, c: attn_mod.attn_prefill(
            p, self.cfg, h, c, window=window_override)[0])
        return self._logits(params, x[:, -1]), cache
