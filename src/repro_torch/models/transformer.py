"""Decoder-only LM assembly — the port of ``repro.models.transformer``.

Block kinds, as in the reference:
  attn      — pre-norm attention (GQA or MLA) + pre-norm MLP
  moe_attn  — pre-norm GQA attention + pre-norm MoE (aux loss accumulated)
  ssm       — pre-norm Mamba2 SSD block (no separate MLP)
  rglru     — pre-norm RG-LRU recurrent block + pre-norm MLP
  ssm_mlp   — pre-norm Mamba2 SSD block + pre-norm MLP (the port's own kind,
              for granite-4.0-h's Mamba2 layers; the reference has none)

The parameter tree is the reference's, leaf for leaf: ``embed/table``,
``blocks/u<u>_<kind>/...`` with a leading group axis over the stacked layers,
``tail/t<i>_<kind>/...`` for a remainder, ``final_norm``, and ``unembed`` when
embeddings are untied. So ``LeafSpec.key`` and the wire match, and a JAX
node's weights deploy in the port. Where the reference scans over the group
axis, the port loops in Python over the stacked leaves' slices (views).

``loss`` is the reference's training loss (mean token CE over the valid
vocab, plus ``router_aux_weight`` times the MoE blocks' summed load-balance
loss). The full forward (``apply``, ``loss``) is plain tensor code that
autograd differentiates, as the port's CUDA kernels are forward-only: GQA
attention takes the flash kernel only with ``use_flash=True`` (the
reference's switch, off by default), ``ssm`` blocks always run the plain
``ssd_chunked``, as in the reference, and MLA, RG-LRU and MoE have no kernel
in either package. Serving's ``prefill`` and ``decode_step`` run the kernels
of GQA attention (``attn`` and ``moe_attn`` blocks) and of ``ssm`` and
``ssm_mlp`` blocks; a hybrid's decode cache holds each attention layer's ring
beside each Mamba2 layer's conv window and state.
``remat=True`` recomputes each layer group in the backward
(``torch.utils.checkpoint``, where the reference has ``jax.checkpoint``).
``remat_policy="dots"`` saves the outputs of ``aten.mm`` and ``aten.addmm``
(the projections and MLPs: products with no batch dim) and recomputes the
rest, ``bmm`` (the batched attention products) included — the counterpart of
the reference's ``dots_with_no_batch_dims_saveable``, through
``create_selective_checkpoint_contexts``; any other policy recomputes the
whole group, as the reference's does.

Granite 4.0's multipliers (``ModelConfig``): ``embedding_multiplier`` in
place of sqrt(d_model) on the token embeddings, ``residual_multiplier`` on
every mixer and MLP output before it joins the residual, ``logits_scaling``
dividing the logits; each is skipped at its default, so every other model
computes what it did.

A VLM prefix (``extra_embeds``: stub patch embeddings, ``models.frontends``)
is concatenated in front of the scaled token embeddings and occupies
positions 0…P−1; ``apply`` returns the logits of the text positions only.
Encoder-decoders are ``models.encdec.EncDecLM``.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from repro_torch.kernels import resolve_device

from . import attention as attn_mod
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import ssm as ssm_mod
from .sharded import replicated
from .common import (
    ModelConfig,
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


_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


_save_dots = functools.partial(create_selective_checkpoint_contexts, _dots_policy)


def _init_block(gen, cfg: ModelConfig, kind: str, lead: tuple = ()) -> dict:
    dt = cfg.torch_dtype
    if kind == "attn":
        attn_init = attn_mod.init_mla if cfg.attention == "mla" else attn_mod.init_attention
        return {
            "norm1": rmsnorm_init(gen, cfg.d_model, dt, lead=lead),
            "attn": attn_init(gen, cfg, lead=lead),
            "norm2": rmsnorm_init(gen, cfg.d_model, dt, lead=lead),
            "mlp": mlp_init(gen, cfg, lead=lead),
        }
    if kind == "moe_attn":
        return {
            "norm1": rmsnorm_init(gen, cfg.d_model, dt, lead=lead),
            "attn": attn_mod.init_attention(gen, cfg, lead=lead),
            "norm2": rmsnorm_init(gen, cfg.d_model, dt, lead=lead),
            "moe": moe_mod.init_moe(gen, cfg, lead=lead),
        }
    if kind == "ssm":
        return {
            "norm1": rmsnorm_init(gen, cfg.d_model, dt, lead=lead),
            "ssm": ssm_mod.init_mamba2(gen, cfg, lead=lead),
        }
    if kind == "ssm_mlp":
        return {
            "norm1": rmsnorm_init(gen, cfg.d_model, dt, lead=lead),
            "ssm": ssm_mod.init_mamba2(gen, cfg, lead=lead),
            "norm2": rmsnorm_init(gen, cfg.d_model, dt, lead=lead),
            "mlp": mlp_init(gen, cfg, lead=lead),
        }
    if kind == "rglru":
        return {
            "norm1": rmsnorm_init(gen, cfg.d_model, dt, lead=lead),
            "rglru": rglru_mod.init_rglru(gen, cfg, lead=lead),
            "norm2": rmsnorm_init(gen, cfg.d_model, dt, lead=lead),
            "mlp": mlp_init(gen, cfg, lead=lead),
        }
    raise ValueError(f"unknown block kind {kind!r}")


def _is_mla(cfg: ModelConfig, kind: str) -> bool:
    return cfg.attention == "mla" and kind == "attn"


def _residual(cfg: ModelConfig, x, out):
    """x + out, the branch scaled by ``residual_multiplier`` where it is set."""
    if cfg.residual_multiplier != 1.0:
        out = out * cfg.residual_multiplier
    return x + out


def _ffn(p, cfg: ModelConfig, kind: str, x):
    """The second half of an attention, RG-LRU or ``ssm_mlp`` block: pre-norm
    MLP, or MoE for ``moe_attn`` → (x, aux)."""
    h = rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
    if kind == "moe_attn":
        out, aux = replicated(moe_mod.moe_apply)(p["moe"], cfg, h)
        return _residual(cfg, x, out), aux
    return _residual(cfg, x, mlp_apply(p["mlp"], h, cfg.activation)), None


def _apply_block_full(p, cfg: ModelConfig, kind: str, x, *, window_override=None,
                      use_flash=False):
    """Full-sequence forward → (x, aux); aux is None for blocks without MoE."""
    h = rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
    if kind in ("ssm", "ssm_mlp"):
        a = ssm_mod.mamba2_full(p["ssm"], cfg, h)
    elif kind == "rglru":
        a = rglru_mod.rglru_full(p["rglru"], cfg, h)
    elif _is_mla(cfg, kind):
        a = attn_mod.mla_full(p["attn"], cfg, h, window=window_override)
    else:
        a = attn_mod.attn_full(p["attn"], cfg, h, window=window_override, use_flash=use_flash)
    x = _residual(cfg, x, a)
    return (x, None) if kind == "ssm" else _ffn(p, cfg, kind, x)


def _apply_block_decode(p, cfg: ModelConfig, kind: str, x, cache, pos, *, window_override=None):
    h = rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
    if kind in ("ssm", "ssm_mlp"):
        a, cache = ssm_mod.mamba2_decode(p["ssm"], cfg, h, cache)
    elif kind == "rglru":
        a, cache = rglru_mod.rglru_decode(p["rglru"], cfg, h, cache)
    elif _is_mla(cfg, kind):
        a, cache = attn_mod.mla_decode(p["attn"], cfg, h, cache, pos, window=window_override,
                                       absorb=cfg.mla_absorb)
    else:
        a, cache = attn_mod.attn_decode(p["attn"], cfg, h, cache, pos, window=window_override)
    x = _residual(cfg, x, a)
    return (x if kind == "ssm" else _ffn(p, cfg, kind, x)[0]), cache


def _apply_block_prefill(p, cfg: ModelConfig, kind: str, x, cache, *, window_override=None):
    h = rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
    if kind in ("ssm", "ssm_mlp"):
        a, cache = ssm_mod.mamba2_prefill(p["ssm"], cfg, h, cache)
    elif kind == "rglru":
        a, cache = rglru_mod.rglru_prefill(p["rglru"], cfg, h, cache)
    elif _is_mla(cfg, kind):
        a, cache = attn_mod.mla_prefill(p["attn"], cfg, h, cache, window=window_override)
    else:
        a, cache = attn_mod.attn_prefill(p["attn"], cfg, h, cache, window=window_override)
    x = _residual(cfg, x, a)
    return (x if kind == "ssm" else _ffn(p, cfg, kind, x)[0]), cache


def _init_block_cache(cfg: ModelConfig, kind: str, batch: int, capacity: int, *,
                      device, lead: tuple = ()) -> dict:
    """An attention block's ring cache (GQA k/v, or MLA's latent c_kv and rope
    key), an ``ssm`` or ``ssm_mlp`` block's conv window and f32 state, or an
    ``rglru`` block's conv window and f32 h."""
    if kind in ("ssm", "ssm_mlp"):
        return ssm_mod.init_ssm_cache(cfg, batch, device=device, lead=lead)
    if kind == "rglru":
        return rglru_mod.init_rglru_cache(cfg, batch, device=device, lead=lead)
    init = attn_mod.init_mla_cache if _is_mla(cfg, kind) else attn_mod.init_attn_cache
    return init(cfg, batch, _cache_capacity(cfg, capacity), device=device, lead=lead)


def _cache_capacity(cfg: ModelConfig, capacity: int) -> int:
    window = cfg.sliding_window
    return min(capacity, window) if window else capacity


class DecoderLM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.pattern = cfg.pattern
        U = len(self.pattern)
        self.n_groups = cfg.n_layers // U
        self.tail = tuple(self.pattern[: cfg.n_layers % U])

    # -- init ----------------------------------------------------------------
    def _build(self, gen) -> dict:
        cfg = self.cfg
        params = {"embed": embedding_init(gen, cfg.padded_vocab, cfg.d_model, cfg.torch_dtype)}
        params["blocks"] = {f"u{u}_{kind}": _init_block(gen, cfg, kind, lead=(self.n_groups,))
                            for u, kind in enumerate(self.pattern)}
        if self.tail:
            params["tail"] = {f"t{i}_{kind}": _init_block(gen, cfg, kind)
                              for i, kind in enumerate(self.tail)}
        params["final_norm"] = rmsnorm_init(gen, cfg.d_model, cfg.torch_dtype)
        if not cfg.tie_embeddings:
            params["unembed"] = embedding_init(gen, cfg.padded_vocab, cfg.d_model,
                                               cfg.torch_dtype)
        return params

    def init(self, rng: "int | torch.Generator" = 0, *,
             device: "str | torch.device" = "cuda") -> dict:
        """Random parameters drawn on ``device`` from a seed (or a generator
        on that device)."""
        return self._build(seeded_generator(rng, device))

    def abstract(self) -> dict:
        """The parameter tree as meta tensors: shapes and dtypes, no memory."""
        return self._build(None)

    # -- layer iteration ----------------------------------------------------------
    def _per_group(self, stacked: dict) -> list[dict]:
        """Per-group views of a stacked tree ({key: leaves with a leading
        group axis}, a ``tail`` entry aside)."""
        return unstack({key: sub for key, sub in stacked.items() if key != "tail"}, self.n_groups)

    def _layers(self, params: dict, cache: dict | None = None):
        """(kind, block params, block cache) per layer, in order. Stacked groups
        give views into their leaves' slices, so in-place cache writes land
        in the stacked cache."""
        p_views = self._per_group(params["blocks"])
        c_views = None if cache is None else self._per_group(cache)
        for g in range(self.n_groups):
            for u, kind in enumerate(self.pattern):
                key = f"u{u}_{kind}"
                yield kind, p_views[g][key], None if cache is None else c_views[g][key]
        for i, kind in enumerate(self.tail):
            key = f"t{i}_{kind}"
            yield kind, params["tail"][key], None if cache is None else cache["tail"][key]

    def _embed(self, params, tokens, extra_embeds=None):
        x = scaled_embedding(params["embed"], self.cfg, tokens)
        if extra_embeds is not None:
            # VLM / audio-LM: prepend the stub modality embeddings
            x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
        return x

    def _logits(self, params, x):
        x = rmsnorm_apply(params["final_norm"], x, self.cfg.norm_eps)
        logits = unembed_apply(params.get("unembed", params["embed"]), x)
        if self.cfg.logits_scaling != 1.0:
            logits = logits / self.cfg.logits_scaling
        return logits

    # -- full forward ----------------------------------------------------------
    def _group_full(self, group: dict, x, aux, window_override, use_flash):
        for u, kind in enumerate(self.pattern):
            x, a = _apply_block_full(group[f"u{u}_{kind}"], self.cfg, kind, x,
                                     window_override=window_override, use_flash=use_flash)
            if a is not None:
                aux = aux + a
        return x, aux

    def apply(self, params, tokens, extra_embeds=None, *, window_override=None,
              remat: bool = False, use_flash: bool = False):
        """→ (logits (B,S_text,padded_vocab), aux_loss): with ``extra_embeds``
        (B,P,D) in front, only the S_text token positions produce logits."""
        context_fn = _save_dots if self.cfg.remat_policy == "dots" else noop_context_fn
        x = self._embed(params, tokens, extra_embeds)
        n_text = tokens.shape[1]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for group in self._per_group(params["blocks"]):
            if remat and torch.is_grad_enabled():
                x, aux = checkpoint(self._group_full, group, x, aux, window_override, use_flash,
                                    use_reentrant=False, context_fn=context_fn)
            else:
                x, aux = self._group_full(group, x, aux, window_override, use_flash)
        for i, kind in enumerate(self.tail):
            x, a = _apply_block_full(params["tail"][f"t{i}_{kind}"], self.cfg, kind, x,
                                     window_override=window_override, use_flash=use_flash)
            if a is not None:
                aux = aux + a
        return self._logits(params, x[:, -n_text:]), aux

    # -- loss -------------------------------------------------------------------
    def loss(self, params, batch, rng=None, *, remat: bool = False, use_flash: bool = False):
        """→ (loss, {"ce", "aux", "accuracy"}): mean token CE over the valid
        vocab plus ``router_aux_weight`` times the MoE blocks' summed
        load-balance loss, as the reference computes it."""
        cfg = self.cfg
        labels = batch["labels"]
        logits, aux = self.apply(params, batch["tokens"], batch.get("embeds"), remat=remat,
                                 use_flash=use_flash)
        ce = softmax_cross_entropy(logits, labels, valid_vocab=cfg.vocab_size).mean()
        loss = ce + cfg.router_aux_weight * aux
        return loss, {"ce": ce, "aux": aux, "accuracy": token_accuracy(logits, labels)}

    # -- decode -------------------------------------------------------------------
    def init_cache(self, batch: int, capacity: int, *, window_override=None,
                   device: "str | torch.device" = "cuda") -> dict:
        cfg = self.cfg if window_override is None else self.cfg.replace(
            sliding_window=window_override)
        dev = resolve_device(device)
        caches = {f"u{u}_{kind}": _init_block_cache(cfg, kind, batch, capacity, device=dev,
                                                    lead=(self.n_groups,))
                  for u, kind in enumerate(self.pattern)}
        if self.tail:
            caches["tail"] = {f"t{i}_{kind}": _init_block_cache(cfg, kind, batch, capacity,
                                                                device=dev)
                              for i, kind in enumerate(self.tail)}
        return caches

    def decode_step(self, params, token, cache, pos, *, window_override=None):
        """token: (B,) int; pos: the position (host int) → (logits
        (B,padded_vocab), cache). The cache is updated in place."""
        x = self._embed(params, token[:, None])
        for kind, p, c in self._layers(params, cache):
            x, _ = _apply_block_decode(p, self.cfg, kind, x, c, pos,
                                       window_override=window_override)
        return self._logits(params, x[:, 0]), cache

    def prefill(self, params, tokens, cache, extra_embeds=None, *, window_override=None):
        """Bulk prefill: one full-sequence pass that fills a *fresh* decode
        cache (``init_cache``) in place and returns the last position's
        logits. Positions start at 0: a prefix (``extra_embeds``, P positions)
        fills 0…P−1 and the prompt P…P+S−1 (an ``ssm`` block seeds its scan
        from the cache's state, zeros when fresh). → (logits (B,
        padded_vocab), cache)."""
        x = self._embed(params, tokens, extra_embeds)
        for kind, p, c in self._layers(params, cache):
            x, _ = _apply_block_prefill(p, self.cfg, kind, x, c, window_override=window_override)
        return self._logits(params, x[:, -1]), cache
