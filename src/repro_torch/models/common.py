"""Shared model config + primitive layers — the port of ``repro.models.common``.

``ModelConfig`` carries the reference's fields unchanged (so the configs and
their ``reduced()`` variants are the same data), with ``torch_dtype`` in place
of ``jdtype``. The layers are plain functions on tensors. Weights keep JAX's
``(d_in, d_out)`` layout, so leaf shapes, ``LeafSpec.key`` and the wire match
the reference. Init draws from an explicit ``torch.Generator`` (the numbers
differ from ``jax.random``'s; parity tests hand both packages numpy inputs).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.tree import (LeafSpec, PyTree, as_tensor, tree_flatten_with_path,
                                   tree_leaves, tree_unflatten)
from repro_torch.core.tree import torch_dtype as _torch_dtype
from repro_torch.kernels import resolve_device
from repro_torch.models.sharded import fsdp_gather, reduce_partial, unshard


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    arch_type: str = "dense"  # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""          # citation (paper / model card)

    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0          # 0 → d_model // n_heads
    d_ff: int = 512
    vocab_size: int = 1024

    # attention features
    attention: str = "gqa"     # gqa | mla | none
    lora_rank: int = 0         # >0 → LoRA adapter on the q projection
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0    # 0 → full causal; >0 → local attention window
    attn_logit_softcap: float = 0.0
    attn_qblock: int = 256
    attn_probs_bf16: bool = False
    position_embedding: str = "rope"  # rope | nope (no position signal in q/k)

    # multipliers (Granite 4.0); each default leaves the model as it was
    embedding_multiplier: float = 0.0  # 0 → sqrt(d_model)
    attention_multiplier: float = 0.0  # the softmax scale; 0 → 1/sqrt(head_dim)
    residual_multiplier: float = 1.0   # on each mixer and MLP output before the residual add
    logits_scaling: float = 1.0        # logits ÷ this

    # activation
    activation: str = "swiglu"  # swiglu | geglu | gelu

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    num_shared_experts: int = 0
    router_aux_weight: float = 0.01
    moe_dispatch: str = "einsum"

    # MLA (MiniCPM3 / DeepSeek-style)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mla_absorb: bool = False

    # SSM (Mamba2 SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256

    # hybrid layer pattern, e.g. ("rglru", "rglru", "attn") for RecurrentGemma
    layer_pattern: tuple[str, ...] = ()
    rglru_c: float = 8.0
    conv1d_width: int = 4

    # encoder-decoder (audio)
    encoder_layers: int = 0

    # modality frontend stub: "vision" feeds patch embeddings, "audio" frames
    frontend: str = ""
    frontend_tokens: int = 0

    remat_policy: str = "full"
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    vocab_pad_to: int = 256
    dtype: str = "bfloat16"
    long_context_window: int = 8192

    # ---- derived ----
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return ((self.vocab_size + p - 1) // p) * p

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def pattern(self) -> tuple[str, ...]:
        if self.layer_pattern:
            return self.layer_pattern
        if self.arch_type == "ssm":
            return ("ssm",)
        return ("moe_attn",) if self.num_experts else ("attn",)

    @property
    def torch_dtype(self) -> torch.dtype:
        return _torch_dtype(self.dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: ≤2 pattern units of layers, d_model ≤ 256, ≤4 experts."""
        unit = len(self.pattern)
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        return self.replace(
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 2 * unit),
            encoder_layers=min(self.encoder_layers, 2) if self.encoder_layers else 0,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=min(self.n_kv_heads, n_heads),
            head_dim=64 if self.head_dim else 0,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            experts_per_token=min(self.experts_per_token, 2) if self.experts_per_token else 0,
            q_lora_rank=min(self.q_lora_rank, 64) if self.q_lora_rank else 0,
            kv_lora_rank=min(self.kv_lora_rank, 32) if self.kv_lora_rank else 0,
            ssm_state=min(self.ssm_state, 32) if self.ssm_state else 0,
            ssm_chunk=32 if self.ssm_state else self.ssm_chunk,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            frontend_tokens=min(self.frontend_tokens, 16) if self.frontend_tokens else 0,
            dtype="float32",
        )


# --------------------------------------------------------------------------
# Primitive layers (functional: init_* returns params, apply is a function)
#
# The init helpers draw f32 normals from ``gen`` on its device and cast to
# ``dtype``; ``gen=None`` builds meta tensors (shapes and dtypes only).
# ``lead`` is the leading stacked-layer axis, () for an unstacked block.
# --------------------------------------------------------------------------


def seeded_generator(rng: "int | torch.Generator", device) -> torch.Generator:
    """``rng`` itself if it is a generator, else a generator on ``device``
    seeded with it."""
    if isinstance(rng, torch.Generator):
        return rng
    return torch.Generator(device=resolve_device(device)).manual_seed(int(rng))


def unstack(stacked: PyTree, n: int) -> list:
    """Per-layer views of a tree whose leaves share a leading axis of ``n``:
    one ``unbind`` per leaf, so in-place writes land in the stacked leaves."""
    leaves, treedef = tree_flatten_with_path(stacked)
    per_leaf = [leaf.unbind(0) for _, leaf in leaves]
    return [tree_unflatten(treedef, [views[i] for views in per_leaf]) for i in range(n)]


def _normal(gen, shape, dtype, std: float) -> torch.Tensor:
    if gen is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return x.mul_(std).to(dtype)


def _uniform(gen, shape, low: float, high: float) -> torch.Tensor:
    """f32 draws from U[low, high)."""
    if gen is None:
        return torch.empty(shape, dtype=torch.float32, device="meta")
    x = torch.rand(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return x.mul_(high - low).add_(low)


def _full(gen, shape, dtype, value: float) -> torch.Tensor:
    device = "meta" if gen is None else gen.device
    return torch.full(shape, value, dtype=dtype, device=device)


def dense_init(gen, d_in: int, d_out: int, dtype, scale: float | None = None,
               lead: tuple = ()) -> dict:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return {"w": _normal(gen, (*lead, d_in, d_out), dtype, scale)}


def dense_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    return reduce_partial(x @ fsdp_gather(p["w"]))


def rmsnorm_init(gen, d: int, dtype, lead: tuple = ()) -> dict:
    return {"scale": _full(gen, (*lead, d), dtype, 1.0)}


def rmsnorm_apply(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = unshard(x, -1).float()  # on a mesh, the normalized dim whole
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * p["scale"].float()
    return out.to(x.dtype)


def embedding_init(gen, vocab: int, d: int, dtype) -> dict:
    return {"table": _normal(gen, (vocab, d), dtype, 0.02)}


def embedding_apply(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return reduce_partial(F.embedding(tokens, fsdp_gather(p["table"])))


def scaled_embedding(p: dict, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings times sqrt(d_model), or ``embedding_multiplier`` where
    it is set, the scale rounded to the model's dtype first, as the
    reference's decoders scale them."""
    scale = torch.tensor(cfg.embedding_multiplier or cfg.d_model**0.5,
                         dtype=cfg.torch_dtype).item()
    return embedding_apply(p, tokens) * scale


def unembed_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: logits in f32 (loss stability)."""
    return x.float() @ fsdp_gather(p["table"]).float().t()


# -- rotary ------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq). Split-half."""
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)  # (hd/2,)
    angles = positions[..., :, None].float() * freqs                # (..., seq, hd/2)
    cos, sin = torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- gated MLP ----------------------------------------------------------------


def mlp_init(gen, cfg: ModelConfig, d_ff: int | None = None, lead: tuple = ()) -> dict:
    d_ff = d_ff or cfg.d_ff
    dt = cfg.torch_dtype
    p = {"wi": dense_init(gen, cfg.d_model, d_ff, dt, lead=lead)}
    if cfg.activation in ("swiglu", "geglu"):
        p["wg"] = dense_init(gen, cfg.d_model, d_ff, dt, lead=lead)
    p["wo"] = dense_init(gen, d_ff, cfg.d_model, dt, lead=lead)
    return p


def mlp_apply(p: dict, x: torch.Tensor, activation: str) -> torch.Tensor:
    h = dense_apply(p["wi"], x)
    if activation == "swiglu":
        h = F.silu(h) * dense_apply(p["wg"], x)
    elif activation == "geglu":
        h = F.gelu(h, approximate="tanh") * dense_apply(p["wg"], x)
    elif activation == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(f"unknown activation {activation}")
    return dense_apply(p["wo"], h)


# -- losses -------------------------------------------------------------------


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          valid_vocab: int | None = None) -> torch.Tensor:
    """Per-token CE in f32; padded vocab tail masked out. On a mesh the
    vocab dim is gathered first (DTensor's masked gather over a sharded dim
    fails)."""
    logits = unshard(logits, -1).float()
    if valid_vocab is not None and valid_vocab < logits.shape[-1]:
        mask = torch.arange(logits.shape[-1], device=logits.device) < valid_vocab
        logits = torch.where(mask, logits, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return logz - gold


def token_accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (unshard(logits, -1).argmax(dim=-1) == labels).float().mean()


# -- parameters from the reference --------------------------------------------


def load_jax_params(model, tree: dict, *, device: "str | torch.device" = "cuda") -> dict:
    """The reference's parameters (a nested dict of numpy arrays, e.g.
    ``np.asarray`` of each leaf of ``repro.models.cnn.MnistCNN().init(key)``
    or of ``repro.models.DecoderLM(cfg).init(key)``) as the port's tree on
    ``device``, each leaf in its own dtype (bf16 leaves arrive as ml_dtypes
    arrays and are read through f32, exactly). Raises unless the tree's
    ``LeafSpec.key`` equals the one of the port's own layout for ``model``."""
    want, got = LeafSpec.of(model.abstract()), LeafSpec.of(tree)
    if got.key != want.key:
        diff = next(((a, sa, da, b, sb, db) for a, sa, da, b, sb, db in zip(
            got.paths, got.shapes, got.dtypes, want.paths, want.shapes, want.dtypes)
            if (a, sa, da) != (b, sb, db)), None)
        raise ValueError(f"parameter layout mismatch: got {got}, want {want}; "
                         f"first difference (got vs want): {diff}")
    dev = resolve_device(device)
    return tree_unflatten(want.treedef, [
        as_tensor(np.array(a, copy=True)).to(dev, _torch_dtype(d))
        for a, d in zip(tree_leaves(tree), want.dtypes)])
