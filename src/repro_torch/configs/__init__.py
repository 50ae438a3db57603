"""Architecture config registry: ``get_config("<arch-id>")`` — the port of
``repro.configs``.

The same 10 assigned architectures plus the paper's pythia-14m, as data. The
reference keeps one module per arch (each citing its source in its docstring);
its registry imports ``ModelConfig`` from ``repro.models``, so the port
carries its own copy of every config. ``PORT_IDS`` are the port's own
configurations, which the reference's registry lacks: granite-4.0-h-micro, a
hybrid of Mamba2 + MLP (``ssm_mlp``) and NoPE GQA + MLP (``attn``) layers.
Which of them the port can build is ``repro_torch.models.build_model``'s
business, not this registry's.
"""
from __future__ import annotations

from repro_torch.models.common import ModelConfig

ARCH_IDS = [
    "mamba2-130m",
    "recurrentgemma-9b",
    "gemma-7b",
    "minicpm3-4b",
    "internvl2-1b",
    "llama4-scout-17b-a16e",
    "grok-1-314b",
    "granite-3-2b",
    "seamless-m4t-medium",
    "qwen3-14b",
]

PAPER_IDS = ["pythia-14m"]

PORT_IDS = ["granite-4.0-h-micro"]

# granite-4.0-h's period of 10 layers: Mamba2 at 0-4 and 6-9, attention at 5
GRANITE_H_PERIOD = ("ssm_mlp",) * 5 + ("attn",) + ("ssm_mlp",) * 4

_CONFIGS = {
    # [ssm] SSD (state-space duality) [arXiv:2405.21060]
    "mamba2-130m": ModelConfig(
        name="mamba2-130m", arch_type="ssm",
        source="arXiv:2405.21060 (Mamba2); hf:state-spaces/mamba2-130m",
        n_layers=24, d_model=768, n_heads=24, n_kv_heads=24, d_ff=0, vocab_size=50280,
        attention="none", ssm_state=128, ssm_conv=4, ssm_expand=2, ssm_head_dim=64,
        ssm_chunk=256, layer_pattern=("ssm",), tie_embeddings=True),
    # [hybrid] RG-LRU + local attention, 1:2 [arXiv:2402.19427]
    "recurrentgemma-9b": ModelConfig(
        name="recurrentgemma-9b", arch_type="hybrid",
        source="arXiv:2402.19427 (Griffin/RecurrentGemma); hf:google/recurrentgemma-9b",
        n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256, d_ff=12288,
        vocab_size=256000, activation="geglu", sliding_window=2048,
        layer_pattern=("rglru", "rglru", "attn"), rglru_c=8.0, conv1d_width=4,
        tie_embeddings=True),
    # [dense] GeGLU, head_dim=256 [arXiv:2403.08295]
    "gemma-7b": ModelConfig(
        name="gemma-7b", arch_type="dense",
        source="arXiv:2403.08295 (Gemma); hf:google/gemma-7b",
        n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256, d_ff=24576,
        vocab_size=256000, activation="geglu", tie_embeddings=True),
    # [dense] MLA (multi-head latent attention) [hf:openbmb/MiniCPM3-4B]
    "minicpm3-4b": ModelConfig(
        name="minicpm3-4b", arch_type="dense",
        source="hf:openbmb/MiniCPM3-4B (MLA per DeepSeek-V2, arXiv:2405.04434)",
        n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40, d_ff=6400, vocab_size=73448,
        attention="mla", q_lora_rank=768, kv_lora_rank=256, qk_nope_dim=64, qk_rope_dim=32,
        v_head_dim=64, activation="swiglu", tie_embeddings=True),
    # [vlm] InternViT (stubbed) + Qwen2-0.5B LM backbone [arXiv:2404.16821]
    "internvl2-1b": ModelConfig(
        name="internvl2-1b", arch_type="vlm",
        source="arXiv:2404.16821 (InternVL2); hf:OpenGVLab/InternVL2-1B (Qwen2-0.5B LM)",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64, d_ff=4864,
        vocab_size=151655, activation="swiglu", frontend="vision", frontend_tokens=256,
        tie_embeddings=True),
    # [moe] 16 experts top-1 + a shared expert [hf:meta-llama/Llama-4-Scout-17B-16E]
    "llama4-scout-17b-a16e": ModelConfig(
        name="llama4-scout-17b-a16e", arch_type="moe",
        source="hf:meta-llama/Llama-4-Scout-17B-16E",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128, d_ff=8192,
        vocab_size=202048, activation="swiglu", num_experts=16, experts_per_token=1,
        num_shared_experts=1, layer_pattern=("moe_attn",), qk_norm=True,
        tie_embeddings=True),
    # [moe] 8 experts top-2 [hf:xai-org/grok-1]
    "grok-1-314b": ModelConfig(
        name="grok-1-314b", arch_type="moe", source="hf:xai-org/grok-1",
        n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128, d_ff=32768,
        vocab_size=131072, activation="gelu", num_experts=8, experts_per_token=2,
        layer_pattern=("moe_attn",), attn_logit_softcap=30.0, tie_embeddings=True),
    # [dense] GQA [hf:ibm-granite/granite-3.0-2b-base]
    "granite-3-2b": ModelConfig(
        name="granite-3-2b", arch_type="dense", source="hf:ibm-granite/granite-3.0-2b-base",
        n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64, d_ff=8192,
        vocab_size=49155, activation="swiglu", tie_embeddings=True),
    # [audio] enc-dec, speech frontend stubbed [arXiv:2308.11596]
    "seamless-m4t-medium": ModelConfig(
        name="seamless-m4t-medium", arch_type="audio",
        source="arXiv:2308.11596 (SeamlessM4T); hf:facebook/seamless-m4t-medium",
        n_layers=12, encoder_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
        head_dim=64, d_ff=4096, vocab_size=256206, activation="gelu", frontend="audio",
        frontend_tokens=1024, tie_embeddings=True),
    # [dense] qk_norm, GQA [hf:Qwen/Qwen3-14B]
    "qwen3-14b": ModelConfig(
        name="qwen3-14b", arch_type="dense",
        source="hf:Qwen/Qwen3-14B (qk_norm per Qwen3 family card)",
        n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128, d_ff=17408,
        vocab_size=151936, activation="swiglu", qk_norm=True, tie_embeddings=True),
    # the paper's WikiText LM (§4.4) [arXiv:2304.01373]
    "pythia-14m": ModelConfig(
        name="pythia-14m", arch_type="dense",
        source="arXiv:2304.01373 (Pythia); hf:EleutherAI/pythia-14m",
        n_layers=6, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32, d_ff=512,
        vocab_size=50304, activation="gelu", tie_embeddings=True),
    # [hybrid] 36 Mamba2 + 4 NoPE GQA layers, each with a SwiGLU MLP, and
    # Granite's multipliers [hf:ibm-granite/granite-4.0-h-micro config.json]
    "granite-4.0-h-micro": ModelConfig(
        name="granite-4.0-h-micro", arch_type="hybrid",
        source="hf:ibm-granite/granite-4.0-h-micro (granitemoehybrid, 2025-10)",
        n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64, d_ff=8192,
        vocab_size=100352, activation="swiglu", position_embedding="nope",
        ssm_state=128, ssm_conv=4, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
        layer_pattern=GRANITE_H_PERIOD, embedding_multiplier=12.0,
        attention_multiplier=0.015625, residual_multiplier=0.22, logits_scaling=8.0,
        norm_eps=1e-5, tie_embeddings=True),
}


def get_config(arch: str) -> ModelConfig:
    try:
        return _CONFIGS[arch]
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; options: {ARCH_IDS + PAPER_IDS + PORT_IDS}") \
            from None


def all_configs() -> dict[str, ModelConfig]:
    return {arch: get_config(arch) for arch in ARCH_IDS}
