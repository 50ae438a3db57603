"""Operations of the Mamba2 language model served from its shapes. A token
through a layer costs the matrix products of its projections, 2·d·(2·d_inner
+ 2·N + H) in and 2·d_inner·d out, and the width-K depthwise convolution,
2·K·(d_inner + 2N). The scan costs, for a prefill, what ``roofline``'s
``ssd_bytes_flops`` counts and, for a decode step, 4·H·P·N a row (the state
update and its product with C). The tied unembedding, 2·d·padded_vocab, runs
once a sequence in a prefill (the last position) and once a token in a
decode step."""
from __future__ import annotations

from .roofline import ssd_bytes_flops


def _dims(cfg: dict) -> tuple[int, int, int, int, int, int]:
    d = cfg["d_model"]
    d_inner = cfg["ssm_expand"] * d
    H, N, P = d_inner // cfg["ssm_head_dim"], cfg["ssm_state"], cfg["ssm_head_dim"]
    pad = cfg["vocab_pad_to"]
    return d, d_inner, H, N, P, -(-cfg["vocab_size"] // pad) * pad


def _token_layer_flops(cfg: dict) -> int:
    d, d_inner, H, N, _, _ = _dims(cfg)
    return (2 * d * (2 * d_inner + 2 * N + H) + 2 * d_inner * d
            + 2 * cfg["ssm_conv"] * (d_inner + 2 * N))


def prefill_flops(cfg: dict, batch: int, prompt: int) -> int:
    d, _, H, N, P, V = _dims(cfg)
    scan = ssd_bytes_flops(B=batch, S=prompt, H=H, P=P, N=N, chunk=cfg["ssm_chunk"],
                           itemsize=2)[1]
    per_layer = batch * prompt * _token_layer_flops(cfg) + scan
    return cfg["n_layers"] * per_layer + batch * 2 * d * V


def decode_flops(cfg: dict, batch: int) -> int:
    d, _, H, N, P, V = _dims(cfg)
    return cfg["n_layers"] * batch * (_token_layer_flops(cfg) + 4 * H * P * N) + batch * 2 * d * V
