"""Operations of Granite 4.0-H served from its shapes, and the bytes and
operations of its two attention kernels for their rooflines.

A token through a Mamba2 layer costs ``mamba2``'s projections and
convolution, 2·d·(2·d_inner + 2N + H) + 2·d_inner·d + 2·K·(d_inner + 2N);
through an attention layer, its projections 2·d·(q + 2·kv) + 2·q·d (q =
n_heads·hd, kv = n_kv_heads·hd); through every layer's SwiGLU MLP, 3·2·d·d_ff.
A prefill adds each Mamba2 layer's scan (``roofline.ssd_bytes_flops``) and
each attention layer's causal attention (``flash_bytes_flops``); a decode step
adds 4·H·P·N a row for each Mamba2 layer's state and the attention over the
ring's valid entries (``decode_attention_bytes_flops``). The tied unembedding,
2·d·padded_vocab, runs once a sequence in a prefill and once a token in a
decode step."""
from __future__ import annotations

from . import peaks
from .roofline import _bound, ssd_bytes_flops


def _dims(cfg: dict) -> dict:
    d = cfg["d_model"]
    d_inner = cfg["ssm_expand"] * d
    pad = cfg["vocab_pad_to"]
    return {"d": d, "d_inner": d_inner, "H": d_inner // cfg["ssm_head_dim"],
            "N": cfg["ssm_state"], "P": cfg["ssm_head_dim"], "KV": cfg["n_kv_heads"],
            "G": cfg["n_heads"] // cfg["n_kv_heads"], "hd": cfg["head_dim"],
            "V": -(-cfg["vocab_size"] // pad) * pad}


def _kinds(cfg: dict) -> list[str]:
    pattern = cfg["layer_pattern"]
    return [pattern[i % len(pattern)] for i in range(cfg["n_layers"])]


def _token_flops(cfg: dict, kind: str) -> int:
    m = _dims(cfg)
    d, di, N = m["d"], m["d_inner"], m["N"]
    mlp = 3 * 2 * d * cfg["d_ff"]
    if kind == "attn":
        q, kv = cfg["n_heads"] * m["hd"], m["KV"] * m["hd"]
        return 2 * d * (q + 2 * kv) + 2 * q * d + mlp
    return 2 * d * (2 * di + 2 * N + m["H"]) + 2 * di * d + 2 * cfg["ssm_conv"] * (di + 2 * N) \
        + mlp


def flash_bytes_flops(*, B: int, S: int, KV: int, G: int, hd: int,
                      itemsize: int) -> tuple[int, int]:
    """One causal ``flash_attention`` call: q and o (B,S,KV,G,hd) and k, v
    (B,S,KV,hd) touched once; 2·hd for q·k and 2·hd for p·v over each of the
    S(S+1)/2 visible pairs of every query head."""
    nbytes = (2 * B * S * KV * G * hd + 2 * B * S * KV * hd) * itemsize
    return nbytes, 4 * hd * (S * (S + 1) // 2) * B * KV * G


def decode_attention_bytes_flops(*, B: int, C: int, KV: int, G: int, hd: int,
                                 itemsize: int) -> tuple[int, int]:
    """One ``decode_attention`` call over C valid ring entries: q and o
    (B,KV,G,hd), those entries of k and v (B,C,KV,hd) and the (C,) bool mask
    read once; 4·hd a query head an entry."""
    nbytes = (2 * B * KV * G * hd + 2 * B * C * KV * hd) * itemsize + C
    return nbytes, 4 * hd * C * B * KV * G


def _table(itemsize: int):
    return peaks.BF16_FLOPS if itemsize == 2 else peaks.F32_FLOPS


def flash_bound_s(card: str, **shape) -> float | None:
    return _bound(*flash_bytes_flops(**shape), card, _table(shape["itemsize"]))


def decode_attention_bound_s(card: str, **shape) -> float | None:
    return _bound(*decode_attention_bytes_flops(**shape), card, _table(shape["itemsize"]))


def prefill_flops(cfg: dict, batch: int, prompt: int) -> int:
    m = _dims(cfg)
    scan = ssd_bytes_flops(B=batch, S=prompt, H=m["H"], P=m["P"], N=m["N"],
                           chunk=cfg["ssm_chunk"], itemsize=2)[1]
    attn = flash_bytes_flops(B=batch, S=prompt, KV=m["KV"], G=m["G"], hd=m["hd"],
                             itemsize=2)[1]
    return sum(batch * prompt * _token_flops(cfg, k) + (attn if k == "attn" else scan)
               for k in _kinds(cfg)) + batch * 2 * m["d"] * m["V"]


def decode_flops(cfg: dict, batch: int, context: int) -> int:
    """One decode step of ``batch`` rows whose rings hold ``context`` valid
    entries (the new token's included)."""
    m = _dims(cfg)
    attn = decode_attention_bytes_flops(B=batch, C=context, KV=m["KV"], G=m["G"], hd=m["hd"],
                                        itemsize=2)[1]
    state = batch * 4 * m["H"] * m["P"] * m["N"]
    return sum(batch * _token_flops(cfg, k) + (attn if k == "attn" else state)
               for k in _kinds(cfg)) + batch * 2 * m["d"] * m["V"]
