"""Least time of one call of an operation from its shapes: each input byte
read once and each output byte written once over the memory rate, against
the operations over the peak rate for its type; the larger bounds it. The
arithmetic is that of ``chip_smoke.py``'s ``bound`` and ``ssd_bound``."""
from __future__ import annotations

from . import peaks


def _bound(nbytes: float, flops: float, card: str, flops_table) -> float | None:
    bw, peak = peaks.rate(peaks.BANDWIDTH, card), peaks.rate(flops_table, card)
    if bw is None or peak is None:
        return None
    return max(nbytes / bw, flops / peak)


def fed_agg_bytes_flops(k: int, n: int) -> tuple[int, int]:
    """The weighted sum of a (K, N) f32 stack into (N,): (K+1)·N·4 bytes,
    2·K·N flops."""
    return (k + 1) * n * 4, 2 * k * n


def fed_agg_bound_s(k: int, n: int, card: str) -> float | None:
    nbytes, flops = fed_agg_bytes_flops(k, n)
    return _bound(nbytes, flops, card, peaks.F32_FLOPS)


def ssd_bytes_flops(*, B: int, S: int, H: int, P: int, N: int, chunk: int,
                    itemsize: int) -> tuple[int, int]:
    """One SSD scan: x and y (B,S,H,P) and B, C (B,S,N) in the input type,
    dA (B,S,H) f32, the f32 state read and written once; the flops of the
    visible (i, j <= i) pairs of each chunk (2N for C·B, 2P for the product
    with x) plus C·state and the state update (2·P·N a row each)."""
    nbytes = ((2 * B * S * H * P + 2 * B * S * N) * itemsize + B * S * H * 4
              + 2 * B * H * P * N * 4)
    flops = 0
    for c0 in range(0, S, chunk):
        rows = min(chunk, S - c0)
        flops += rows * (rows + 1) // 2 * 2 * (N + P) + 4 * rows * P * N
    return nbytes, flops * B * H


def ssd_bound_s(card: str, **shape) -> float | None:
    nbytes, flops = ssd_bytes_flops(**shape)
    table = peaks.BF16_FLOPS if shape["itemsize"] == 2 else peaks.F32_FLOPS
    return _bound(nbytes, flops, card, table)
