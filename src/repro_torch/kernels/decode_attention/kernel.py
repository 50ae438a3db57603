"""ctypes wrapper of the hand-written decode_attention CUDA kernel
(``src/repro_torch/csrc/decode_attention.cu``).

It replaces the Pallas TPU kernel ``decode_attention`` of
``src/repro/kernels/decode_attention/kernel.py``: one decode step's GQA
attention of q (B, KV, G, hd) against a ring KV cache k/v (B, C, KV, hd) under
a (C,) slot-validity mask. Bound by bytes: the cache is read once,
2·B·C·KV·hd·itemsize bytes. The cache of each (b, kv) pair is split over
``split_count(...)`` blocks of one thread-block cluster, which merge their
partial softmaxes inside the same launch (see the source).

The wrapper checks device, dtype, shape and contiguity, allocates the output
with ``torch.empty``, launches on PyTorch's current stream without
synchronising, and raises if the launch reports an error. ``LAUNCHES`` counts
launches — at the launch and nowhere else.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from repro_torch.kernels import _build

_P, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q, k, v, valid, out, B, C, KV, G, hd, dtype, n_split, scale, stream
    "repro_decode_attention": (ctypes.c_int, [_P, _P, _P, _P, _P, _I32, _I32, _I32, _I32,
                                              _I32, _I32, _I32, _F32, _P]),
    # these two take hd, G, dtype, n_split
    "repro_decode_attention_smem_bytes": (ctypes.c_int, [_I32, _I32, _I32, _I32]),
    "repro_decode_attention_cluster_capacity": (ctypes.c_int, [_I32, _I32, _I32, _I32]),
}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)
MAX_G = 16
MAX_SPLIT = 8          # blocks of one (b, kv) pair: the portable cluster size
# What the split aims at: two blocks on every SM. More does not pay: a
# cluster of n blocks needs n free block slots in one GPC, so fewer clusters
# are resident at once as n grows, and once B*KV clusters no longer fit the
# grid takes two waves (chip_smoke.py's split sweep; PERF.md, PR 14).
BLOCKS_PER_SM = 2
MIN_SPLIT_ENTRIES = 64  # shorter slices cost more in the merge than they save


def split_count(B: int, KV: int, C: int, sm_count: int) -> int:
    """How many blocks (one cluster) share each (b, kv) pair's C entries:
    enough for ``BLOCKS_PER_SM`` blocks on each of ``sm_count`` SMs, at most
    ``MAX_SPLIT``, with slices of at least ``MIN_SPLIT_ENTRIES`` entries; then
    cut to the count whose slices of ceil(C / n) entries are all non-empty."""
    want = -(-BLOCKS_PER_SM * sm_count // (B * KV))
    n = max(1, min(MAX_SPLIT, want, C // MIN_SPLIT_ENTRIES))
    return -(-C // -(-C // n))


_sm_counts: dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sm_counts[index]

LAUNCHES = {"decode_attention": 0}
_launch_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
        LAUNCHES["decode_attention"] = 0


def _lib() -> ctypes.CDLL:
    return _build.load("decode_attention", _SIGNATURES)


def smem_bytes(hd: int, G: int, dtype: torch.dtype, n_split: int) -> int:
    """Dynamic shared memory of one block."""
    return _lib().repro_decode_attention_smem_bytes(hd, G, DTYPES[dtype], n_split)


def cluster_capacity(hd: int, G: int, dtype: torch.dtype, n_split: int) -> int:
    """Clusters of ``n_split`` blocks the current card holds at once."""
    n = _lib().repro_decode_attention_cluster_capacity(hd, G, DTYPES[dtype], n_split)
    if n < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: CUDA error {-n}")
    return n


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """q (B, KV, G, hd), k/v (B, C, KV, hd) of one dtype (f32 or bf16) on one
    card, valid (C,) bool → (B, KV, G, hd) in q's dtype."""
    return _launch(q, k, v, valid)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid: torch.Tensor,
            n_split: int | None = None) -> torch.Tensor:
    """``decode_attention`` with the split over ``n_split`` blocks (1 to
    ``MAX_SPLIT``) where given, else ``split_count``'s choice. The count is
    set by hand only to measure the rule (chip_smoke.py's split sweep)."""
    if not q.is_cuda:
        raise ValueError(f"decode_attention takes CUDA tensors (got one on {q.device})")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"want q (B,KV,G,hd) and k/v (B,C,KV,hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    B, KV, G, hd = q.shape
    C = k.shape[1]
    if tuple(k.shape) != (B, C, KV, hd) or tuple(v.shape) != (B, C, KV, hd):
        raise ValueError(f"k/v must be ({B}, C, {KV}, {hd}), got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share one dtype of {list(DTYPES)}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS or not 1 <= G <= MAX_G or C < 1:
        raise ValueError(f"decode_attention takes hd in {HEAD_DIMS}, 1 <= G <= {MAX_G}, "
                         f"C >= 1; got hd={hd}, G={G}, C={C}")
    if B * KV > 65535:
        raise ValueError(f"decode_attention takes B*KV <= 65535, got {B * KV}")
    if valid.dtype != torch.bool or tuple(valid.shape) != (C,):
        raise ValueError(f"valid must be ({C},) bool, got {valid.dtype} {tuple(valid.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("valid", valid)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (16-byte loads)")
    out = torch.empty_like(q)
    lib = _lib()
    if n_split is None:
        n_split = split_count(B, KV, C, sm_count(q.device))
    elif not 1 <= n_split <= MAX_SPLIT:
        raise ValueError(f"n_split must be in 1..{MAX_SPLIT}, got {n_split}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(), out.data_ptr(),
            B, C, KV, G, hd, DTYPES[q.dtype], n_split, 1.0 / math.sqrt(hd), stream)
    _build.check_launch(err, "decode_attention")
    with _launch_lock:
        LAUNCHES["decode_attention"] += 1
    return out
