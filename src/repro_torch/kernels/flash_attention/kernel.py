"""ctypes wrapper of the hand-written flash_attention CUDA kernel
(``src/repro_torch/csrc/flash_attention.cu``).

It replaces the Pallas TPU kernel ``flash_attention`` of
``src/repro/kernels/flash_attention/kernel.py``: causal GQA attention, with an
optional sliding window, of q (B, S, KV, G, hd) over k/v (B, S, KV, hd), with
an online softmax in f32. q, k, v and o are touched once; the work grows with
S² (see the source for what bounds it). bf16 takes the tensor-core kernel
(``repro_flash_attention_mma``), f32 the scalar FMA kernel
(``repro_flash_attention_fma``): one source, one launch per call either way.

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
_ARGS = [_P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32, _I32, _F32, _P]
_SIGNATURES = {
    # q, k, v, out, B, S, KV, G, hd, window, scale, stream
    "repro_flash_attention_fma": (ctypes.c_int, _ARGS),
    "repro_flash_attention_mma": (ctypes.c_int, _ARGS),
    "repro_flash_attention_smem_bytes": (ctypes.c_int, [_I32, _I32]),  # hd, dtype
}
# Which kernel a dtype takes: bf16 runs on the tensor cores (mma.sync); f32
# keeps scalar FMA tiles, since bf16 or TF32 operands could not meet the
# reference's f32 tolerance. Both are the kernel; neither is a fallback.
ENTRY = {torch.float32: "repro_flash_attention_fma", torch.bfloat16: "repro_flash_attention_mma"}
DTYPES = tuple(ENTRY)
HEAD_DIMS = (32, 64, 128, 256)


def max_group(hd: int) -> int:
    """Most query heads per KV head one q tile holds (its rows)."""
    return 32 if hd >= 256 else 64


LAUNCHES = {"flash_attention": 0}
_launch_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
        LAUNCHES["flash_attention"] = 0


def _lib() -> ctypes.CDLL:
    return _build.load("flash_attention", _SIGNATURES)


def smem_bytes(hd: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block of the kernel ``dtype`` takes."""
    return _lib().repro_flash_attention_smem_bytes(hd, int(dtype == torch.bfloat16))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0) -> torch.Tensor:
    """q (B, S, KV, G, hd), k/v (B, S, KV, hd) of one dtype (f32 or bf16) on
    one card → (B, S, KV, G, hd) causal attention in q's dtype; ``window`` > 0
    restricts each query to its last ``window`` keys."""
    if not q.is_cuda:
        raise ValueError(f"flash_attention takes CUDA tensors (got one on {q.device})")
    if q.dim() != 5:
        raise ValueError(f"want q (B,S,KV,G,hd), got {tuple(q.shape)}")
    B, S, KV, G, hd = q.shape
    if tuple(k.shape) != (B, S, KV, hd) or tuple(v.shape) != (B, S, KV, hd):
        raise ValueError(f"k/v must be ({B}, {S}, {KV}, {hd}), got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share one dtype of {list(DTYPES)}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS or not 1 <= G <= max_group(hd) or S < 1:
        raise ValueError(f"flash_attention takes hd in {HEAD_DIMS}, 1 <= G <= "
                         f"{max_group(hd) if hd in HEAD_DIMS else '?'}, S >= 1; "
                         f"got hd={hd}, G={G}, S={S}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned on {q.device}")
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        with (torch.profiler.record_function("kernel.flash_attention")
              if torch.autograd._profiler_enabled() else _build.NO_RANGE):
            err = getattr(lib, ENTRY[q.dtype])(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, KV, G, hd,
                int(window), 1.0 / math.sqrt(hd), stream)
    _build.check_launch(err, "flash_attention")
    with _launch_lock:
        LAUNCHES["flash_attention"] += 1
    return out
