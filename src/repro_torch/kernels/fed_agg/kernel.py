"""ctypes wrappers of the hand-written fed_agg / fed_opt CUDA kernels
(``src/repro_torch/csrc/fed_agg.cu``).

They replace the Pallas TPU kernels ``fed_agg`` and ``fed_opt`` of
``src/repro/kernels/fed_agg/kernel.py``. Both are bound by device-memory
bandwidth: ``fed_agg`` moves (K+1)·N·4 bytes, ``fed_opt`` (K+6)·N·4 bytes.

The wrappers check device, dtype, shape and strides, allocate the outputs
with ``torch.empty``, launch on PyTorch's current stream without
synchronising, and raise if the launch reports an error. Each counts its
launches in ``LAUNCHES`` — at the launch and nowhere else — so a run can show
that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build

_P, _I64, _I32, _F32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # x, ld, w, out, K, N, vec, stream
    "repro_fed_agg": (ctypes.c_int, [_P, _I64, _P, _P, _I32, _I64, _I32, _P]),
    # x, ld, w, p, m, v, p', m', v', K, N, variant, lr, b1, 1-b1, b2, 1-b2, tau, vec, stream
    "repro_fed_opt": (ctypes.c_int, [_P, _I64, _P, _P, _P, _P, _P, _P, _P, _I32, _I64,
                                     _I32, _F32, _F32, _F32, _F32, _F32, _F32, _I32, _P]),
}
VARIANTS = {"adam": 0, "yogi": 1, "adagrad": 2}

LAUNCHES = {"fed_agg": 0, "fed_opt": 0}
_launch_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _count(name: str) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1


def _lib() -> ctypes.CDLL:
    return _build.load("fed_agg", _SIGNATURES)


def _check_stack(stacked: torch.Tensor, weights: torch.Tensor) -> tuple[int, int, int]:
    """-> (K, N, ld). The stack may have a row stride ``ld`` >= N."""
    if not stacked.is_cuda:
        raise ValueError("the fed_agg kernels take CUDA tensors "
                         f"(got one on {stacked.device})")
    if stacked.dtype != torch.float32 or stacked.dim() != 2:
        raise ValueError(f"stack must be 2-D float32, got {stacked.dtype} {tuple(stacked.shape)}")
    k, n = stacked.shape
    if k < 1:
        raise ValueError("empty aggregation (K = 0)")
    if stacked.stride(1) != 1 or (k > 1 and stacked.stride(0) < n):
        raise ValueError(f"stack rows must be contiguous, got strides {stacked.stride()}")
    if (weights.dtype != torch.float32 or weights.shape != (k,)
            or weights.device != stacked.device or not weights.is_contiguous()):
        raise ValueError(f"weights must be a contiguous ({k},) float32 tensor on "
                         f"{stacked.device}, got {weights.dtype} {tuple(weights.shape)} "
                         f"on {weights.device}")
    return k, n, stacked.stride(0) if k > 1 else n


def _vec(ld: int, *tensors: torch.Tensor) -> int:
    """4 when every row and vector starts 16-byte aligned (float4 loads)."""
    aligned = ld % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)
    return 4 if aligned else 1


def fed_agg(stacked: torch.Tensor, weights: torch.Tensor, *,
            out: torch.Tensor | None = None) -> torch.Tensor:
    """stacked (K, N) f32, weights (K,) f32 on one card → (N,) f32 = weightsᵀ·stacked,
    written into ``out`` when given (a warm caller-owned buffer), else fresh."""
    k, n, ld = _check_stack(stacked, weights)
    if out is None:
        out = torch.empty(n, dtype=torch.float32, device=stacked.device)
    elif (out.dtype != torch.float32 or out.shape != (n,) or out.device != stacked.device
          or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous ({n},) float32 tensor on {stacked.device}")
    lib = _lib()
    with torch.cuda.device(stacked.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_fed_agg(stacked.data_ptr(), ld, weights.data_ptr(), out.data_ptr(),
                                k, n, _vec(ld, stacked, out), stream)
    _build.check_launch(err, "fed_agg")
    _count("fed_agg")
    return out


def fed_opt(stacked: torch.Tensor, weights: torch.Tensor, x: torch.Tensor,
            m: torch.Tensor, v: torch.Tensor, *, lr: float, b1: float, b2: float,
            tau: float, variant: str = "adam") -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused FedAdam/FedYogi/FedAdagrad step (Reddi et al. 2021):

        avg = weightsᵀ·stacked;  Δ = x − avg
        m' = b1·m + (1−b1)·Δ;    v' = variant(v, Δ²)
        x' = x − lr·m' / (√v' + tau)

    Returns fresh (x', m', v'), all (N,) f32. The hyperparameters are runtime
    arguments: no rebuild per hyperparameter set."""
    k, n, ld = _check_stack(stacked, weights)
    if variant not in VARIANTS:
        raise ValueError(f"unknown fed_opt variant {variant!r}")
    for name, t in (("x", x), ("m", m), ("v", v)):
        if (t.dtype != torch.float32 or t.shape != (n,) or t.device != stacked.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({n},) float32 tensor on "
                             f"{stacked.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    xo, mo, vo = (torch.empty_like(t) for t in (x, m, v))
    lib = _lib()
    with torch.cuda.device(stacked.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_fed_opt(
            stacked.data_ptr(), ld, weights.data_ptr(), x.data_ptr(), m.data_ptr(),
            v.data_ptr(), xo.data_ptr(), mo.data_ptr(), vo.data_ptr(), k, n,
            VARIANTS[variant], float(lr), float(b1), 1.0 - float(b1), float(b2),
            1.0 - float(b2), float(tau), _vec(ld, stacked, x, m, v, xo, mo, vo), stream)
    _build.check_launch(err, "fed_opt")
    _count("fed_opt")
    return xo, mo, vo
