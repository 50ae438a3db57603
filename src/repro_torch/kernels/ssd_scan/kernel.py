"""ctypes wrapper of the hand-written ssd_scan CUDA kernel
(``src/repro_torch/csrc/ssd_scan.cu``).

It replaces the Pallas TPU kernel ``ssd_scan`` of
``src/repro/kernels/ssd_scan/kernel.py``: Mamba2's SSD chunked scan with an
f32 (P, N) state carried across chunks. ``ssd`` takes the model's layout
(x (B, S, H, P), dA (B, S, H), B/C shared by the heads as (B, S, N) or per
head as (B, S, H, N)), an optional initial state and an optional tensor for
the final state; ``ssd_scan`` keeps the TPU kernel's (BH, S, P) contract.
Strided views are read in place (only the innermost dimension must be
contiguous), so the B and C slices of the model's conv output are never
copied, nor broadcast to every head.

The wrapper checks device, dtype, shape and strides, allocates y (and the
final state unless given) with ``torch.empty``, launches on PyTorch's current
stream without synchronising, and raises if the launch reports an error.
``LAUNCHES`` counts launches — at the launch and nowhere else.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # x, dA, Bm, Cm, y, init_state, final_state, B, H, S, P, N, chunk,
    # x/y/dA/bc strides (b, s, h) in elements, dtype, stream
    "repro_ssd_scan": (ctypes.c_int, [_P] * 7 + [_I32] * 6 + [_I64] * 12 + [_I32, _P]),
}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)       # P
STATE_DIMS = (32, 64, 128)  # N
MAX_CHUNK = 256

LAUNCHES = {"ssd_scan": 0}
_launch_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
        LAUNCHES["ssd_scan"] = 0


def _lib() -> ctypes.CDLL:
    return _build.load("ssd_scan", _SIGNATURES)


def _check_state(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if (t.device != device or t.dtype != torch.float32 or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous f32 {shape} tensor on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def ssd(x: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, *,
        chunk: int = 256, initial_state: torch.Tensor | None = None,
        state_out: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,H,P) f32/bf16, dA (B,S,H) f32, Bm/Cm (B,S,N) or (B,S,H,N) in x's
    dtype, initial_state (B,H,P,N) f32 or None (zeros), all on one card →
    (y (B,S,H,P) in x's dtype, final state (B,H,P,N) f32, written into
    ``state_out`` when given; it may be ``initial_state`` itself)."""
    if not x.is_cuda:
        raise ValueError(f"ssd_scan takes CUDA tensors (got one on {x.device})")
    if x.dim() != 4 or dA.dim() != 3 or Bm.dim() not in (3, 4):
        raise ValueError(f"want x (B,S,H,P), dA (B,S,H), B/C (B,S,N) or (B,S,H,N); got "
                         f"{tuple(x.shape)}, {tuple(dA.shape)}, {tuple(Bm.shape)}")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    bc_shape = (B, S, N) if Bm.dim() == 3 else (B, S, H, N)
    if tuple(dA.shape) != (B, S, H) or tuple(Bm.shape) != bc_shape or Cm.shape != Bm.shape:
        raise ValueError(f"dA must be {(B, S, H)} and B/C {bc_shape}, got {tuple(dA.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    if x.dtype not in DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"x/B/C must share one dtype of {list(DTYPES)}, got {x.dtype}, "
                         f"{Bm.dtype}, {Cm.dtype}")
    if dA.dtype != torch.float32:
        raise ValueError(f"dA must be f32, got {dA.dtype}")
    if P not in HEAD_DIMS or N not in STATE_DIMS or not 1 <= chunk <= MAX_CHUNK or S < 1:
        raise ValueError(f"ssd_scan takes P in {HEAD_DIMS}, N in {STATE_DIMS}, 1 <= chunk <= "
                         f"{MAX_CHUNK}, S >= 1; got P={P}, N={N}, chunk={chunk}, S={S}")
    for name, t in (("dA", dA), ("B", Bm), ("C", Cm)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.stride(-1) != 1 or Bm.stride(-1) != 1 or Cm.stride() != Bm.stride():
        raise ValueError("x and B/C need a unit innermost stride, and B and C one layout")
    state_shape = (B, H, P, N)
    if initial_state is not None:
        _check_state("initial_state", initial_state, state_shape, x.device)
    if state_out is None:
        state_out = torch.empty(state_shape, dtype=torch.float32, device=x.device)
    else:
        _check_state("state_out", state_out, state_shape, x.device)
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    bc_strides = ((Bm.stride(0), Bm.stride(1), 0) if Bm.dim() == 3
                  else (Bm.stride(0), Bm.stride(1), Bm.stride(2)))
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_ssd_scan(
            x.data_ptr(), dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
            None if initial_state is None else initial_state.data_ptr(), state_out.data_ptr(),
            B, H, S, P, N, int(chunk),
            x.stride(0), x.stride(1), x.stride(2), y.stride(0), y.stride(1), y.stride(2),
            dA.stride(0), dA.stride(1), dA.stride(2), *bc_strides,
            DTYPES[x.dtype], stream)
    _build.check_launch(err, "ssd_scan")
    with _launch_lock:
        LAUNCHES["ssd_scan"] += 1
    return y, state_out


def ssd_scan(x: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, *,
             chunk: int = 256) -> torch.Tensor:
    """The TPU kernel's contract: x (BH,S,P), dA (BH,S), Bm/Cm (BH,S,N), state
    from zero → y (BH,S,P). Unlike the TPU kernel, any S (the last chunk may
    be ragged)."""
    y, _ = ssd(x[:, :, None], dA[:, :, None], Bm[:, :, None], Cm[:, :, None], chunk=chunk)
    return y[:, :, 0]
