"""ctypes wrapper of the Mamba2 prefill's two elementwise CUDA kernels
(``src/repro_torch/csrc/ssm_prefill.cu``).

They replace no TPU kernel: the reference leaves the mixer's elementwise work
around ``ssd_scan`` to XLA's fusion, and eager PyTorch runs it as ~33
launches a layer. ``prefill_in`` reads the x/B/C projections and the conv
cache in place and writes the scan's inputs (xh, xdt, dA, B, C) and the new
conv cache; ``prefill_out`` turns the scan's y, xh and z into the input of
out_proj (D skip, SiLU gate, RMSNorm in f32). The arithmetic rounds where
``ref.py``'s composition rounds (the source says how).

f32 and bf16 (every tensor in the model dtype but dt_bias, A_log, D and dA,
which are f32). Each thread moves 16 bytes at a time, so d_inner, N and
head_dim must be multiples of a 16-byte vector, and every activation's base
pointer and strides multiples of 16 bytes (the wrapper raises otherwise, as
``ssd_scan``'s bf16 kernel does: the model's projections and caches are).
Parameters are read an element at a time, so a weight buffer's views need
no alignment. The conv width must be the kernel's (4). ``prefill_out`` sums
each row's squares in the order of PyTorch's CUDA mean, which it follows
for d_inner from 256 to ~8,000 (to 4,096 in f32: one thread a vector), so
on the card both kernels give ``ref.py``'s bits.

The wrapper checks device, dtype, shape, strides and alignment, allocates
the outputs with ``torch.empty``, launches on PyTorch's current stream
without synchronising, and raises if the launch reports an error.
``LAUNCHES`` counts launches — at the launch and nowhere else.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build

_P, _I32, _I64, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    # x, B, C, dt_raw, conv, conv_w, conv_b, dt_bias, A_log, xh, xdt, dA, B out, C out,
    # B, S, d_inner, N, H, P, strides x/B/C/dt (b, s) and conv (b, row), dtype, stream
    "repro_ssm_prefill_in": (ctypes.c_int, [_P] * 14 + [_I32] * 6 + [_I64] * 10 + [_I32, _P]),
    # y, xh, z, D, scale, out, B, S, d_inner, P, strides y/xh/z (b, s), eps, dtype, stream
    "repro_ssm_prefill_out": (ctypes.c_int, [_P] * 6 + [_I32] * 4 + [_I64] * 6 + [_F32, _I32, _P]),
    "repro_ssm_prefill_conv_width": (ctypes.c_int, []),
    "repro_ssm_prefill_out_takes": (ctypes.c_int, [_I64, _I32, _I32]),
}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = {"ssm_prefill_in": 0, "ssm_prefill_out": 0}
_launch_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
        for op in LAUNCHES:
            LAUNCHES[op] = 0


def _lib() -> ctypes.CDLL:
    return _build.load("ssm_prefill", _SIGNATURES)


def _count(op: str) -> None:
    with _launch_lock:
        LAUNCHES[op] += 1


def _check(name: str, t: torch.Tensor, shape: tuple, dtype: torch.dtype, device,
           *, contiguous: bool = False) -> None:
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != shape
            or t.stride(-1) != 1
            or (contiguous and not t.is_contiguous())):
        kind = "contiguous " if contiguous else "unit-innermost-stride "
        raise ValueError(f"{name} must be a {kind}{dtype} {shape} tensor on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} strides {t.stride()} on {t.device}")


def _check_vectors(op: str, dtype: torch.dtype, widths: dict, tensors: dict) -> None:
    """The kernels move 16-byte vectors: every width a multiple of one, every
    tensor's base pointer and its strides of outer dims longer than 1
    multiples of 16 bytes (the innermost stride is 1)."""
    vec = 16 // dtype.itemsize
    for name, w in widths.items():
        if w % vec:
            raise ValueError(f"{op} takes {name} a multiple of {vec} ({dtype}), got {w}")
    for name, t in tensors.items():
        strides = [st for size, st in zip(t.shape[:-1], t.stride()[:-1]) if size > 1]
        if t.data_ptr() % 16 or any(st * t.element_size() % 16 for st in strides):
            raise ValueError(f"{op} needs {name} 16-byte aligned: base pointer "
                             f"{t.data_ptr()}, strides {strides} of {t.element_size()}-byte "
                             "elements")


def prefill_in(xs: torch.Tensor, Bp: torch.Tensor, Cp: torch.Tensor, dt_raw: torch.Tensor,
               conv_cache: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
               dt_bias: torch.Tensor, A_log: torch.Tensor, *, head_dim: int):
    """xs (B,S,d_inner), Bp/Cp (B,S,N), dt_raw (B,S,H), conv_cache (B,K-1,C)
    in the model dtype (f32 or bf16), conv_w (K,C), conv_b (C,) contiguous in
    it, dt_bias/A_log (H,) f32, all on one card → (xh, xdt (B,S,H,P), dA
    (B,S,H) f32, Bm, Cm (B,S,N)), fresh and contiguous; the conv cache is
    rewritten in place with the trailing K-1 raw rows of cache ++ xBC."""
    if not xs.is_cuda:
        raise ValueError(f"ssm_prefill_in takes CUDA tensors (got one on {xs.device})")
    if xs.dim() != 3 or Bp.dim() != 3:
        raise ValueError(f"want xs (B,S,d_inner) and B/C (B,S,N); got {tuple(xs.shape)}, "
                         f"{tuple(Bp.shape)}")
    dtype, dev = xs.dtype, xs.device
    if dtype not in DTYPES:
        raise ValueError(f"ssm_prefill_in takes {list(DTYPES)}, got {dtype}")
    B, S, d_inner = xs.shape
    N, P = Bp.shape[-1], int(head_dim)
    lib = _lib()
    K = lib.repro_ssm_prefill_conv_width()
    if S < 1 or P < 1 or d_inner % P:
        raise ValueError(f"want S >= 1 and d_inner a multiple of head_dim; got S={S}, "
                         f"d_inner={d_inner}, head_dim={P}")
    H, C = d_inner // P, d_inner + 2 * N
    _check("B", Bp, (B, S, N), dtype, dev)
    _check("C", Cp, (B, S, N), dtype, dev)
    _check("dt_raw", dt_raw, (B, S, H), dtype, dev)
    _check("conv_cache", conv_cache, (B, K - 1, C), dtype, dev)
    _check("conv_w", conv_w, (K, C), dtype, dev, contiguous=True)
    _check("conv_b", conv_b, (C,), dtype, dev, contiguous=True)
    _check("dt_bias", dt_bias, (H,), torch.float32, dev, contiguous=True)
    _check("A_log", A_log, (H,), torch.float32, dev, contiguous=True)
    _check_vectors("ssm_prefill_in", dtype, {"d_inner": d_inner, "N": N, "head_dim": P},
                   {"x": xs, "B": Bp, "C": Cp, "conv_cache": conv_cache})
    xh = torch.empty((B, S, H, P), dtype=dtype, device=dev)
    xdt = torch.empty_like(xh)
    dA = torch.empty((B, S, H), dtype=torch.float32, device=dev)
    Bm = torch.empty((B, S, N), dtype=dtype, device=dev)
    Cm = torch.empty_like(Bm)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        with (torch.profiler.record_function("kernel.ssm_prefill_in")
              if torch.autograd._profiler_enabled() else _build.NO_RANGE):
            err = lib.repro_ssm_prefill_in(
                xs.data_ptr(), Bp.data_ptr(), Cp.data_ptr(), dt_raw.data_ptr(),
                conv_cache.data_ptr(), conv_w.data_ptr(), conv_b.data_ptr(), dt_bias.data_ptr(),
                A_log.data_ptr(), xh.data_ptr(), xdt.data_ptr(), dA.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), B, S, d_inner, N, H, P,
                xs.stride(0), xs.stride(1), Bp.stride(0), Bp.stride(1), Cp.stride(0),
                Cp.stride(1), dt_raw.stride(0), dt_raw.stride(1), conv_cache.stride(0),
                conv_cache.stride(1), DTYPES[dtype], stream)
    _build.check_launch(err, "ssm_prefill_in")
    _count("ssm_prefill_in")
    return xh, xdt, dA, Bm, Cm


def prefill_out(y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor, D: torch.Tensor,
                scale: torch.Tensor, eps: float) -> torch.Tensor:
    """y/xh (B,S,H,P) with each (H,P) row contiguous, z (B,S,d_inner) with a
    unit innermost stride, scale (d_inner,) contiguous, all in the model dtype,
    D (H,) f32, on one card → the RMS-normalised gated rows (B,S,d_inner),
    fresh and contiguous."""
    if not y.is_cuda:
        raise ValueError(f"ssm_prefill_out takes CUDA tensors (got one on {y.device})")
    if y.dim() != 4:
        raise ValueError(f"want y (B,S,H,P); got {tuple(y.shape)}")
    dtype, dev = y.dtype, y.device
    if dtype not in DTYPES:
        raise ValueError(f"ssm_prefill_out takes {list(DTYPES)}, got {dtype}")
    B, S, H, P = y.shape
    d_inner = H * P
    for name, t in (("y", y), ("xh", xh)):
        _check(name, t, (B, S, H, P), dtype, dev)
        if t.stride(2) != P:
            raise ValueError(f"{name}'s (H,P) rows must be contiguous, strides {t.stride()}")
    _check("z", z, (B, S, d_inner), dtype, dev)
    _check("D", D, (H,), torch.float32, dev, contiguous=True)
    _check("scale", scale, (d_inner,), dtype, dev, contiguous=True)
    _check_vectors("ssm_prefill_out", dtype, {"head_dim": P}, {"y": y, "xh": xh, "z": z})
    lib = _lib()
    if not lib.repro_ssm_prefill_out_takes(B * S, d_inner, DTYPES[dtype]):
        raise ValueError(f"ssm_prefill_out does not take {B * S} rows of d_inner {d_inner} in "
                         f"{dtype}: it sums a row in PyTorch's order for d_inner 256 to ~8,000, "
                         "one thread a 16-byte vector")
    out = torch.empty((B, S, d_inner), dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        with (torch.profiler.record_function("kernel.ssm_prefill_out")
              if torch.autograd._profiler_enabled() else _build.NO_RANGE):
            err = lib.repro_ssm_prefill_out(
                y.data_ptr(), xh.data_ptr(), z.data_ptr(), D.data_ptr(), scale.data_ptr(),
                out.data_ptr(), B, S, d_inner, P, y.stride(0), y.stride(1), xh.stride(0),
                xh.stride(1), z.stride(0), z.stride(1), float(eps), DTYPES[dtype], stream)
    _build.check_launch(err, "ssm_prefill_out")
    _count("ssm_prefill_out")
    return out
