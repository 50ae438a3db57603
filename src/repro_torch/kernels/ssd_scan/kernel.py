"""ctypes wrapper of the hand-written ssd_scan CUDA kernels
(``src/repro_torch/csrc/ssd_scan.cu``).

They replace the Pallas TPU kernel ``ssd_scan`` of
``src/repro/kernels/ssd_scan/kernel.py``: Mamba2's SSD chunked scan with an
f32 (P, N) state carried across chunks. ``ssd`` takes the model's layout
(x (B, S, H, P), dA (B, S, H), B/C shared by the heads as (B, S, N) or per
head as (B, S, H, N)), an optional initial state and an optional tensor for
the final state; ``ssd_scan`` keeps the TPU kernel's (BH, S, P) contract.
Strided views are read in place (only the innermost dimension must be
contiguous), so the B and C slices of the model's conv output are never
copied, nor broadcast to every head.

bf16 runs ``ssd_mma_kernel``: the chunks of each (b, h) in parallel over one
thread-block cluster of ``cluster_size(...)`` blocks, the products on the
tensor cores; it reads x, B and C with 16-byte copies, so their base pointers
and strides, and the states', must be 16-byte aligned (the wrapper raises
otherwise). f32 runs ``ssd_scan_kernel`` (f32 FMA, one block per (b, h)).

The wrapper checks device, dtype, shape, strides and alignment, allocates y
(and the final state unless given) with ``torch.empty``, launches on
PyTorch's current stream without synchronising, and raises if the launch
reports an error. ``LAUNCHES`` counts launches — at the launch and nowhere
else.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # x, dA, Bm, Cm, y, init_state, final_state, B, H, S, P, N, chunk,
    # x/y/dA/bc strides (b, s, h) in elements, dtype, cluster, stream
    "repro_ssd_scan": (ctypes.c_int, [_P] * 7 + [_I32] * 6 + [_I64] * 12 + [_I32] * 2 + [_P]),
    "repro_ssd_scan_smem_bytes": (ctypes.c_int, [_I32] * 3),  # P, N, dtype
    "repro_ssd_scan_cluster_capacity": (ctypes.c_int, [_I32] * 3),  # P, N, cluster
}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)       # P
STATE_DIMS = (32, 64, 128)  # N
MAX_CHUNK = 256
MAX_CLUSTER = 8  # blocks (chunks) of one (b, h) at once: the portable cluster size

LAUNCHES = {"ssd_scan": 0}
_launch_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
        LAUNCHES["ssd_scan"] = 0


def _lib() -> ctypes.CDLL:
    return _build.load("ssd_scan", _SIGNATURES)


def cluster_size(n_chunks: int, n_pairs: int, resident: list[int]) -> int:
    """Blocks (chunks at once) in each (b, h) pair's cluster of the bf16
    kernel: the size n in 1..MAX_CLUSTER that takes the fewest
    cluster-rounds in a row, ceil(n_pairs / resident[n-1]) waves of
    ceil(n_chunks / n) rounds, the smaller n on a tie (fewer ranks in the
    scan). ``resident[n-1]`` is how many clusters of n blocks the card holds
    at once (``cluster_capacity``)."""
    def rounds(n: int) -> tuple[int, int]:
        return -(-n_pairs // max(1, resident[n - 1])) * -(-n_chunks // n), n
    return min(range(1, min(MAX_CLUSTER, max(1, n_chunks)) + 1), key=rounds)


def plan_cluster(B: int, S: int, H: int, P: int, N: int, chunk: int) -> int:
    """``cluster_size`` for this call on the current card."""
    resident = [cluster_capacity(P, N, n) for n in range(1, MAX_CLUSTER + 1)]
    return cluster_size(-(-S // chunk), B * H, resident)


def smem_bytes(P: int, N: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block."""
    return _lib().repro_ssd_scan_smem_bytes(P, N, DTYPES[dtype])


_capacity: dict[tuple, int] = {}


def cluster_capacity(P: int, N: int, cluster: int) -> int:
    """Clusters of ``cluster`` blocks of the bf16 kernel the current card
    holds at once (asked once per card and shape)."""
    key = (torch.cuda.current_device(), P, N, cluster)
    if key not in _capacity:
        n = _lib().repro_ssd_scan_cluster_capacity(P, N, cluster)
        if n < 0:
            raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: CUDA error {-n}")
        _capacity[key] = n
    return _capacity[key]


def _check_state(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if (t.device != device or t.dtype != torch.float32 or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous f32 {shape} tensor on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _check_aligned(x, Bm, Cm, bc_strides, initial_state, state_out) -> None:
    """The bf16 kernel copies rows of x, B and C in 16-byte pieces and reads
    and writes the states in 16-byte pieces: every base pointer, and the
    stride of every dimension of x, B and C longer than 1, must be a multiple
    of 16 bytes."""
    bc_sizes = (Bm.shape[0], Bm.shape[1], x.shape[2] if Bm.dim() == 4 else 1)
    checks = [("x", x, zip(x.shape[:3], x.stride()[:3])),
              ("B", Bm, zip(bc_sizes, bc_strides)), ("C", Cm, zip(bc_sizes, bc_strides))]
    checks += [(name, t, ()) for name, t in
               (("initial_state", initial_state), ("state_out", state_out)) if t is not None]
    for name, t, dims in checks:
        strides = [st for size, st in dims if size > 1]
        if t.data_ptr() % 16 or any(st * t.element_size() % 16 for st in strides):
            raise ValueError(f"ssd_scan's bf16 kernel needs {name} 16-byte aligned: base "
                             f"pointer {t.data_ptr()}, strides {strides} of "
                             f"{t.element_size()}-byte elements")


def ssd(x: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, *,
        chunk: int = 256, initial_state: torch.Tensor | None = None,
        state_out: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,H,P) f32/bf16, dA (B,S,H) f32, Bm/Cm (B,S,N) or (B,S,H,N) in x's
    dtype, initial_state (B,H,P,N) f32 or None (zeros), all on one card →
    (y (B,S,H,P) in x's dtype, final state (B,H,P,N) f32, written into
    ``state_out`` when given; it may be ``initial_state`` itself)."""
    return _launch(x, dA, Bm, Cm, chunk=chunk, initial_state=initial_state, state_out=state_out)


def _launch(x: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, *,
            chunk: int = 256, initial_state: torch.Tensor | None = None,
            state_out: torch.Tensor | None = None,
            cluster: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``ssd`` with the bf16 kernel's cluster of ``cluster`` blocks (1 to
    ``MAX_CLUSTER``) where given, else ``cluster_size``'s choice. The size is
    set by hand only to measure the rule (chip_smoke.py's cluster sweep)."""
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
    if cluster is not None and not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"cluster must be in 1..{MAX_CLUSTER}, got {cluster}")
    if x.dtype == torch.bfloat16:
        _check_aligned(x, Bm, Cm, bc_strides, initial_state, state_out)
        if cluster is None:
            with torch.cuda.device(x.device):
                cluster = plan_cluster(B, S, H, P, N, chunk)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        with (torch.profiler.record_function("kernel.ssd_scan")
              if torch.autograd._profiler_enabled() else _build.NO_RANGE):
            err = lib.repro_ssd_scan(
                x.data_ptr(), dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                None if initial_state is None else initial_state.data_ptr(), state_out.data_ptr(),
                B, H, S, P, N, int(chunk),
                x.stride(0), x.stride(1), x.stride(2), y.stride(0), y.stride(1), y.stride(2),
                dA.stride(0), dA.stride(1), dA.stride(2), *bc_strides,
                DTYPES[x.dtype], cluster or 1, stream)  # (f32 reads no cluster size)
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
