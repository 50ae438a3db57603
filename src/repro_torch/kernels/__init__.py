"""Hand-written CUDA kernels for the port's compute hot spots (Hopper, sm_90a).

Each kernel subpackage keeps the reference's three-file layout:
  kernel.py — ctypes wrapper around a CUDA C++ kernel in ``src/repro_torch/csrc``
  ops.py    — public entry point: dispatches on the tensor's device
  ref.py    — plain PyTorch version (the CPU path and the oracle on the card)

A CPU tensor goes through the plain version. A CUDA tensor goes through the
kernel, or raises: there is no fallback from the card to a library call.
Kernels are compiled from source at first use (``_build.py``). A DTensor
never reaches an op: on a mesh the model calls each op through ``local_map``
on the local shard, and an op handed a DTensor raises (``local_only``) rather
than read a pointer or fall back.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor


def on_cuda() -> bool:
    """The counterpart of ``repro.kernels.on_tpu``: is there a card?"""
    return torch.cuda.is_available()


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """The port's entry points run on the card unless the caller asks for the
    CPU. Asking for CUDA without a card raises; nothing quietly falls back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    return dev


def local_only(op: str, *tensors: torch.Tensor) -> None:
    """Raise if a DTensor reached kernel op ``op`` outside ``local_map``."""
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"{op} takes local tensors; on a mesh call it through local_map "
                        "(repro_torch.models.sharded.on_local_shards)")
