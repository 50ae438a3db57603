"""Published rates of the cards the benchmark may land on (NVIDIA data
sheets, dense, without sparsity, at the full power limit): device-memory
bytes/s, float32 flop/s outside the tensor cores, bf16 tensor-core flop/s.
A card whose name matches no row has no peak: its shares are not reported."""
from __future__ import annotations

# (substring of torch.cuda.get_device_name(), rate); the first match wins.
BANDWIDTH = (("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12), ("H100", 3.35e12))
F32_FLOPS = (("H100 PCIe", 51e12), ("H100", 67e12), ("H200", 67e12))
BF16_FLOPS = (("H100 PCIe", 756e12), ("H100 NVL", 835e12), ("H100", 989e12), ("H200", 989e12))


def rate(table, card: str) -> float | None:
    return next((r for key, r in table if key in card), None)
