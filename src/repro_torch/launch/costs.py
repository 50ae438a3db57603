"""Roofline cost accounting — the port of ``repro.launch.costs``.

The reference walks a jaxpr (``jaxpr_costs``) because XLA's own cost
analysis visits a scanned layer loop once. The port's model loops over layers
in Python, so a step's operations can simply be counted as they run:
``step_costs`` runs a step under ``torch.utils.flop_counter.FlopCounterMode``
(flops) with the reference's byte model beside it. On meta or fake tensors it
needs no device time and no memory. The counts are *global*: on DTensors the
counter sees each operation at its logical (whole-tensor) shape, and the
kernels' local work inside ``local_map`` is scaled by the number of shards
(``models.sharded.local_shards``).

  * flops — mm / addmm / bmm / baddbmm / convolution (2·M·N·K model), and
    whatever else ``FlopCounterMode`` counts; elementwise ignored.
  * bytes — an HBM-traffic model: operands + results of the matmul-class
    ops, plus the results of gathers, scatters, index/index_put, cat and
    in-place copies (cache writes), plus the step's inputs and outputs once.
    Pre-fusion, so an upper-ish bound, as the reference's.

Collective bytes (``collective_bytes``) are the result bytes of the
``_c10d_functional`` collectives a step issues on this rank — DTensor's
redistributions, explicit or inside an operation — under the reference's
keys. The reference parses them from partitioned HLO, where they are
per-device result shapes too.

The peaks are one NVIDIA H100 80GB HBM3's (SXM5, 700 W), datasheet values.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.core.tree import tree_leaves
from repro_torch.models.sharded import local_shards


@dataclass
class Costs:
    flops: float = 0.0
    bytes: float = 0.0
    by_prim: dict = field(default_factory=dict)
    collectives: dict = field(default_factory=dict)
    local_flops: float = 0.0   # this rank's own work: local shards, replicas counted
    local_bytes: float = 0.0

    def add(self, prim: str, flops: float, bytes_: float, mult: float) -> None:
        self.flops += flops * mult
        self.bytes += bytes_ * mult
        agg = self.by_prim.setdefault(prim, [0.0, 0.0])
        agg[0] += flops * mult
        agg[1] += bytes_ * mult


def _size_bytes(t: Any) -> float:
    if not isinstance(t, torch.Tensor):
        return 0.0
    return float(t.numel()) * t.element_size()


def _tensors(x: Any) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _tensors(item)]
    return []


_aten = torch.ops.aten
# operands + results cross HBM
_MATMUL = {_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm, _aten.convolution}
# results are genuine HBM writes (the reference's gather / scatter /
# dynamic_(update_)slice / take / concatenate)
_MEMORY = {_aten.embedding, _aten.gather, _aten.index, _aten.index_select, _aten.take,
           _aten.scatter, _aten.scatter_add, _aten.scatter_reduce, _aten.index_put,
           _aten.index_put_, _aten.index_add, _aten.index_add_, _aten.cat, _aten.copy_}

_c10d = torch.ops._c10d_functional
_COLLECTIVES = {
    _c10d.all_reduce: "all-reduce",
    _c10d.all_gather_into_tensor: "all-gather",
    _c10d.reduce_scatter_tensor: "reduce-scatter",
    _c10d.all_to_all_single: "all-to-all",
}
COLLECTIVE_KEYS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                   "collective-permute")


def _op_bytes(func_packet, args, out) -> float:
    """The byte model of one operation."""
    if func_packet in _MATMUL:
        return sum(_size_bytes(t) for t in (*_tensors(args), *_tensors(out)))
    if func_packet in _MEMORY:
        return sum(map(_size_bytes, _tensors(out)))
    return 0.0


class _StepCounter(FlopCounterMode):
    """``FlopCounterMode`` that also applies the byte model to every operation
    it sees, both scaled by ``local_shards()``."""

    def __init__(self, costs: Costs):
        super().__init__(display=False)
        self.costs = costs

    def _count_flops(self, func_packet, out, args, kwargs):
        before = self.get_total_flops()
        super()._count_flops(func_packet, out, args, kwargs)
        flops = float(self.get_total_flops() - before)
        b = _op_bytes(func_packet, args, out)
        if flops or b:
            self.costs.add(func_packet.__name__, flops, b, local_shards())
        return out


class _LocalCounter(TorchDispatchMode):
    """This rank's own work, and the result bytes of the collectives it
    issues. It lets DTensor dispatch first (``NotImplemented`` on DTensor
    operations, as ``CommDebugMode`` does), so it sees the local operations
    and the collectives inside them."""

    def __init__(self, costs: Costs):
        super().__init__()
        self.costs = costs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(t is DTensor for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = getattr(func, "_overloadpacket", None)
        key = _COLLECTIVES.get(packet)
        if key is not None:
            b = sum(map(_size_bytes, _tensors(out)))
            self.costs.collectives[key] = self.costs.collectives.get(key, 0.0) + b
        elif packet in flop_registry:
            self.costs.local_flops += float(flop_registry[packet](*args, **kwargs, out_val=out))
        self.costs.local_bytes += _op_bytes(packet, args, out)
        return out


def step_costs(fn, *args, **kwargs) -> tuple[Costs, Any]:
    """Run ``fn(*args, **kwargs)`` and count its flops, bytes and collective
    bytes — the counterpart of the reference's ``jaxpr_costs`` (which traces
    instead of running). The step's tensor inputs and outputs cross HBM
    once. → (costs, fn's result)."""
    costs = Costs()
    with _LocalCounter(costs), _StepCounter(costs):
        out = fn(*args, **kwargs)
    io = sum(_size_bytes(t) for t in (*tree_leaves(args), *tree_leaves(kwargs),
                                      *tree_leaves(out)))
    costs.add("program_io", 0.0, io, 1.0)
    costs.local_bytes += sum(_size_bytes(t.to_local() if hasattr(t, "to_local") else t)
                             for t in (*tree_leaves(args), *tree_leaves(kwargs),
                                       *tree_leaves(out)))
    return costs, out


def collective_bytes(costs: Costs) -> dict:
    """Per-collective result bytes under the reference's keys, and their
    ``total``."""
    out = {k: float(costs.collectives.get(k, 0.0)) for k in COLLECTIVE_KEYS}
    out["total"] = sum(out.values())
    return out


# ---------------------------------------------------------------------------
# roofline terms: one NVIDIA H100 80GB HBM3 (SXM5, 700 W), datasheet values
# ---------------------------------------------------------------------------

PEAK_FLOPS_BF16 = 989.4e12     # dense bf16 tensor-core FLOP/s per card
HBM_BW = 3.35e12               # HBM3 bytes/s per card
NVLINK_BW = 450e9              # NVLink 4 bytes/s per card, each way


def roofline_terms(
    *, total_flops: float, total_bytes: float, coll_bytes: float, chips: int
) -> dict:
    compute_s = total_flops / (chips * PEAK_FLOPS_BF16)
    memory_s = total_bytes / (chips * HBM_BW)
    collective_s = coll_bytes / (chips * NVLINK_BW)
    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": collective_s}
    terms["bottleneck"] = max(terms, key=lambda k: terms[k] if k.endswith("_s") else -1)
    return terms


def model_flops_train(n_params: int, n_tokens: int, active_fraction: float = 1.0) -> float:
    """6·N·D (fwd+bwd); MoE uses active params."""
    return 6.0 * n_params * active_fraction * n_tokens


def model_flops_infer(n_params: int, n_tokens: int, active_fraction: float = 1.0) -> float:
    return 2.0 * n_params * active_fraction * n_tokens
