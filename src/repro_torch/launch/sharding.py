"""Parameter / batch / cache sharding rules with a divisibility resolver — the
port of ``repro.launch.sharding``.

The rules are the reference's, path for path: aligned to the **trailing**
dims of each leaf, so they apply alike to plain params, layer-stacked params
(leading group axis), optimizer moments (``m/…`` and ``v/…`` mirror param
paths) and ring caches. A spec is a ``P``, a tuple of per-dim mesh axes
(``None``, an axis name, or a tuple of names) that compares equal, element by
element, to the reference's ``PartitionSpec``.

``resolve`` drops any axis that does not divide its dim, with the reference's
two fallbacks, and turns the spec into DTensor placements: one per mesh dim,
``Shard(i)`` where tensor dim i names that axis (or a tuple that holds it:
``("pod", "data")`` shards one dim over two mesh dims, pod outer) and
``Replicate()`` otherwise.

``cache_spec`` is the reference's: the ring's C dim on "model", which XLA
serves with partial-softmax collectives. The port's attention kernels cannot
merge partial softmaxes across ranks, so serving places its caches with
``serve_cache_spec`` instead (batch on the data axes, KV or SSM heads on
"model"), and ``cache_spec`` is used as the reference uses it, by the dry
run only.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.core.tree import path_str, tree_flatten_with_path, tree_map, tree_unflatten

from .mesh import data_axes

# column-parallel matmuls: shard OUTPUT (last) dim on "model";
# FSDP additionally shards the input (second-to-last) dim on the data axes.
_COL = re.compile(
    r"(wq|wk|wv|wi|wg|wq_a|wq_b|wkv_a|wk_rope|wk_b|wv_b|w_gate|w_rec|w_z|w_x|w_B|w_C|w_dt|w_a)/w$"
)
# row-parallel matmuls: shard INPUT (second-to-last) dim on "model".
_ROW = re.compile(r"(wo|out_proj|w_out)/w$")
_EMBED = re.compile(r"(embed|unembed)/table$")
_ROUTER = re.compile(r"router/w$")

# cache leaves (trailing-dims layout)
_CACHE_KV = {"k": 4, "v": 4}          # (..., B, C, KV, hd)
_CACHE_LATENT = {"c_kv": 3, "k_rope": 3}  # (..., B, C, R)
_CACHE_STATE = {"conv": 3, "ssm": 4, "h": 2}  # (..., B, rest...)


class P(tuple):
    """A partition spec: one entry per tensor dim (trailing dims may be left
    out), each ``None``, a mesh axis name or a tuple of names."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _pad_spec(ndim: int, trailing: list) -> P:
    return P(*([None] * (ndim - len(trailing)) + trailing))


def param_spec(path: str, ndim: int, *, fsdp: bool, dp) -> P:
    """Trailing-dim aligned spec for a parameter leaf."""
    if ndim < 2:
        return P()
    if _EMBED.search(path):
        return _pad_spec(ndim, ["model", dp if fsdp else None])
    if _ROUTER.search(path):
        return P()
    if _COL.search(path):
        return _pad_spec(ndim, [dp if fsdp else None, "model"])
    if _ROW.search(path):
        return _pad_spec(ndim, ["model", dp if fsdp else None])
    return P()


def cache_spec(path: str, ndim: int, *, dp) -> P:
    """The reference's cache rule: KV caches with batch on the data axes and
    the ring/seq dim on "model" (a sequence-parallel cache); states with
    batch on the data axes only."""
    leaf = path.rsplit("/", 1)[-1]
    if leaf in _CACHE_KV:
        return _pad_spec(ndim, [dp, "model", None, None])
    if leaf in _CACHE_LATENT:
        return _pad_spec(ndim, [dp, "model", None])
    if leaf in ("cross_k", "cross_v"):
        return _pad_spec(ndim, [dp, None, None, None])
    if leaf in _CACHE_STATE:
        n_rest = {"conv": 2, "ssm": 3, "h": 1}[leaf]
        return _pad_spec(ndim, [dp] + [None] * n_rest)
    return P()  # slot_pos etc.


def serve_cache_spec(path: str, ndim: int, *, dp) -> P:
    """Serving's cache rule: each rank's kernel sees whole heads. Batch on the
    data axes; GQA k/v on "model" by KV head and the SSM state by head; MLA
    latents, conv windows and RG-LRU states by batch only."""
    leaf = path.rsplit("/", 1)[-1]
    if leaf in _CACHE_KV:
        return _pad_spec(ndim, [dp, None, "model", None])
    if leaf == "ssm":
        return _pad_spec(ndim, [dp, "model", None, None])
    n = {**_CACHE_LATENT, **_CACHE_STATE, "cross_k": 4, "cross_v": 4}.get(leaf)
    if n:
        return _pad_spec(ndim, [dp] + [None] * (n - 1))
    return P()


def batch_spec(ndim: int, *, dp) -> P:
    return _pad_spec(ndim, [dp] + [None] * (ndim - 1))


def axis_sizes(mesh: DeviceMesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def resolve_spec(spec: P, shape: tuple, sizes: dict[str, int]) -> P:
    """The reference's ``resolve`` on axis sizes: drop axes that don't divide
    their dim (fallback 1: the last axis of a tuple alone; fallback 2:
    replicate)."""
    out = []
    for dim, axis in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if axis is None:
            out.append(None)
            continue
        axes = axis if isinstance(axis, tuple) else (axis,)
        size = math.prod(sizes[a] for a in axes)
        if dim % size == 0:
            out.append(axis)
        elif isinstance(axis, tuple) and len(axis) > 1 and dim % sizes[axis[-1]] == 0:
            out.append(axis[-1])
        else:
            out.append(None)
    return P(*out)


def placements(spec: P, mesh_axes: tuple[str, ...]) -> tuple:
    """DTensor placements of a resolved spec, one per mesh dim."""
    out = []
    for name in mesh_axes:
        dims = [i for i, a in enumerate(spec)
                if a == name or (isinstance(a, tuple) and name in a)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


@dataclass(frozen=True, eq=False)
class Sharding:
    """A resolved spec on a mesh (the counterpart of ``NamedSharding``)."""

    mesh: DeviceMesh
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh.mesh_dim_names)


def resolve(spec: P, shape: tuple, mesh: DeviceMesh) -> Sharding:
    """Drop axes that don't divide their dim; returns a ``Sharding``."""
    return Sharding(mesh, resolve_spec(spec, tuple(shape), axis_sizes(mesh)))


def _dp(mesh: DeviceMesh):
    axes = data_axes(mesh)
    return axes if len(axes) > 1 else axes[0]


def tree_shardings(tree: Any, mesh: DeviceMesh, spec_fn: Callable[[str, int], P]) -> Any:
    """Map (path, leaf) → resolved ``Sharding`` over a tree of tensors (real,
    meta or fake)."""
    leaves, treedef = tree_flatten_with_path(tree)
    return tree_unflatten(treedef, [
        resolve(spec_fn(path_str(p), leaf.dim()), leaf.shape, mesh)
        if isinstance(leaf, torch.Tensor) else Sharding(mesh, P())  # e.g. a step count
        for p, leaf in leaves])


def param_shardings(params: Any, mesh: DeviceMesh, *, fsdp: bool = False) -> Any:
    dp = _dp(mesh)
    return tree_shardings(params, mesh, lambda p, nd: param_spec(p, nd, fsdp=fsdp, dp=dp))


def opt_state_shardings(opt_state: Any, mesh: DeviceMesh, *, fsdp: bool = False) -> Any:
    # optimizer moment paths embed the param path ("m/blocks/.../wq/w"),
    # so the same rules apply; scalars and factored moments replicate.
    dp = _dp(mesh)
    return tree_shardings(opt_state, mesh, lambda p, nd: param_spec(p, nd, fsdp=fsdp, dp=dp))


def cache_shardings(cache: Any, mesh: DeviceMesh) -> Any:
    dp = _dp(mesh)
    return tree_shardings(cache, mesh, lambda p, nd: cache_spec(p, nd, dp=dp))


def serve_cache_shardings(cache: Any, mesh: DeviceMesh) -> Any:
    dp = _dp(mesh)
    return tree_shardings(cache, mesh, lambda p, nd: serve_cache_spec(p, nd, dp=dp))


def batch_shardings(batch: Any, mesh: DeviceMesh) -> Any:
    dp = _dp(mesh)
    return tree_shardings(batch, mesh, lambda p, nd: batch_spec(nd, dp=dp))


def distribute(tree: Any, shardings: Any) -> Any:
    """Place each leaf of ``tree`` (real, meta or fake tensors, whole on
    every rank) with its ``Sharding``: every rank keeps its own shard, so
    nothing is sent (the counterpart of ``with_shardings``)."""
    def one(leaf, sh: Sharding):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return distribute_tensor(leaf, sh.mesh, sh.placements, src_data_rank=None)

    return tree_map(one, tree, shardings)
