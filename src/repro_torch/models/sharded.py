"""The model on a device mesh: what the port needs where the reference lets
GSPMD partition the same code.

With a mesh, a model's parameters (and a serving cache) are DTensors placed
by ``repro_torch.launch.sharding``, and the model's tensor code runs on them
through DTensor's own sharding rules, under ``implicit_replication`` so that
the plain tensors it makes (positions, masks) count as replicated. The
kernels never see a DTensor: ``on_local_shards`` runs a kernel op through
``local_map`` on each rank's shard, batch on the data axes and heads on
"model" (replicated where they do not divide), so each rank's kernel sees
whole heads and attention needs no collective inside it. Where DTensor has
no rule, ``replicated`` runs plain code on whole tensors.

Without a mesh none of this runs: every function here passes plain tensors
through unchanged.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import implicit_replication, local_map

from repro_torch.core.tree import tree_leaves, tree_map


# How many ranks split the work now running on local shards (1 outside
# ``on_local_shards``): a cost counter scales what it sees by it, to count
# the logical (global) work.
_LOCAL_SHARDS: contextvars.ContextVar[int] = contextvars.ContextVar("local_shards", default=1)


def local_shards() -> int:
    return _LOCAL_SHARDS.get()


def is_dtensor(t: Any) -> bool:
    return isinstance(t, DTensor)


def on_mesh(tree: Any) -> bool:
    """Whether a tree's leaves are DTensors (its first leaf decides)."""
    leaves = tree_leaves(tree)
    return bool(leaves) and is_dtensor(leaves[0])


def mesh_mode(tree: Any) -> contextlib.AbstractContextManager:
    """``implicit_replication`` when ``tree`` lives on a mesh, else nothing."""
    return implicit_replication() if on_mesh(tree) else contextlib.nullcontext()


def serving_mode(params: Any) -> contextlib.AbstractContextManager:
    """The serving steps' context: ``inference_mode`` on plain tensors;
    ``no_grad`` and ``implicit_replication`` on a mesh (DTensor's views
    cannot be made of inference tensors)."""
    if not on_mesh(params):
        return torch.inference_mode()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.no_grad())
    stack.enter_context(implicit_replication())
    return stack


def _local_sharding(mesh, t: torch.Tensor, head: int | None) -> tuple:
    """Batch dim 0 on the data axes and dim ``head`` on "model", resolved as
    the launch layer resolves every spec (an axis that does not divide its
    dim is dropped), so a cache placed by ``serve_cache_spec`` needs no
    redistribution."""
    from repro_torch.launch.sharding import P, _dp, resolve

    spec = [None] * t.dim()
    if t.dim() > 1:
        spec[0] = _dp(mesh)
    if head is not None:
        spec[head] = "model"
    return resolve(P(*spec), tuple(t.shape), mesh).placements


def on_local_shards(op: Callable, tensors: tuple, heads: tuple, out_like: tuple = (0,),
                    **kwargs) -> Any:
    """``op(*tensors, **kwargs)``; on DTensors through ``local_map``: each
    tensor is redistributed to batch dim 0 over the data axes and dim
    ``heads[i]`` over "model" (``None``: no head dim), and output j comes
    back placed like input ``out_like[j]`` (one entry: a single tensor).
    Each rank's ``op`` sees whole heads of its batch shard."""
    if not is_dtensor(tensors[0]):
        return op(*tensors, **kwargs)
    mesh = tensors[0].device_mesh
    ins = tuple(list(_local_sharding(mesh, t, h)) for t, h in zip(tensors, heads))
    outs = tuple(ins[i] for i in out_like)  # a list per output; a tuple of them for several
    shards = math.prod(mesh.size(i) for i, p in enumerate(ins[0]) if p.is_shard())

    def run(*ts):
        ts = _Enter.apply(*ts) if torch.is_grad_enabled() else ts
        token = _LOCAL_SHARDS.set(shards)
        try:
            out = op(*ts, **kwargs)
        finally:
            _LOCAL_SHARDS.reset(token)
        if torch.is_grad_enabled():
            out = _Exit.apply(shards, *(out if isinstance(out, tuple) else (out,)))
            out = out if len(out) > 1 else out[0]
        return out

    fn = local_map(run, out_placements=outs[0] if len(outs) == 1 else outs,
                   in_placements=ins, device_mesh=mesh, redistribute_inputs=True)
    return fn(*tensors)


class _Enter(torch.autograd.Function):
    """Identity into local work; its backward, the last of that work's,
    ends the shard count ``_Exit``'s backward began and hands DTensor
    contiguous grads."""

    @staticmethod
    def forward(ctx, *ts):
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *grads):
        _LOCAL_SHARDS.set(1)
        # DTensor views its local grads, which a permuted product leaves strided
        return tuple(g.contiguous() for g in grads)


class _Exit(torch.autograd.Function):
    """Identity out of local work; its backward, the first of that work's,
    sets the shard count so a cost counter scales the backward too."""

    @staticmethod
    def forward(ctx, shards, *ts):
        ctx.shards = shards
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *grads):
        _LOCAL_SHARDS.set(ctx.shards)
        return (None, *grads)


class _WholeGrad(torch.autograd.Function):
    """Identity whose backward gathers dim ``dim`` of the grad whole."""

    @staticmethod
    def forward(ctx, t, dim):
        ctx.dim = dim
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return unshard(grad, ctx.dim), None


def merge_dims(t: torch.Tensor, start: int) -> torch.Tensor:
    """``t`` with dims ``start``… flattened into one (e.g. (…, H, hd) into
    H·hd columns). On a DTensor the grad of the result is gathered along that
    dim first: a row-parallel product hands back a grad sharded there, which
    DTensor cannot unflatten into heads that do not divide over the mesh."""
    out = t.flatten(start)
    if is_dtensor(t) and torch.is_grad_enabled() and t.requires_grad:
        out = _WholeGrad.apply(out, -1)
    return out


def split_dim(t: torch.Tensor, dim: int, sizes: tuple) -> torch.Tensor:
    """``t`` with dim ``dim`` split into ``sizes`` (e.g. a projection's
    H·hd columns into (H, hd)). A DTensor shards a split dim on its first
    part, so where ``sizes[0]`` does not divide over the mesh dims sharding
    ``dim`` (a shard that splits a head), those mesh dims are replicated
    first: an all-gather of ``t`` over them."""
    dim = dim % t.dim()
    shape = (*t.shape[:dim], *sizes, *t.shape[dim + 1:])
    if not is_dtensor(t):
        return t.reshape(shape)
    ranks = math.prod(t.device_mesh.size(i) for i, p in enumerate(t.placements)
                      if p.is_shard(dim))
    if sizes[0] % ranks:
        t = unshard(t, dim)
    return t.reshape(shape)


def reduce_partial(t: torch.Tensor) -> torch.Tensor:
    """A row-parallel product's partial sums, reduced (an all-reduce over the
    mesh dims that hold them) so activations stay batch-sharded and whole
    along every other dim, as in Megatron-style tensor parallelism; left to
    itself DTensor may reduce-scatter them onto the sequence dim instead."""
    if not is_dtensor(t) or not any(p.is_partial() for p in t.placements):
        return t
    pl = [Replicate() if p.is_partial() else p for p in t.placements]
    return t.redistribute(t.device_mesh, pl)


def write_at(dst: torch.Tensor, dim: int, index, src) -> None:
    """``dst[(:,) * dim, index] = src`` in place: a ring cache's slots. On a
    DTensor whose ``dim`` is whole on every rank (serving's caches), ``src``
    is placed like ``dst`` and each rank writes its own shard (DTensor has
    no rule for ``index_put_`` everywhere); a ``dim`` split over ranks (the
    dry run's sequence-parallel ring) is left to DTensor."""
    idx = (slice(None),) * dim + (index,)
    if is_dtensor(dst) and not any(p.is_shard(dim) for p in dst.placements):
        if is_dtensor(src):
            src = src.redistribute(dst.device_mesh, dst.placements).to_local()
        dst.to_local()[idx] = src
    else:
        dst[idx] = src


def fsdp_gather(w: torch.Tensor) -> torch.Tensor:
    """A weight whole along the data axes (FSDP's all-gather before use),
    still split on "model". Left to itself DTensor may instead shard the
    contraction over the data axes and drop the batch's sharding."""
    if not is_dtensor(w):
        return w
    names = w.device_mesh.mesh_dim_names
    pl = [Replicate() if names[i] != "model" and p.is_shard() else p
          for i, p in enumerate(w.placements)]
    return w if pl == list(w.placements) else w.redistribute(w.device_mesh, pl)


def unshard(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` whole along ``dim`` (an all-gather over the mesh dims that shard
    it); other placements kept. A plain tensor passes through."""
    if not is_dtensor(t):
        return t
    dim = dim % t.dim()
    pl = [Replicate() if p.is_shard(dim) else p for p in t.placements]
    return t.redistribute(t.device_mesh, pl)


def replicated(fn: Callable) -> Callable:
    """``fn`` run on whole tensors: the DTensors among its arguments (trees
    included) are replicated first and its tensor results come back as
    replicated DTensors. For code DTensor has no rule for (the MoE
    dispatch); it costs an all-gather of every sharded argument."""
    def wrapped(*args, **kwargs):
        dts = [a for a in tree_leaves((args, kwargs)) if is_dtensor(a)]
        if not dts:
            return fn(*args, **kwargs)
        mesh = dts[0].device_mesh
        rep = tuple(Replicate() for _ in mesh.shape)

        def whole(a):
            return a.redistribute(mesh, rep).to_local() if is_dtensor(a) else a

        out = fn(*tree_map(whole, args), **tree_map(whole, kwargs))
        return tree_map(lambda o: DTensor.from_local(o, mesh, rep, run_check=False)
                        if isinstance(o, torch.Tensor) else o, out)

    return wrapped
