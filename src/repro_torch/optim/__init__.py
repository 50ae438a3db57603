"""Optimizers and schedules — the port of ``repro.optim``, with its math.

API: an ``Optimizer`` is a pair of functions
    init(params)                  -> state
    update(grads, state, params)  -> (updates, new_state)
applied with ``apply_updates(params, updates)`` (updates are *added*).
Unlike the reference, the moment buffers are updated in place and
``apply_updates`` adds into the parameter tensors: the port keeps one set of
parameter and moment tensors for the whole run.

Adam follows the reference exactly — ``m/bc1 / (sqrt(v/bc2) + eps)`` —
which places eps and the bias corrections differently from
``torch.optim.Adam``. Implemented, as in the reference: sgd
(+momentum/nesterov), adam, adamw, adafactor (factored second moments),
global-norm clipping, gradient accumulation, and the constant / linear /
warmup-cosine schedules. ``load_jax_opt_state`` carries an optimizer state of
the reference (numpy leaves) over to the port's layout.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.tree import (
    as_tensor, tree_flatten_with_path, tree_leaves, tree_map, tree_unflatten,
)
from repro_torch.kernels import resolve_device

PyTree = Any
Schedule = Callable[[int], float]  # step -> lr


# --------------------------------------------------------------------------
# Schedules (float32 arithmetic, as the reference's jnp schedules)
# --------------------------------------------------------------------------


def constant_schedule(lr: float) -> Schedule:
    return lambda step: float(np.float32(lr))


def linear_schedule(lr: float, total_steps: int, end_fraction: float = 0.0) -> Schedule:
    def fn(step):
        frac = np.clip(np.float32(step) / np.float32(max(1, total_steps)), 0.0, 1.0)
        return float(np.float32(lr * (1.0 - (1.0 - end_fraction) * frac)))

    return fn


def warmup_cosine_schedule(lr: float, warmup_steps: int, total_steps: int,
                           min_ratio: float = 0.1) -> Schedule:
    def fn(step):
        step = np.float32(step)
        warm = step / np.float32(max(1.0, warmup_steps))
        progress = (step - np.float32(warmup_steps)) / np.float32(max(1.0, total_steps - warmup_steps))
        progress = np.clip(progress, np.float32(0.0), np.float32(1.0))
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + np.cos(np.float32(np.pi) * progress))
        return float(np.float32(lr * (warm if step < warmup_steps else cos)))

    return fn


def _resolve_schedule(lr) -> Schedule:
    return lr if callable(lr) else constant_schedule(float(lr))


# --------------------------------------------------------------------------
# Optimizer core
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[PyTree], dict]
    update: Callable[[PyTree, dict, PyTree], tuple[PyTree, dict]]
    name: str = "optimizer"


@torch.no_grad()
def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    """params += updates, in place. A floating parameter takes the sum in the
    update's f32, rounded once to its own dtype, as the reference's
    ``(p + u).astype(p.dtype)`` does: a bf16 weight is not moved by an update
    rounded to bf16 first."""
    return tree_map(lambda p, u: p.add_(u if p.is_floating_point() else u.to(p.dtype)),
                    params, updates)


class ScaleState(NamedTuple):
    step: int


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p, dtype=torch.float32)


def sgd(lr, momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    sched = _resolve_schedule(lr)

    def init(params):
        return {"step": 0, "momentum": tree_map(_zeros_f32, params) if momentum else None}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = sched(step)
        if momentum:
            buf = tree_map(lambda b, g: b.mul_(momentum).add_(g.float()),
                           state["momentum"], grads)
            if nesterov:
                upd = tree_map(lambda b, g: -(lr_t * (momentum * b + g)), buf, grads)
            else:
                upd = tree_map(lambda b: -(lr_t * b), buf)
            return upd, {"step": step, "momentum": buf}
        return tree_map(lambda g: -(lr_t * g.float()), grads), {"step": step, "momentum": None}

    return Optimizer(init, update, "sgd")


def _adam_core(lr, b1, b2, eps, weight_decay, name) -> Optimizer:
    sched = _resolve_schedule(lr)

    def init(params):
        return {"step": 0, "m": tree_map(_zeros_f32, params),
                "v": tree_map(_zeros_f32, params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = sched(step)
        m = tree_map(lambda m_, g: m_.mul_(b1).add_((1 - b1) * g.float()), state["m"], grads)
        v = tree_map(lambda v_, g: v_.mul_(b2).add_((1 - b2) * torch.square(g.float())),
                     state["v"], grads)
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(step))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(step))

        def _upd(m_, v_, p):
            u = -(lr_t * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps))
            if weight_decay:
                u = u - lr_t * weight_decay * p.float()
            return u

        return tree_map(_upd, m, v, params), {"step": step, "m": m, "v": v}

    return Optimizer(init, update, name)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, 0.0, "adam")


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, weight_decay, "adamw")


def adafactor(lr, eps: float = 1e-30, decay: float = 0.8) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern 2018, simplified),
    the reference's: a leaf of rank ≥ 2 keeps row and column means of the
    squared gradient (``vr`` over the last axis, ``vc`` over the one before),
    others a full ``v``; β_t = 1 − t^(−decay) in f32."""
    sched = _resolve_schedule(lr)

    def init(params):
        def per_leaf(p):
            if p.dim() >= 2:
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                          device=p.device)}
            return {"v": _zeros_f32(p)}

        return {"step": 0, "moments": tree_map(per_leaf, params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = sched(step)
        beta = float(np.float32(1.0) - np.float32(step) ** np.float32(-decay))

        def per_leaf(g, mom):
            g = g.float()
            g2 = torch.square(g) + eps
            if "vr" in mom:
                vr = mom["vr"].mul_(beta).add_((1 - beta) * g2.mean(dim=-1))
                vc = mom["vc"].mul_(beta).add_((1 - beta) * g2.mean(dim=-2))
                row_mean = torch.clamp(vr.mean(dim=-1, keepdim=True)[..., None], min=eps)
                denom = torch.sqrt(vr[..., :, None] * vc[..., None, :] / row_mean)
                return -(lr_t * g / torch.clamp(denom, min=1e-12))
            v = mom["v"].mul_(beta).add_((1 - beta) * g2)
            return -(lr_t * g / torch.sqrt(v))

        moments = state["moments"]
        leaves, treedef = tree_flatten_with_path(grads)
        upd = tree_unflatten(treedef, [per_leaf(g, _at(moments, path)) for path, g in leaves])
        return upd, {"step": step, "moments": moments}

    return Optimizer(init, update, "adafactor")


def _at(tree: PyTree, path: tuple) -> Any:
    for key in path:
        tree = tree[key]
    return tree


# --------------------------------------------------------------------------
# Gradient transforms
# --------------------------------------------------------------------------


def global_norm(tree: PyTree) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_by_global_norm(grads: PyTree, max_norm: float) -> PyTree:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads)


def chain_clip(optimizer: Optimizer, max_norm: float) -> Optimizer:
    def update(grads, state, params):
        return optimizer.update(clip_by_global_norm(grads, max_norm), state, params)

    return Optimizer(optimizer.init, update, f"{optimizer.name}+clip{max_norm}")


def with_accumulation(optimizer: Optimizer, accumulate_steps: int) -> Optimizer:
    """Gradient accumulation: buffers grads; applies the inner optimizer every
    ``accumulate_steps`` micro-steps (paper §4.4 uses accumulation of 10)."""
    if accumulate_steps <= 1:
        return optimizer

    def init(params):
        return {"inner": optimizer.init(params), "acc": tree_map(_zeros_f32, params),
                "count": 0}

    @torch.no_grad()
    def update(grads, state, params):
        acc = tree_map(lambda a, g: a.add_(g.float() / accumulate_steps), state["acc"], grads)
        count = state["count"] + 1
        if count >= accumulate_steps:
            upd, inner = optimizer.update(acc, state["inner"], params)
            tree_map(lambda a: a.zero_(), acc)
            return upd, {"inner": inner, "acc": acc, "count": 0}
        upd = tree_map(_zeros_f32, params)
        return upd, {"inner": state["inner"], "acc": acc, "count": count}

    return Optimizer(init, update, f"{optimizer.name}+acc{accumulate_steps}")


OPTIMIZERS = {"sgd": sgd, "adam": adam, "adamw": adamw, "adafactor": adafactor}


def get_optimizer(name: str, lr, **kwargs) -> Optimizer:
    if name not in OPTIMIZERS:
        raise KeyError(f"unknown optimizer {name!r}; options {sorted(OPTIMIZERS)}")
    return OPTIMIZERS[name](lr, **kwargs)


def load_jax_opt_state(state: Any, *, device: "str | torch.device" = "cuda") -> Any:
    """An optimizer state of the reference (``np.asarray`` of each leaf, e.g.
    adamw's ``{"step", "m", "v"}``, adafactor's factored ``moments``,
    ``with_accumulation``'s ``{"inner", "acc", "count"}``) as the port's: every
    0-d integer leaf (a step or count) a Python int, every other array a
    tensor of its own dtype on ``device`` (a copy), ``None`` kept."""
    dev = resolve_device(device)

    def convert(x):
        if isinstance(x, dict):
            return {k: convert(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(convert(v) for v in x)
        if x is None:
            return None
        a = np.asarray(x)
        if a.ndim == 0 and np.issubdtype(a.dtype, np.integer):
            return int(a)
        return as_tensor(np.array(a, copy=True)).to(dev)

    return convert(state)
