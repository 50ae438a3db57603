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
``torch.optim.Adam``. Implemented: sgd (+momentum/nesterov), adam, adamw and
the constant / linear / warmup-cosine schedules. adafactor, clipping and
accumulation come with the LLM slice (ROADMAP Queue 1, slice 2).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.tree import tree_map

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
    """params += updates, in place (cast to each parameter's dtype)."""
    return tree_map(lambda p, u: p.add_(u.to(p.dtype)), params, updates)


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


OPTIMIZERS = {"sgd": sgd, "adam": adam, "adamw": adamw}


def get_optimizer(name: str, lr, **kwargs) -> Optimizer:
    if name not in OPTIMIZERS:
        raise KeyError(f"unknown optimizer {name!r}; options {sorted(OPTIMIZERS)}")
    return OPTIMIZERS[name](lr, **kwargs)
