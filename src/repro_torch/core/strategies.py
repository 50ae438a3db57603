"""Federated aggregation strategies, executed CLIENT-SIDE (serverless), on the
device.

The port of ``repro.core.strategies``: every client owns a strategy instance
and aggregates whatever it pulls from the weight store with its own weights
inserted (Algorithm 1). "Server-side" optimizers (FedAvgM / FedAdam / FedYogi
/ FedAdagrad, Reddi et al. 2021) keep their momentum/moment buffers on the
client.

Execution model: the store pulls ``FlatUpdate``s (host f32 vectors sharing
one interned ``LeafSpec``); each strategy copies them into a (K, N) stack on
its ``device`` and aggregates there. A peer's row is re-uploaded only when its
source flat is a different object than last round (the store's decode cache
returns the same array for an unchanged peer); the own row is written every
round. On a CUDA stack every combine is one launch of the hand-written
``fed_agg`` kernel and every FedAdam/FedYogi/FedAdagrad step one launch of
``fed_opt``, for any K >= 1. On a CPU stack the plain PyTorch versions run.
The aggregate comes back as a tree of tensors on the device that *view* the
strategy's output buffer; the trainer copies it into its own parameters.

Coefficients (example-count means, FedAsync's lerp-chain factors) are
float32 numpy on the host, computed exactly as the reference computes them,
then uploaded as K floats, so their rounding equals the reference's.
"""
from __future__ import annotations

import re
from abc import ABC, abstractmethod
from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels import resolve_device
from repro_torch.kernels.fed_agg import ops as fed_agg_ops

from .serialize import NodeUpdate
from .telemetry import child_span
from .tree import LeafSpec, PyTree, tree_leaves, tree_unflatten

# Stack rows start on 128-byte boundaries, so the kernel reads them as float4
# whatever N is (ResNet-18's N is 2 mod 4).
_ROW_ALIGN = 32


class _StackCache:
    """Reusable (K, N) stack on the device, rows padded to ``_ROW_ALIGN``.
    A row is re-uploaded only when its source flat is a *different array
    object* than last round; tree-only updates (own, fresh from the trainer)
    are flattened straight into their row every round."""

    def __init__(self, device: torch.device):
        self.device = device
        self._rows: list = []  # source array per row (held → identities stay valid)
        self._buf: torch.Tensor | None = None
        self._shape: tuple[int, int] | None = None

    def stack(self, spec: LeafSpec, updates: Sequence[NodeUpdate]) -> torch.Tensor:
        k, n = len(updates), spec.num_params
        if self._shape != (k, n):
            ld = -(-n // _ROW_ALIGN) * _ROW_ALIGN
            self._buf = torch.empty((k, ld), dtype=torch.float32, device=self.device)
            self._shape = (k, n)
            self._rows = [None] * k
        view = self._buf[:, :n]
        for i, u in enumerate(updates):
            flat = getattr(u, "flat", None)
            if flat is not None and spec.compatible(u.spec):
                if self._rows[i] is not flat:
                    view[i].copy_(torch.from_numpy(flat))
                self._rows[i] = flat
            else:
                spec.flatten_into(u.params, view[i])
                self._rows[i] = None  # trees are rewritten every round
        return view


class Strategy(ABC):
    """Client-side aggregation strategy over a device-resident stack.

    ``device`` (default ``cuda``) holds the stack, the output buffer and any
    optimizer state; asking for CUDA without a card raises. ``use_kernel``
    stays in the signatures for source compatibility with the reference: on
    the card the device decides, and every combine is a kernel launch.
    """

    name: str = "strategy"

    def __init__(self, *, use_kernel: bool = False, reuse_output: bool = False,
                 device: "str | torch.device" = "cuda"):
        self.use_kernel = use_kernel
        # reuse_output=True returns trees that VIEW a strategy-owned buffer,
        # valid only until the next aggregate() call. Default False: every
        # aggregate returns fresh storage.
        self.reuse_output = reuse_output
        self.device = resolve_device(device)
        self._spec: LeafSpec | None = None
        self._stack = _StackCache(self.device)
        self._bufs: dict[str, torch.Tensor] = {}
        # Kernel launches this strategy's aggregates made (on a CUDA stack
        # every combine is a launch), never reset: a node reads them to count
        # its own launches, also where it runs in a child process.
        self.launches = {"fed_agg": 0, "fed_opt": 0}

    # -- flat plumbing -------------------------------------------------------
    def _resolve_spec(self, own: NodeUpdate) -> LeafSpec:
        """own's spec when the store handed us a FlatUpdate, else a spec
        built once and reused while own's structure is stable."""
        spec = getattr(own, "spec", None)
        if spec is not None:
            self._spec = spec
            return spec
        spec = self._spec
        if spec is not None and spec.describes(own.params):
            return spec
        spec = LeafSpec.of(own.params)
        self._spec = spec
        return spec

    def _stacked(self, spec: LeafSpec, updates: Sequence[NodeUpdate]) -> torch.Tensor:
        """The (K, N) stack, in an ``aggregate.stack`` span under the caller's
        open span (the node's ``aggregate``). Its rows go up from pageable host
        memory, so the span holds their copies to the card."""
        with child_span("aggregate.stack"):
            return self._stack.stack(spec, updates)

    def _buffer(self, name: str, spec: LeafSpec) -> torch.Tensor:
        """Named warm device vector (never escapes unless ``reuse_output``)."""
        buf = self._bufs.get(name)
        if buf is None or buf.numel() != spec.num_params:
            buf = torch.empty(spec.num_params, dtype=torch.float32, device=self.device)
            self._bufs[name] = buf
        return buf

    def _out_buf(self, spec: LeafSpec) -> torch.Tensor | None:
        return self._buffer("out", spec) if self.reuse_output else None

    def _emit(self, spec: LeafSpec, state: torch.Tensor) -> torch.Tensor:
        """Detach internal state for the caller: a fresh copy by default, the
        reusable out buffer under ``reuse_output``."""
        if self.reuse_output:
            return self._buffer("out", spec).copy_(state)
        return state.clone()

    def _combine(self, stacked: torch.Tensor, coeffs: np.ndarray, *,
                 out: torch.Tensor | None = None) -> torch.Tensor:
        """Σ_k coeffs[k]·stacked[k] — THE aggregation primitive: one ``fed_agg``
        launch on the card, the plain version on the CPU. The coefficients need
        not be normalized (FedAsync's lerp chain shares this code). Its
        ``aggregate.combine`` span times the launch as the host issues it: the
        card finishes later."""
        with child_span("aggregate.combine"):
            result = fed_agg_ops.aggregate_flat(stacked, coeffs, out=out)
        if stacked.is_cuda:
            self.launches["fed_agg"] += 1
        return result

    def _mean_coeffs(self, updates: Sequence[NodeUpdate]) -> np.ndarray:
        weights = np.asarray([max(1, u.num_examples) for u in updates], np.float32)
        return weights / weights.sum()

    def _weighted_mean(self, spec: LeafSpec, updates: Sequence[NodeUpdate], *,
                       out: torch.Tensor | None = None) -> torch.Tensor:
        """Example-count weighted mean (FedAvg, eq. 1) over the stack."""
        return self._combine(self._stacked(spec, updates),
                             self._mean_coeffs(updates), out=out)

    @abstractmethod
    def aggregate(self, own: NodeUpdate, peers: Sequence[NodeUpdate]) -> PyTree:
        """Combine own latest params with peer updates → new local params."""

    # -- recoverable optimizer state ------------------------------------------
    def state_dict(self) -> dict[str, torch.Tensor] | None:
        """Named flat vectors a restarted node needs to resume this
        strategy's server-optimizer trajectory; ``None`` when stateless."""
        return None

    def load_state_dict(self, state: dict) -> None:
        """Restore ``state_dict`` output (a no-op on mismatch: a recovered
        blob from an older structure starts the node cold, never crashes it)."""

    def _flat_state(self, state: dict, *names: str) -> "list[torch.Tensor] | None":
        """Validate + upload recovery arrays: all present, equal sizes."""
        try:
            vecs = [np.asarray(state[n], np.float32).reshape(-1) for n in names]
        except (KeyError, TypeError, ValueError):
            return None
        if len({v.size for v in vecs}) != 1:
            return None
        return [torch.from_numpy(v.copy()).to(self.device) for v in vecs]

    def reset(self) -> None:  # stateful subclasses extend
        self._spec = None
        self._stack = _StackCache(self.device)
        self._bufs.clear()


class FedAvg(Strategy):
    """Example-count weighted average (McMahan et al. 2016, eq. 1)."""

    name = "fedavg"

    def aggregate(self, own: NodeUpdate, peers: Sequence[NodeUpdate]) -> PyTree:
        spec = self._resolve_spec(own)
        return spec.unflatten(
            self._weighted_mean(spec, [own, *peers], out=self._out_buf(spec)))


class _FedOpt(Strategy):
    """Adaptive federated optimization base (Reddi et al. 2021).

    Maintains a client-local estimate x of the global model; each aggregation
    computes the pseudo-gradient Δ = x − avg(updates) and applies a server
    optimizer step to x. ``x``/``m``/``v`` are flat f32 tensors on the device,
    initialized from the first own update. On a CUDA stack (and whenever
    ``use_kernel``) the whole avg→Δ→moments→step chain is one ``fed_opt``
    call; on the CPU otherwise it runs as separate tensor ops, in place.
    """

    variant: str = "adam"

    def __init__(self, server_lr: float = 1.0, beta1: float = 0.9,
                 beta2: float = 0.99, tau: float = 1e-3, *, use_kernel: bool = False,
                 device: "str | torch.device" = "cuda"):
        super().__init__(use_kernel=use_kernel, device=device)
        self.server_lr = server_lr
        self.beta1 = beta1
        self.beta2 = beta2
        self.tau = tau
        self.x: torch.Tensor | None = None
        self.m: torch.Tensor | None = None
        self.v: torch.Tensor | None = None

    def reset(self) -> None:
        super().reset()
        self.x = self.m = self.v = None

    def state_dict(self) -> dict[str, torch.Tensor] | None:
        if self.x is None:
            return None
        return {"x": self.x, "m": self.m, "v": self.v}

    def load_state_dict(self, state: dict) -> None:
        vecs = self._flat_state(state, "x", "m", "v")
        if vecs is not None:
            self.x, self.m, self.v = vecs

    def _update_v(self, v: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def aggregate(self, own: NodeUpdate, peers: Sequence[NodeUpdate]) -> PyTree:
        spec = self._resolve_spec(own)
        if self.x is not None and self.x.numel() != spec.num_params:
            self.x = self.m = self.v = None  # structure changed → reinit
        updates = [own, *peers]
        stacked = self._stacked(spec, updates)
        coeffs = self._mean_coeffs(updates)
        if self.x is None:
            self.x = stacked[0].clone()  # own's flat, just written into the stack
            self.m = torch.zeros_like(self.x)
            self.v = torch.zeros_like(self.x)
        if self.use_kernel or stacked.is_cuda:
            with child_span("aggregate.combine"):
                self.x, self.m, self.v = fed_agg_ops.fed_opt_flat(
                    stacked, coeffs, self.x, self.m, self.v,
                    variant=self.variant, server_lr=self.server_lr,
                    beta1=self.beta1, beta2=self.beta2, tau=self.tau,
                )
            if stacked.is_cuda:
                self.launches["fed_opt"] += 1
            # fresh state that nothing aliases; next round replaces (never
            # mutates) it, so the returned views need no detach copy
            return spec.unflatten(self.x)
        avg = self._combine(stacked, coeffs, out=self._buffer("avg", spec))
        d = self.x - avg  # pseudo-gradient
        self.m *= self.beta1
        self.m += (1.0 - self.beta1) * d
        self.v = self._update_v(self.v, d * d)
        self.x -= self.server_lr * self.m / (torch.sqrt(self.v) + self.tau)
        return spec.unflatten(self._emit(spec, self.x))  # in-place state: detach


class FedAvgM(Strategy):
    """FedAvg with server momentum (Hsu et al. 2019)."""

    name = "fedavgm"

    def __init__(self, server_lr: float = 1.0, momentum: float = 0.9, *,
                 use_kernel: bool = False, device: "str | torch.device" = "cuda"):
        super().__init__(use_kernel=use_kernel, device=device)
        self.server_lr = server_lr
        self.momentum = momentum
        self.x: torch.Tensor | None = None
        self.buf: torch.Tensor | None = None

    def reset(self) -> None:
        super().reset()
        self.x = self.buf = None

    def state_dict(self) -> dict[str, torch.Tensor] | None:
        if self.x is None:
            return None
        return {"x": self.x, "buf": self.buf}

    def load_state_dict(self, state: dict) -> None:
        vecs = self._flat_state(state, "x", "buf")
        if vecs is not None:
            self.x, self.buf = vecs

    def aggregate(self, own: NodeUpdate, peers: Sequence[NodeUpdate]) -> PyTree:
        spec = self._resolve_spec(own)
        if self.x is not None and self.x.numel() != spec.num_params:
            self.x = self.buf = None
        updates = [own, *peers]
        stacked = self._stacked(spec, updates)
        avg = self._combine(stacked, self._mean_coeffs(updates),
                            out=self._buffer("avg", spec))
        if self.x is None:
            self.x = stacked[0].clone()
            self.buf = torch.zeros_like(self.x)
        # buf = momentum·buf + (x − avg);  x -= lr·buf   (all in place)
        self.buf *= self.momentum
        self.buf += self.x
        self.buf -= avg
        self.x -= self.server_lr * self.buf
        return spec.unflatten(self._emit(spec, self.x))


class FedAdam(_FedOpt):
    name = "fedadam"
    variant = "adam"

    def _update_v(self, v, d2):
        return self.beta2 * v + (1 - self.beta2) * d2


class FedYogi(_FedOpt):
    name = "fedyogi"
    variant = "yogi"

    def _update_v(self, v, d2):
        return v - (1 - self.beta2) * d2 * torch.sign(v - d2)


class FedAdagrad(_FedOpt):
    name = "fedadagrad"
    variant = "adagrad"

    def _update_v(self, v, d2):
        return v + d2


class FedAsync(Strategy):
    """Staleness-aware asynchronous mixing (Xie et al. 2019, FedAsync).

    new = (1 − α_k)·current + α_k·peer_k, applied per peer in arrival order,
    with α_k = alpha·s(staleness). The lerp chain factorizes into one linear
    combination — c_own = Π_j (1 − α_j), c_k = α_k·Π_{j>k} (1 − α_j) — so the
    chain is a single ``fed_agg`` launch. Peers whose ``lease_epoch`` is
    ahead of ours are damped by ``(1 + epoch_gap)^(-epoch_a)``.
    """

    name = "fedasync"

    def __init__(self, alpha: float = 0.6, staleness_fn: str = "poly",
                 a: float = 0.5, b: int = 4, *, epoch_a: float = 1.0,
                 use_kernel: bool = False, device: "str | torch.device" = "cuda"):
        super().__init__(use_kernel=use_kernel, device=device)
        self.alpha = alpha
        self.staleness_fn = staleness_fn
        self.a = a
        self.b = b
        self.epoch_a = epoch_a

    def _discount(self, staleness: float) -> float:
        s = max(0.0, staleness)
        if self.staleness_fn == "poly":
            return (1.0 + s) ** (-self.a)
        if self.staleness_fn == "hinge":
            return 1.0 if s <= self.b else 1.0 / (self.a * (s - self.b) + 1.0)
        if self.staleness_fn == "const":
            return 1.0
        raise ValueError(f"unknown staleness_fn {self.staleness_fn}")

    def aggregate(self, own: NodeUpdate, peers: Sequence[NodeUpdate]) -> PyTree:
        if not peers:
            return own.params
        spec = self._resolve_spec(own)
        own_epoch = int(getattr(own, "lease_epoch", 0))
        alphas = []
        for peer in peers:
            a_eff = self.alpha * self._discount(float(own.counter - peer.counter))
            gap = int(getattr(peer, "lease_epoch", 0)) - own_epoch
            if gap > 0 and self.epoch_a:
                a_eff *= (1.0 + gap) ** (-self.epoch_a)
            alphas.append(min(max(a_eff, 0.0), 1.0))
        coeffs = np.empty(len(peers) + 1, np.float32)
        suffix = 1.0  # Π_{j>k} (1 − α_j), built back to front
        for k in range(len(peers) - 1, -1, -1):
            coeffs[k + 1] = alphas[k] * suffix
            suffix *= 1.0 - alphas[k]
        coeffs[0] = suffix
        stacked = self._stacked(spec, [own, *peers])
        return spec.unflatten(self._combine(stacked, coeffs, out=self._out_buf(spec)))


class FedBuff(Strategy):
    """Buffered asynchronous aggregation (Nguyen et al. 2022): aggregates
    only once >= ``buffer_size`` distinct updates (own included) are
    buffered, else returns own params unchanged."""

    name = "fedbuff"

    def __init__(self, buffer_size: int = 3, *, use_kernel: bool = False,
                 device: "str | torch.device" = "cuda"):
        super().__init__(use_kernel=use_kernel, device=device)
        self.buffer_size = buffer_size
        self._pending: dict[str, NodeUpdate] = {}
        self._seen_counters: dict[str, int] = {}

    def reset(self) -> None:
        super().reset()
        self._pending.clear()
        self._seen_counters.clear()

    def aggregate(self, own: NodeUpdate, peers: Sequence[NodeUpdate]) -> PyTree:
        for peer in peers:
            if self._seen_counters.get(peer.node_id, -1) < peer.counter:
                self._pending[peer.node_id] = peer
                self._seen_counters[peer.node_id] = peer.counter
        self._pending[own.node_id] = own
        if len(self._pending) < self.buffer_size:
            return own.params
        updates = list(self._pending.values())
        self._pending.clear()
        spec = self._resolve_spec(own)
        return spec.unflatten(
            self._weighted_mean(spec, updates, out=self._out_buf(spec)))


class PartialFedAvg(Strategy):
    """Partial model personalization (Pillutla et al. 2022): only leaves whose
    path matches ``shared_pattern`` (or the named ``families=``, which
    overrides it) federate; everything else stays personal. The leaf filter
    compiles once per spec into a device bool mask over the flat index space;
    each aggregate is one ``fed_agg`` plus one ``torch.where``."""

    name = "partial_fedavg"

    def __init__(self, shared_pattern: str = ".*", *, families=None,
                 use_kernel: bool = False, reuse_output: bool = False,
                 device: "str | torch.device" = "cuda"):
        super().__init__(use_kernel=use_kernel, reuse_output=reuse_output, device=device)
        self.families = families
        self.pattern = re.compile(shared_pattern)
        self._mask: torch.Tensor | None = None
        self._leaf_mask: list[bool] | None = None
        self._mask_key: str | None = None

    def _mask_for(self, spec: LeafSpec) -> torch.Tensor:
        if self._mask_key != spec.key:
            if self.families is not None:
                view = spec.family_view(self.families)
                mask = view.mask
                leaf_mask = list(view.leaf_mask)
            else:
                mask = np.zeros(spec.num_params, bool)
                leaf_mask = []
                for path, off, n in zip(spec.paths, spec.offsets, spec.sizes):
                    shared = bool(self.pattern.search(path))
                    leaf_mask.append(shared)
                    if shared:
                        mask[off:off + n] = True
            self._mask = torch.from_numpy(mask).to(self.device)
            self._leaf_mask = leaf_mask
            self._mask_key = spec.key
        return self._mask

    def aggregate(self, own: NodeUpdate, peers: Sequence[NodeUpdate]) -> PyTree:
        spec = self._resolve_spec(own)
        updates = [own, *peers]
        stacked = self._stacked(spec, updates)
        avg = self._combine(stacked, self._mean_coeffs(updates),
                            out=self._buffer("avg", spec))
        # stacked[0] is own's flat (just written by the stack fill): the
        # personal entries come from it
        out = self._out_buf(spec)
        if out is None:
            out = torch.empty(spec.num_params, dtype=torch.float32, device=self.device)
        torch.where(self._mask_for(spec), avg, stacked[0], out=out)
        out_tree = spec.unflatten(out)
        if spec.f32_exact:
            return out_tree
        # Personal leaves of non-f32-embeddable models (int/f64) pass through
        # untouched — own's original leaves, never rounded through the flat.
        agg_leaves = tree_leaves(out_tree)
        own_leaves = tree_leaves(own.params)
        return tree_unflatten(spec.treedef, [
            a if shared else o
            for a, o, shared in zip(agg_leaves, own_leaves, self._leaf_mask)
        ])


STRATEGIES = {
    cls.name: cls
    for cls in [FedAvg, FedAvgM, FedAdam, FedYogi, FedAdagrad, FedAsync, FedBuff, PartialFedAvg]
}


def get_strategy(name: str, **kwargs) -> Strategy:
    if name not in STRATEGIES:
        raise KeyError(f"unknown strategy {name!r}; options: {sorted(STRATEGIES)}")
    return STRATEGIES[name](**kwargs)
