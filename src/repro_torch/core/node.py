"""Federated nodes: the paper's client-side federation objects (the port of
``repro.core.node``).

``AsyncFederatedNode`` implements Algorithm 1 (FedAvgAsync) generalized over
strategies: push own weights → state-hash check → pull peers' latest →
client-side aggregate → continue training. If the store is unchanged or empty
(no peers yet), the client keeps its own weights — no waiting, ever.

``SyncFederatedNode`` implements the paper's synchronous *serverless* mode:
after pushing round-t weights the client blocks until all K participants have
deposited round-t weights, then everybody aggregates the identical set
locally. A ``timeout`` makes single-node failure observable instead of a
deadlock (the paper's operational criticism of synchronous FL).

Nodes are transparent to the flat-vector hot path: the store pulls
``FlatUpdate``s (contiguous host f32 vectors sharing an interned
``LeafSpec``), the strategy stacks and aggregates them on its device, and the
tree the trainer receives back views the strategy's device buffer.
"""
from __future__ import annotations

import time
import uuid
import warnings
from typing import Callable

import torch

from repro_torch.logs import get_logger

from .gossip import ShardedFolders, ShardedWeightStore
from .serialize import NodeUpdate
from .store import SharedFolder, WeightStore
from .strategies import FedAvg, PartialFedAvg, Strategy
from .telemetry import Telemetry
from .transport import family_transport_spec, normalize_transport
from .tree import PyTree, tree_to_numpy

_log = get_logger("node")


class FederationTimeout(RuntimeError):
    """Raised by SyncFederatedNode when peers never arrive (straggler/crash)."""


class _BaseNode:
    def __init__(
        self,
        *,
        strategy: Strategy | None = None,
        shared_folder: SharedFolder | ShardedFolders | None = None,
        store: WeightStore | ShardedWeightStore | None = None,
        node_id: str | None = None,
        transport: str | None = None,
        families=None,
        resume: bool = True,
        persist_strategy_state: bool = False,
        prefetch_interval: float | None = None,
        clock: Callable[[], float] = time.monotonic,
        on_step: "Callable[[_BaseNode, PyTree | None], None] | None" = None,
        telemetry: "Telemetry | bool | None" = None,
        lease_epoch: int = 0,
        device: "str | torch.device" = "cuda",
    ):
        # ``device`` is where the default strategy (FedAvg, or PartialFedAvg
        # under ``families=``) keeps its stack; a passed strategy keeps its own.
        # Elastic-fleet provenance: 0 for a node on its original slot claim,
        # >0 when a surviving worker adopted this slot at that lease epoch.
        # Rides every pushed update's wire meta so staleness-aware strategies
        # (FedAsync's epoch-gap discount) can damp resurrected stragglers.
        self.lease_epoch = int(lease_epoch)
        # Leaf-family selector (LoRA-style adapter federation): one kwarg
        # configures both halves of subset federation. When the node builds
        # its own store it ships only the selected families (``family(...)``
        # transport); and unless the caller passed an explicit strategy, it
        # aggregates only those families too (non-federated leaves stay
        # personal, bit-exact). A name, a sequence of names, or a mapping
        # name → sub-policy (full | quantized | delta) — see
        # ``tree.FAMILY_PATTERNS`` / ``register_family``.
        self.families = families
        if families is not None:
            if transport is None and store is None:
                transport = family_transport_spec(families)
            if strategy is None:
                # a mapping selector maps name → *sub-policy* (a transport
                # concern); the aggregation mask only needs the names
                names = tuple(families) if not isinstance(families, str) else families
                strategy = PartialFedAvg(families=names, device=device)
        self._owns_store = store is None
        if store is None:
            if shared_folder is None:
                raise ValueError("need shared_folder or store")
            if isinstance(shared_folder, ShardedFolders):
                store = ShardedWeightStore(shared_folder, transport=transport)
            else:
                store = WeightStore(shared_folder, transport=transport)
        elif transport is not None:
            # store.transport is the canonical pipeline spec; compare specs,
            # not raw strings, so "delta_q" matches a "delta(q)" store. A
            # node spec with no envelope also matches a store that added one
            # via compress= — the node is asserting the wire policy, and the
            # envelope is a store-construction detail.
            want = normalize_transport(transport)
            have = store.transport
            if want not in (have, have.rpartition("|")[0] or have):
                raise ValueError(
                    f"store already configured with transport {have!r}; "
                    "pass transport= only together with shared_folder"
                )
        self.store = store
        self.strategy = strategy or FedAvg(device=device)
        self.node_id = node_id or uuid.uuid4().hex[:8]
        self.clock = clock
        # Soak/observability hook: called once per federation step (after the
        # push and any aggregation) with (node, aggregated-or-None). The fleet
        # harness hangs heartbeat deposits on it; exceptions propagate — a
        # broken hook is a caller bug, not something to swallow mid-soak.
        self.on_step = on_step
        self.persist_strategy_state = persist_strategy_state
        # Telemetry: an instance wires in as-is; True/False forces on/off;
        # None defers to the REPRO_OBS env var (default off — span() then
        # returns a shared no-op and every hook is one attribute check).
        if isinstance(telemetry, Telemetry):
            self.telemetry = telemetry
        else:
            self.telemetry = Telemetry(enabled=telemetry)
        if not self.telemetry.node_id:
            self.telemetry.node_id = self.node_id
        if self.telemetry.enabled and self._owns_store:
            # Only a store this node built is exclusively its own traffic; a
            # caller-provided store may be shared, and its spans would
            # conflate nodes.
            store.attach_telemetry(self.telemetry)
        self.counter = 0  # local epoch counter; there is no global round
        self._last_state_hash: str | None = None
        # Restart/recovery (read-your-own-writes bootstrap): a node that comes
        # back under an id it deposited under before — a SIGKILL'd client
        # restarting — resumes its counter after its own ``latest/`` blob, and
        # exposes that blob so the caller can restore params instead of
        # restarting training from scratch. A fresh (generated) id has nothing
        # to recover, so only explicit ids pay the one lookup.
        self.resumed: NodeUpdate | None = None
        if resume and node_id is not None:
            previous = store.pull_node(node_id)
            if previous is not None:
                self.counter = previous.counter + 1
                self.resumed = previous
            # Strategy-state recovery: a resumed FedAvgM/FedAdam node
            # restores its momentum/moment vectors from the state/ blob it
            # (or its previous incarnation) deposited, so the server-
            # optimizer trajectory survives a crash — not just the params.
            if persist_strategy_state and previous is not None:
                recovered = store.pull_strategy_state(node_id)
                if (recovered is not None
                        and recovered[1].get("strategy") == self.strategy.name):
                    self.strategy.load_state_dict(recovered[0])
            if previous is not None and self.telemetry.enabled:
                snapshots = store.pull_obs(node_id)
                self.telemetry.resume(
                    self.counter, snapshots[-1][2].get("counters") if snapshots else None)
        # Background prefetch: warm the decoded-update cache between
        # federation steps so the step's pull is all cache hits.
        if prefetch_interval is not None:
            store.start_prefetch(prefetch_interval, exclude=self.node_id)
        # instrumentation
        self.num_pushes = 0
        self.num_pulls = 0
        self.num_skipped_pulls = 0
        self.num_aggregations = 0

    def transport_stats(self) -> dict[str, int]:
        """Wire-level counters from the underlying store — the pipeline's
        full stats dict (bytes written/read, decode-cache hits/misses, chain
        depths, residual norms, prefetch activity) — in one shape regardless
        of store kind, so transport experiments read a single dict per
        node."""
        store = self.store
        if hasattr(store, "cache_stats"):  # ShardedWeightStore aggregates
            return store.cache_stats()
        return store.transport_stats()

    def _finish_step(self, aggregated: PyTree | None) -> PyTree | None:
        """Every return path of update_parameters funnels through here so the
        ``on_step`` hook fires exactly once per federation step — including
        skipped-pull and no-peers steps, which a heartbeat must still count.
        Telemetry rounds tick here too, and every ``flush_every`` rounds the
        aggregator snapshots into an ``obs/<node>/<seq>`` blob."""
        tel = self.telemetry
        if tel.enabled:
            tel.end_round(aggregated=aggregated is not None)
            if tel.should_flush():
                try:
                    payload = tel.snapshot(self.transport_stats())
                    self.store.push_obs(self.node_id, payload["seq"], payload,
                                        keep=tel.obs_keep)
                except Exception:
                    # observability must never take down federation
                    _log.debug("node %s: obs flush failed", self.node_id,
                               exc_info=True)
        if self.on_step is not None:
            self.on_step(self, aggregated)
        return aggregated

    def _aggregate(self, own: NodeUpdate, peers: list, round_id: int) -> PyTree:
        """The strategy's aggregate, in the ``aggregate`` span of round
        ``round_id``. With telemetry on, the kernel launches the strategy
        reports for it count as ``kernel.<name>`` before the round's obs
        flush (a node in a child process reports them there: the parent's
        counters never see a child's)."""
        tel = self.telemetry
        if not tel.enabled:
            return self.strategy.aggregate(own, peers)
        launches = getattr(self.strategy, "launches", {})
        before = dict(launches)
        with tel.span("aggregate", trace=round_id):
            aggregated = self.strategy.aggregate(own, peers)
        for name, n in launches.items():
            if n > before.get(name, 0):
                tel.count(f"kernel.{name}", n - before[name])
        return aggregated

    def _persist_strategy_state(self) -> None:
        state = self.strategy.state_dict()
        if state:
            self.store.push_strategy_state(
                self.node_id, self.strategy.name, self.counter, state)

    def _push(self, params: PyTree, num_examples: int, metrics: dict | None = None) -> NodeUpdate:
        update = NodeUpdate(
            params=tree_to_numpy(params),
            num_examples=num_examples,
            node_id=self.node_id,
            counter=self.counter,
            timestamp=self.clock(),
            metrics=metrics or {},
            lease_epoch=self.lease_epoch,
        )
        self.store.push(update)
        self.num_pushes += 1
        return update


class AsyncFederatedNode(_BaseNode):
    """Asynchronous serverless federation (paper Figure 2 / Algorithm 1)."""

    def update_parameters(
        self, params: PyTree, num_examples: int, metrics: dict | None = None
    ) -> PyTree | None:
        """Push-then-pull federation step; returns aggregated params, or
        ``None`` when no peer weights are available / store unchanged (the
        caller keeps training on its current weights — Algorithm 1's 'resume
        training' branch)."""
        # the round's spans (and the store spans under them) share its counter
        # as their trace id
        tel = self.telemetry
        round_id = self.counter
        with tel.span("push", trace=round_id):
            own = self._push(params, num_examples, metrics)
        self.counter += 1

        with tel.span("pull", trace=round_id):
            state = self.store.state_hash(exclude_node=self.node_id)
            if state == self._last_state_hash:
                # Only our own deposit changed nothing relative to what we
                # already aggregated → skip the download entirely (paper's
                # hash check).
                peers = None
            else:
                peers = self.store.pull(exclude=self.node_id)
        if peers is None:
            self.num_skipped_pulls += 1
            return self._finish_step(None)
        self.num_pulls += 1
        # Record the PRE-pull hash: a peer depositing while we were pulling
        # must show up as a change next round. Re-hashing here would mark that
        # unseen blob as already-aggregated and drop it permanently; the
        # pre-pull hash only risks one redundant re-pull.
        self._last_state_hash = state
        if not peers:
            return self._finish_step(None)
        if tel.enabled:
            # Update staleness in local-epoch units (the FedAsync signal): how
            # far behind our own counter each pulled peer update is.
            for u in peers:
                tel.observe_staleness(own.counter - u.counter)
        aggregated = self._aggregate(own, peers, round_id)
        self.num_aggregations += 1
        if self.persist_strategy_state:
            self._persist_strategy_state()
        return self._finish_step(aggregated)


class SyncFederatedNode(_BaseNode):
    """Synchronous serverless federation: barrier on the weight store."""

    def __init__(self, *, num_nodes: int, timeout: float = 60.0, poll_interval: float = 0.02,
                 resume: bool = False, **kwargs):
        # resume defaults OFF here (unlike async): a node that bootstraps its
        # counter past its peers would wait on a round they will never reach,
        # while the peers aggregate their stale history blobs. Sync recovery
        # needs all participants restarted together — opt in explicitly.
        super().__init__(resume=resume, **kwargs)
        # Round-exact blobs are required so every client aggregates the same
        # set even when a fast peer has already deposited round t+1. Flipping
        # keep_history on a store the CALLER constructed (and may share with
        # async nodes) is a side effect they must hear about: every node using
        # that store starts writing per-round history blobs.
        if not self.store.keep_history:
            if not self._owns_store:
                warnings.warn(
                    "SyncFederatedNode is enabling keep_history on a caller-"
                    "provided store; all nodes sharing it will now write "
                    "history/ blobs. Construct the store with "
                    "keep_history=True (or give sync nodes their own store) "
                    "to make this explicit.",
                    stacklevel=2,
                )
            self.store.keep_history = True
        self.num_nodes = num_nodes
        self.timeout = timeout
        self.poll_interval = poll_interval

    def update_parameters(
        self, params: PyTree, num_examples: int, metrics: dict | None = None
    ) -> PyTree:
        tel = self.telemetry
        round_id = self.counter
        with tel.span("push", trace=round_id):
            own = self._push(params, num_examples, metrics)
        self.counter += 1

        # The injected clock drives the deadline, not time.monotonic():
        # simulated-clock tests of timeout behavior (and virtual-time
        # harnesses) must be able to age the barrier without real sleeping.
        deadline = self.clock() + self.timeout
        with tel.span("pull", trace=round_id):
            while True:
                peers = self.store.pull_round(round_id, exclude=self.node_id)
                self.num_pulls += 1
                if len(peers) >= self.num_nodes - 1:
                    break
                if self.clock() > deadline:
                    raise FederationTimeout(
                        f"node {self.node_id}: only {len(peers) + 1}/{self.num_nodes} "
                        f"nodes reached round {round_id} within {self.timeout}s"
                    )
                time.sleep(self.poll_interval)
        if tel.enabled:
            for u in peers:
                tel.observe_staleness(own.counter - u.counter)
        # Deterministic aggregation order across clients → identical results.
        peers.sort(key=lambda u: u.node_id)
        aggregated = self._aggregate(own, peers, round_id)
        self.num_aggregations += 1
        if self.persist_strategy_state:
            self._persist_strategy_state()
        self._finish_step(aggregated)
        return aggregated
