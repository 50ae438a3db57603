"""StoreWatcher: turn a weight store into a deployment feed — a close copy of
``repro.serving.watcher``.

The serverless design has no publish step — every node's ``latest/<node>``
blob already IS an aggregated model (clients aggregate locally before
training on). A serving node therefore watches the store read-only and
deploys the *freshest* update visible: highest ``(counter, timestamp)``
across ``pull()``, which on sharded/hierarchical stores folds in cross-group
summaries (group summaries are spec-compatible weighted means, so they are
deployable too). Freshness polling rides the same decoded-update cache the
``Prefetcher`` warms — an unchanged store costs a ``version()`` listing
sweep, not a decode.

Updates whose layout does not match the serving model's :class:`LeafSpec`
(a different arch sharing the store, or a family-subset federation that
never ships full weights) are skipped and counted, never deployed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

from repro_torch.core.tree import LeafSpec


@dataclass
class Deployment:
    """One deployable weight set pulled from the store.

    Exactly one of ``flat`` / ``params`` is set: flat-path updates share the
    store's cached f32 vector (READ-ONLY — copy before mutating), tree-path
    updates carry the decoded pytree.
    """

    source: str                 # node id the weights came from
    counter: int                # source's client-local round counter
    timestamp: float
    max_counter: int            # freshest counter seen anywhere in the store
    flat: np.ndarray | None = None
    params: Any = None


class StoreWatcher:
    """Synchronous freshest-update poller over any weight store.

    ``poll()`` returns a new :class:`Deployment` when the freshest
    spec-compatible update changed since the last call, else ``None``.
    ``last_max_counter`` always tracks the freshest counter seen (including
    updates that were not deployable), which is what rounds-behind-store
    staleness is measured against.
    """

    def __init__(self, store, *, spec: LeafSpec | None = None):
        self.store = store
        self.spec = spec
        self.last_max_counter: int | None = None
        self.skipped_incompatible = 0
        self._deployed_key: tuple | None = None

    def _extract(self, update) -> tuple[np.ndarray | None, Any] | None:
        """(flat, params) for a spec-compatible update, else None."""
        flat = getattr(update, "flat", None)
        spec = getattr(update, "spec", None)
        if self.spec is None:
            if flat is not None:
                return flat, None
            return None, update.params
        if flat is not None and self.spec.compatible(spec):
            return flat, None
        # tree-path fallback: deployable iff the tree has our exact layout
        try:
            params = update.params
            if self.spec.describes(params):
                return None, params
        except Exception:
            pass
        return None

    def poll(self) -> Deployment | None:
        updates = self.store.pull()
        best = None
        best_payload = None
        max_counter = None
        for u in updates:
            if u is None:
                continue
            counter = int(getattr(u, "counter", 0))
            if max_counter is None or counter > max_counter:
                max_counter = counter
            if best is not None and (counter, u.timestamp) <= (best.counter, best.timestamp):
                continue
            payload = self._extract(u)
            if payload is None:
                self.skipped_incompatible += 1
                continue
            best, best_payload = u, payload
        self.last_max_counter = max_counter
        if best is None:
            return None
        key = (best.node_id, best.counter, best.timestamp)
        if key == self._deployed_key:
            return None
        self._deployed_key = key
        flat, params = best_payload
        return Deployment(
            source=best.node_id,
            counter=int(best.counter),
            timestamp=float(best.timestamp),
            max_counter=int(max_counter if max_counter is not None else best.counter),
            flat=flat,
            params=params,
        )
