"""The public facade: ``connect(uri)`` opens a weight store behind any folder
URI the grammar accepts — the port of ``repro.api.connect``.

**Folder-URI stages**, outermost-first, ``+``-chained::

    [shard<G>[x<L>]+][retry+|cache+ ...]<base>

    ============  =====================================================
    stage         meaning
    ============  =====================================================
    shard<G>+     partition the fleet into G node-group folders with
                  ring gossip of group summaries (O(group) scans)
    shard<G>x<L>+ same, gossiping through an L-level summary tree
                  (must be the OUTERMOST stage)
    retry+        capped exponential-backoff retries on transient I/O
    cache+        read-through blob cache in front of the base folder
    <base>        ``memory://`` (anonymous, fresh per call) |
                  ``memory://<name>`` (process-global shared registry) |
                  ``s3://bucket/prefix`` (needs boto3) | a local path
    ============  =====================================================

``serve(store, arch)`` joins a store read-only as a serving node (the port of
``repro.api.serve``); ``mesh=`` places its weights on a ``DeviceMesh``.

**Transport pipeline specs** (``transport=``), a policy stage plus an
optional envelope, ``|``-chained: ``"delta(chain=4)|zstd"``,
``"topk(adaptive)"``, ``"family(adapters=delta)"``, ``"quantized|npz"``, or
a legacy name (``full | quantized | delta | delta_q | topk``).

``connect`` returns the right store kind for the URI: a
``ShardedWeightStore`` for ``shard...+`` URIs, else a ``WeightStore``.
"""
from __future__ import annotations

from typing import Any

from repro_torch.core.gossip import ShardedFolders, ShardedWeightStore
from repro_torch.core.store import WeightStore, make_folder
from repro_torch.core.telemetry import Telemetry
from repro_torch.core.transport import (
    family_transport_spec,
    normalize_transport,
    parse_folder_uri,
)

__all__ = ["connect", "serve"]


def connect(
    uri: str,
    *,
    transport: str | None = None,
    families: Any = None,
    prefetch: "bool | float | tuple[float, str] | None" = None,
    telemetry: "Telemetry | bool | None" = None,
    quantized: bool = False,
    keep_history: bool = False,
    compress: str = "none",
    **store_kwargs: Any,
) -> "WeightStore | ShardedWeightStore":
    """Open a weight store behind ``uri`` (see the stage table above).

    ``transport`` is a pipeline spec or legacy name, normalized here so a bad
    spec fails before any folder is created; ``families`` is sugar for
    ``transport="family(...)"``. ``prefetch`` starts background cache warming
    (``True``, an interval in seconds, or ``(interval, node_id)``: the tuple
    form is required for sharded stores, whose prefetch is scoped to one
    node's home group); ``telemetry`` attaches a ``Telemetry`` (``True``
    creates one, reachable as ``store.telemetry``). The rest is forwarded to
    the store (``rebase_every``, ``topk_fraction``, ...).
    """
    parse_folder_uri(uri)  # validate the whole URI up front (clear errors)
    if families is not None:
        if transport is not None:
            raise ValueError("pass either transport= or families=, not both")
        transport = family_transport_spec(families)
    elif transport is not None:
        transport = normalize_transport(transport)
    elif quantized:
        transport = normalize_transport(None, quantized=True)

    folder = make_folder(uri)
    kind = ShardedWeightStore if isinstance(folder, ShardedFolders) else WeightStore
    store = kind(folder, transport=transport, keep_history=keep_history, compress=compress,
                 **store_kwargs)
    if telemetry:
        tel = telemetry if isinstance(telemetry, Telemetry) else Telemetry(enabled=True)
        store.attach_telemetry(tel)
        store.telemetry = tel
    if prefetch:
        if isinstance(prefetch, tuple):
            interval, node_id = prefetch
            store.start_prefetch(float(interval), exclude=node_id)
        elif isinstance(folder, ShardedFolders):
            raise ValueError(
                "sharded stores scope prefetch to one node's home group: "
                "pass prefetch=(interval, node_id)")
        else:
            store.start_prefetch(0.1 if prefetch is True else float(prefetch))
    return store


def serve(
    store,
    arch,
    *,
    node_id: str | None = None,
    reduced: bool = False,
    poll_interval: float = 0.25,
    telemetry: "Telemetry | bool | None" = None,
    mesh=None,
    start: bool = True,
    wait: float | None = None,
    device: Any = "cuda",
    **node_kwargs: Any,
):
    """Join a store read-only as a serving node.

    ``store`` is a store instance or a ``connect()``-able URI; ``arch`` an
    arch name from ``repro_torch.configs`` or a full ``ModelConfig``;
    ``mesh`` an optional ``torch.distributed`` ``DeviceMesh`` (one node per
    rank; see ``ServingNode``). With
    ``start=True`` (default) the watcher thread is already running on
    return; ``wait`` additionally blocks up to that many seconds for the
    first weight set to go live. Returns the :class:`ServingNode`.
    """
    from repro_torch.serving import ServingNode

    if isinstance(store, str):
        store = connect(store)
    node = ServingNode(store, arch, node_id=node_id, reduced=reduced,
                       poll_interval=poll_interval, telemetry=telemetry, mesh=mesh,
                       device=device,
                       **node_kwargs)
    if start:
        node.start()
        if wait is not None:
            node.wait_until_deployed(wait)
    return node
