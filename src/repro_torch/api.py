"""The public facade: ``connect(uri)`` opens a weight store behind any folder
URI the grammar accepts — the port of ``repro.api.connect``.

**Folder-URI stages**, outermost-first, ``+``-chained::

    [retry+|cache+ ...]<base>

    ============  =====================================================
    stage         meaning
    ============  =====================================================
    retry+        capped exponential-backoff retries on transient I/O
    cache+        read-through blob cache in front of the base folder
    <base>        ``memory://`` (anonymous, fresh per call) |
                  ``memory://<name>`` (process-global shared registry) |
                  a local path
    ============  =====================================================

``shard<G>[x<L>]+`` (gossip-sharded stores) and ``s3://`` parse, but raise
``NotImplementedError`` until the federation plane is ported (slice 3).

``serve(store, arch)`` joins a store read-only as a serving node (the port of
``repro.api.serve``, without ``mesh=``).

**Transport pipeline specs** (``transport=``): ``full``, ``quantized``,
either with an ``npz`` or ``zstd`` envelope (``"quantized|zstd"``). Every
spec of the reference's grammar validates; the delta, topk and family
policies raise ``NotImplementedError`` when the store is built (slice 3).
"""
from __future__ import annotations

from typing import Any

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
) -> WeightStore:
    """Open a weight store behind ``uri`` (see the stage table above).

    ``transport`` is a pipeline spec or legacy name, normalized here so a bad
    spec fails before any folder is created; ``families`` is sugar for
    ``transport="family(...)"``. ``prefetch`` starts background cache warming
    (``True``, an interval in seconds, or ``(interval, node_id)``);
    ``telemetry`` attaches a ``Telemetry`` (``True`` creates one, reachable as
    ``store.telemetry``). The rest is forwarded to ``WeightStore``.
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

    store = WeightStore(make_folder(uri), transport=transport, keep_history=keep_history,
                        compress=compress, **store_kwargs)
    if telemetry:
        tel = telemetry if isinstance(telemetry, Telemetry) else Telemetry(enabled=True)
        store.attach_telemetry(tel)
        store.telemetry = tel
    if prefetch:
        if isinstance(prefetch, tuple):
            interval, node_id = prefetch
            store.start_prefetch(float(interval), exclude=node_id)
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
    start: bool = True,
    wait: float | None = None,
    device: Any = "cuda",
    **node_kwargs: Any,
):
    """Join a store read-only as a serving node.

    ``store`` is a store instance or a ``connect()``-able URI; ``arch`` an
    arch name from ``repro_torch.configs`` or a full ``ModelConfig``. With
    ``start=True`` (default) the watcher thread is already running on
    return; ``wait`` additionally blocks up to that many seconds for the
    first weight set to go live. Returns the :class:`ServingNode`.
    """
    from repro_torch.serving import ServingNode

    if isinstance(store, str):
        store = connect(store)
    node = ServingNode(store, arch, node_id=node_id, reduced=reduced,
                       poll_interval=poll_interval, telemetry=telemetry, device=device,
                       **node_kwargs)
    if start:
        node.start()
        if wait is not None:
            node.wait_until_deployed(wait)
    return node
