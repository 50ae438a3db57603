"""Serving tier: continuous deployment from the federation store to live
batched inference on the card — the port of ``repro.serving``.

A :class:`StoreWatcher` polls the store's ``latest/`` listings read-only and
picks the freshest aggregated weights it can see; a :class:`ServingNode`
decodes them into a preallocated pinned host f32 buffer, hot-swaps them onto
the card with double buffering, and serves batched greedy decode through the
same ``serve_step`` the launch layer uses (flash prefill, decode kernel).

Public entry point: ``repro_torch.api.serve``.
"""
from .node import ServingNode
from .watcher import Deployment, StoreWatcher

__all__ = ["Deployment", "ServingNode", "StoreWatcher"]
