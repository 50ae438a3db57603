"""ServingNode: hot-swapping batched decode over a federation store — the
port of ``repro.serving.node``.

Double buffering, on both sides of the host/device boundary, with the
reference's semantics. The watcher thread decodes a fresh deployment into the
*standby* host f32 buffer (``np.copyto`` for flat-path updates,
``LeafSpec.flatten_into`` for tree-path ones), writes it into the standby
*device* leaf set, and publishes that with one reference flip. A decode batch
snapshots the active weights once at batch start, so:

  * a swap landing mid-batch never changes the weights a batch started with
    (no torn read — per-buffer in-flight counts keep a buffer's device leaves
    untouched until the last batch referencing them completes);
  * requests never wait on a swap (zero downtime — the flip is a reference
    assignment, all decode/copy work happens off the request path).

The device write is *chunk-throttled*, as the reference's donated
``dynamic_update_slice`` chunks are: ``_SWAP_CHUNK`` f32 elements (~2 MB) at a
time go from the host buffer into one of two small pinned staging buffers,
then, on a side CUDA stream, to the card and into their leaf (cast to the
leaf's dtype), with a ``_SWAP_PAUSE_S`` yield between chunks. A CUDA event
per staging buffer orders its reuse after its copy. One leaf-sized copy would
queue ahead of the decode steps and stall in-flight requests; small copies on
a side stream interleave with them.

On the card, off a mesh, a model whose blocks are all ``ssm`` decodes from
a CUDA graph (``launch.steps.DecodeGraph``): its step carries a cache of
fixed shape and reads no host position, so one capture for each (device
buffer, leaf-set generation, batch size) stays valid across the in-place
swaps into that buffer, and a step costs one launch where eager dispatch
issues ~35 aten calls a layer. The prefill runs as before into the batch's
own cache; after the first token one device copy moves that cache and the
token into the graph's static buffers, and each later token is one replay.
A graph serves one batch at a time: a batch that finds it busy decodes
eagerly. The generation counts fresh allocations of a buffer's leaves (its
first deploy, or a drain timeout), and a graph of an older one is never
replayed. Every other model, the CPU and a mesh decode eagerly.

With a ``mesh`` (a ``torch.distributed`` ``DeviceMesh``; one ``ServingNode``
per rank, each fed the same prompts and deploying the same weights), a deploy
unflattens the standby host buffer and places each leaf with
``launch.sharding.param_shardings`` instead, as the reference does: the
chunked path and the device double buffer are skipped (``buf=None``). The
cache is placed with ``serve_cache_shardings`` (batch on the data axes, heads
on "model"), prompts with ``shard_batch``, and the greedy tokens come back
whole on every rank.

Telemetry spans ride ``obs/`` blobs like every trainer's metrics do, beside a
``serve`` SLO dict (swap-latency percentiles, staleness-in-rounds, token
throughput). On the request thread, one trace a batch (its number):
``serve.cache.init`` (the batch's fresh decode cache; counters
``serve.cache.kv_bytes``, its attention rings, and
``serve.cache.state_bytes``, its conv windows and recurrent states), then
``serve.prefill`` and ``serve.decode`` (one a token), each ended by a host
sync, with a child ``serve.prefill.issue`` / ``serve.decode.issue`` from its
start to that sync, which is how long the host takes to issue the step's work;
inside ``serve.decode.issue`` a ``serve.decode.replay`` where the step is a
graph's replay, and before a batch's first decode a ``serve.decode.capture``
where its graph is captured then (counters ``serve.decode.graph``,
``serve.decode.eager``, ``serve.decode.capture``). On the watcher thread:
``serve.poll`` (the store's ``get``/``decode`` below it) and ``serve.swap``
(trace: the deployment's counter) with children ``serve.swap.stage`` (the host
buffer), ``serve.swap.wait`` (a batch still on the standby leaves) and
``serve.swap.write`` (the chunked device writes and their pauses). The node
never attaches its Telemetry to the store: the store's spans are children of
the node's open span on the calling thread.
"""
from __future__ import annotations

import logging
import threading
import time
import uuid
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.telemetry import Telemetry
from repro_torch.core.tree import (LeafSpec, path_str, torch_dtype, tree_flatten_with_path,
                                   tree_unflatten)
from repro_torch.data.pipeline import shard_batch
from repro_torch.kernels import resolve_device
from repro_torch.launch.mesh import data_axes
from repro_torch.launch.sharding import distribute, param_shardings, serve_cache_shardings
from repro_torch.launch.steps import (
    DecodeGraph,
    decode_graphable,
    make_bulk_prefill_step,
    make_serve_step,
)
from repro_torch.models import ModelConfig, build_model
from repro_torch.models.sharded import is_dtensor

from .watcher import Deployment, StoreWatcher

_log = logging.getLogger("repro_torch.serving")

_SLO_WINDOW = 512  # swap/staleness samples kept for percentile SLOs

_SWAP_CHUNK = 512 * 1024  # f32 elements per device write (~2 MB)
_SWAP_PAUSE_S = 0.001     # yield between chunks so queued decodes interleave
_SWAP_DRAIN_TIMEOUT_S = 30.0  # max wait for a batch still on the standby leaves
_DECODE_GRAPHS = 4  # captured decode steps kept; the oldest idle one goes first


def _percentile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


# decode-cache leaves by kind: attention rings (GQA k/v, MLA latents, the
# ring's positions) and recurrent state (conv windows, SSM and RG-LRU states)
_RING_LEAVES = frozenset({"k", "v", "c_kv", "k_rope", "slot_pos"})


def _cache_bytes(cache) -> tuple[int, int]:
    """(attention-ring bytes, recurrent-state bytes) of a decode cache."""
    ring = state = 0
    for path, leaf in tree_flatten_with_path(cache)[0]:
        n = leaf.numel() * leaf.element_size()
        if path_str(path).rsplit("/", 1)[-1] in _RING_LEAVES:
            ring += n
        else:
            state += n
    return ring, state


def _sync(t: torch.Tensor) -> None:
    """Wait until the work that produces ``t`` is done (host clock spans)."""
    if is_dtensor(t):
        t = t.to_local()
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()


@dataclass
class _Deployed:
    """One published weight set; immutable once assigned to ``_deployed``."""

    params: Any        # device param tree (leaves of one device buffer)
    source: str
    counter: int
    deployed_at: float
    buf: int | None    # device-buffer index (None: a mesh tree)
    gen: int = 0       # generation of that buffer's leaf set


class _ChunkCopier:
    """Host f32 chunks → device leaves through two pinned staging buffers on a
    side stream (the card), or plain copies (the CPU)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.stream = torch.cuda.Stream(device)
            self.pinned = [torch.empty(_SWAP_CHUNK, dtype=torch.float32, pin_memory=True)
                           for _ in range(2)]
            self.events = [torch.cuda.Event() for _ in range(2)]
            with torch.cuda.stream(self.stream):
                self.staging = torch.empty(_SWAP_CHUNK, dtype=torch.float32, device=device)
        self.n = 0

    def begin(self) -> None:
        if self.cuda:  # start after the work already queued on the request stream
            self.stream.wait_stream(torch.cuda.current_stream(self.device))

    def copy(self, dst: torch.Tensor, src: np.ndarray) -> None:
        """dst (a flat slice of a device leaf) ← src (host f32)."""
        host = torch.from_numpy(src)
        if not self.cuda:
            dst.copy_(host)
            return
        i = self.n % 2
        self.n += 1
        self.events[i].synchronize()  # the previous copy out of this staging buffer is done
        m = host.numel()
        self.pinned[i][:m].copy_(host)
        with torch.cuda.stream(self.stream):
            self.staging[:m].copy_(self.pinned[i][:m], non_blocking=True)
            dst.copy_(self.staging[:m])
            self.events[i].record(self.stream)

    def finish(self) -> None:
        if self.cuda:
            self.stream.synchronize()


class ServingNode:
    """Read-only federation member that serves the freshest store weights.

    Parameters
    ----------
    store:
        Any weight store. The node only reads weights; its sole writes are
        its own ``obs/`` telemetry blobs.
    arch:
        Arch name from ``repro_torch.configs`` or a full :class:`ModelConfig`.
    reduced:
        Shrink the config (``ModelConfig.reduced()``) — CI/smoke scale.
    poll_interval:
        Seconds between store freshness sweeps on the watcher thread.
    telemetry:
        ``Telemetry`` instance, bool, or None (``REPRO_OBS`` env default).
    mesh:
        Optional ``DeviceMesh`` ("data", "model"): deployments are placed
        with ``launch.sharding.param_shardings`` instead of on one device.
    window_override:
        Optional sliding-window override threaded to prefill/decode.
    device:
        Where the weights live and decode runs: the card unless the caller
        asks for the CPU.
    """

    def __init__(
        self,
        store,
        arch: str | ModelConfig,
        *,
        node_id: str | None = None,
        reduced: bool = False,
        poll_interval: float = 0.25,
        telemetry: "Telemetry | bool | None" = None,
        mesh=None,
        window_override: int | None = None,
        clock: Callable[[], float] = time.perf_counter,
        device: "str | torch.device" = "cuda",
    ):
        cfg = arch if isinstance(arch, ModelConfig) else get_config(arch)
        if reduced:
            cfg = cfg.reduced()
        if cfg.is_encdec:
            raise ValueError(
                "ServingNode covers decoder-only archs (the federated zoo), by the "
                "reference's design; use repro_torch.launch.serve.serve_batch for enc-dec "
                "one-shots")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = build_model(cfg)
        self.store = store
        self.node_id = node_id or f"serve-{uuid.uuid4().hex[:8]}"
        self.poll_interval = float(poll_interval)
        self._clock = clock
        if isinstance(telemetry, Telemetry):
            self.telemetry = telemetry
        else:
            self.telemetry = Telemetry(self.node_id, enabled=telemetry)

        shapes = self.model.abstract()
        self.spec = LeafSpec.of(shapes)
        self.watcher = StoreWatcher(store, spec=self.spec)
        self.mesh = mesh
        self._shardings = None
        if mesh is not None:
            if mesh.device_type != self.device.type:
                raise ValueError(f"mesh on {mesh.device_type!r} but device={str(self.device)!r}")
            self._shardings = param_shardings(shapes, mesh)
        self._prefill = make_bulk_prefill_step(cfg, window_override=window_override)
        self._serve_step = make_serve_step(cfg, window_override=window_override)
        self._window_override = window_override

        # double buffer: standby is written + copied to the card off the
        # request path, then published by flipping one reference
        self._buffers = [self.spec.empty_flat(), self.spec.empty_flat()]
        self._standby = 0
        self._deployed: _Deployed | None = None
        self._deployed_event = threading.Event()
        # device-side double buffer: two leaf sets written in place. In-place
        # writes would tear a batch still decoding on the standby leaves (two
        # swaps back), so a per-buffer in-flight count gates the overwrite.
        self._dev_leaves: list[list | None] = [None, None]
        self._buf_refs = [0, 0]
        self._buf_cv = threading.Condition()
        self._copier: _ChunkCopier | None = None
        # leaf-set generation of each device buffer: bumped whenever its
        # leaves are freshly allocated, which invalidates its decode graphs
        self._leaf_gen = [0, 0]
        self._graphable = decode_graphable(self.model, self.device, mesh)
        self._graphs: dict[tuple, DecodeGraph] = {}  # (buf, gen, B), oldest first
        self._graphs_busy: set[tuple] = set()
        self._graph_lock = threading.Lock()

        self._lock = threading.Lock()
        self._swaps = 0
        self._requests = 0
        self._batches = 0  # batches begun: each batch's trace id
        self._tokens = 0
        self._serve_seconds = 0.0
        self._swap_ms: list[float] = []
        self._stale_recent: list[float] = []

        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "ServingNode":
        """Start the watcher thread (idempotent)."""
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name=f"serving-{self.node_id}", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=60.0)
            self._thread = None
        self.flush_obs()

    def __enter__(self) -> "ServingNode":
        return self.start()

    def __exit__(self, *exc: object) -> None:
        self.stop()

    def wait_until_deployed(self, timeout: float | None = None) -> bool:
        """Block until the first weight set is live (True) or timeout."""
        return self._deployed_event.wait(timeout)

    # -- watcher thread -------------------------------------------------

    def _run(self) -> None:
        self.poll_once()  # immediate first sweep: resume-from-latest on start
        while not self._stop.wait(self.poll_interval):
            self.poll_once()

    def poll_once(self) -> bool:
        """One freshness sweep (also callable inline, e.g. from tests).
        Returns True when a new deployment was swapped in."""
        swapped = False
        try:
            with self.telemetry.span("serve.poll"):
                dep = self.watcher.poll()
            if dep is not None:
                self.deploy(dep)
                swapped = True
        except Exception:
            _log.warning("serving node %s: poll failed", self.node_id, exc_info=True)
        d = self._deployed
        if d is not None and self.watcher.last_max_counter is not None:
            behind = max(0, self.watcher.last_max_counter - d.counter)
            self.telemetry.observe_staleness(behind)
            with self._lock:
                self._stale_recent.append(float(behind))
                del self._stale_recent[:-_SLO_WINDOW]
        if self.telemetry.enabled:
            self.telemetry.end_round(aggregated=swapped)
            if self.telemetry.should_flush():
                self.flush_obs()
        return swapped

    def deploy(self, dep: Deployment) -> None:
        """Decode ``dep`` into the standby buffer, write it into the standby
        device leaves, and publish them. Runs off the request path;
        ``generate`` never blocks on this."""
        tel = self.telemetry
        t0 = self._clock()
        with tel.span("serve.swap", trace=dep.counter):
            idx = self._standby
            buf = self._buffers[idx]
            with tel.span("serve.swap.stage"):
                if dep.flat is not None:
                    np.copyto(buf, dep.flat)
                else:
                    self.spec.flatten_into(dep.params, buf)
            if self._shardings is not None:
                with tel.span("serve.swap.write"):
                    tree, buf_index = self._materialize_on_mesh(buf), None
            else:
                tree, buf_index = self._materialize_chunked(idx, buf), idx
            # publish: one reference flip; in-flight batches keep their
            # snapshot of the previous tree
            self._deployed = _Deployed(params=tree, source=dep.source, counter=dep.counter,
                                       deployed_at=self._clock(), buf=buf_index,
                                       gen=self._leaf_gen[idx])
            self._standby ^= 1
        t1 = self._clock()
        with self._lock:
            self._swaps += 1
            self._swap_ms.append((t1 - t0) * 1e3)
            del self._swap_ms[:-_SLO_WINDOW]
        self.telemetry.count("serve.swaps")
        self._deployed_event.set()

    def _materialize_on_mesh(self, buf: np.ndarray) -> Any:
        """The standby host buffer as a tree of DTensors: each leaf copied to
        the device whole, then cut to this rank's shard by its sharding."""
        leaves = [torch.from_numpy(buf[o:o + n]).reshape(s).to(self.device, torch_dtype(d))
                  for o, n, s, d in zip(self.spec.offsets, self.spec.sizes, self.spec.shapes,
                                        self.spec.dtypes)]
        tree = distribute(tree_unflatten(self.spec.treedef, leaves), self._shardings)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return tree

    def _materialize_chunked(self, idx: int, buf: np.ndarray) -> Any:
        """Write the standby host buffer into device leaf set ``idx`` in
        ~2 MB chunks, yielding between chunks so decode steps queued on the
        request stream interleave instead of stalling behind one leaf-sized
        copy."""
        # the in-place writes would tear a batch still decoding on this
        # buffer's previous leaves — wait for it to drain (the OTHER buffer
        # stays live the whole time; new batches snapshot that one)
        tel = self.telemetry
        with tel.span("serve.swap.wait"), self._buf_cv:
            drained = self._buf_cv.wait_for(
                lambda: self._buf_refs[idx] == 0, timeout=_SWAP_DRAIN_TIMEOUT_S)
        leaves = self._dev_leaves[idx] if drained else None
        if leaves is None:
            # first swap into this buffer — or a wedged batch at timeout, in
            # which case fresh allocations keep the old leaves intact
            leaves = [torch.empty(s, dtype=torch_dtype(d), device=self.device)
                      for s, d in zip(self.spec.shapes, self.spec.dtypes)]
            self._leaf_gen[idx] += 1
        if self._copier is None:
            self._copier = _ChunkCopier(self.device)
        copier = self._copier
        with tel.span("serve.swap.write"):
            copier.begin()
            last = len(leaves) - 1
            for i, leaf in enumerate(leaves):
                o, n = int(self.spec.offsets[i]), int(self.spec.sizes[i])
                flat = leaf.view(-1)
                for pos in range(0, n, _SWAP_CHUNK):
                    m = min(_SWAP_CHUNK, n - pos)
                    copier.copy(flat[pos:pos + m], buf[o + pos:o + pos + m])
                    if pos + m < n or i < last:
                        time.sleep(_SWAP_PAUSE_S)
            copier.finish()
        self._dev_leaves[idx] = leaves
        return tree_unflatten(self.spec.treedef, leaves)

    # -- request path ---------------------------------------------------

    def generate(
        self,
        prompts,
        *,
        new_tokens: int,
        on_token: Callable[[int], None] | None = None,
    ) -> tuple[np.ndarray, dict]:
        """Batched greedy decode on the currently deployed weights.

        prompts: (B, S) int → ((B, new_tokens) int32 continuations, meta).
        The active weight set is snapshotted once at batch start — a swap
        landing mid-batch does not affect this batch. ``on_token`` (if set)
        is called after each generated token with its index; meta names the
        weight set that served the batch (``source``, ``counter``). Its times
        are the node's spans (one trace a batch).
        """
        # snapshot + in-flight increment under one lock: once the watcher
        # sees a zero refcount for the standby buffer, no new batch can
        # start on it (any new snapshot points at the active buffer)
        with self._buf_cv:
            dep = self._deployed
            if dep is not None and dep.buf is not None:
                self._buf_refs[dep.buf] += 1
        if dep is None:
            raise RuntimeError(
                f"serving node {self.node_id}: no weights deployed yet "
                "(wait_until_deployed, or check the store has pushed updates)")
        try:
            return self._generate_on(dep, prompts, new_tokens, on_token)
        finally:
            if dep.buf is not None:
                with self._buf_cv:
                    self._buf_refs[dep.buf] -= 1
                    self._buf_cv.notify_all()

    def _generate_on(self, dep, prompts, new_tokens, on_token):
        prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.int32).to(self.device)
        B, S = prompts.shape
        tel = self.telemetry
        with self._lock:
            self._batches += 1
            batch_no = self._batches
        with tel.span("serve.cache.init", trace=batch_no):
            cache = self.model.init_cache(B, capacity=S + new_tokens,
                                          window_override=self._window_override,
                                          device=self.device)
        if tel.enabled:
            ring, state = _cache_bytes(cache)
            tel.count("serve.cache.kv_bytes", ring)
            tel.count("serve.cache.state_bytes", state)
        if self.mesh is not None:
            prompts = shard_batch({"tokens": prompts}, self.mesh,
                                  batch_axes=data_axes(self.mesh))["tokens"]
            cache = distribute(cache, serve_cache_shardings(cache, self.mesh))
        t_start = self._clock()
        with tel.span("serve.prefill", trace=batch_no):
            with tel.span("serve.prefill.issue"):
                tok, cache = self._prefill(dep.params, prompts, cache)
            _sync(tok)
        toks = [tok]
        if on_token is not None:
            on_token(0)
        key = (dep.buf, dep.gen, B)
        graph = self._take_graph(dep, key, batch_no) if new_tokens > 1 else None
        try:
            for t in range(1, new_tokens):
                with tel.span("serve.decode", trace=batch_no):
                    with tel.span("serve.decode.issue"):
                        if graph is None:
                            tok, cache = self._serve_step(dep.params, tok, cache, S - 1 + t)
                        else:
                            if t == 1:
                                graph.load(tok, cache)
                            with tel.span("serve.decode.replay"):
                                tok = graph.replay().clone()
                    _sync(tok)
                tel.count("serve.decode.eager" if graph is None else "serve.decode.graph")
                toks.append(tok)
                if on_token is not None:
                    on_token(t)
        finally:
            if graph is not None:
                self._give_back_graph(key)
        t_end = self._clock()
        n_tokens = B * new_tokens
        with self._lock:
            self._requests += 1
            self._tokens += n_tokens
            self._serve_seconds += t_end - t_start
        self.telemetry.count("serve.requests")
        self.telemetry.count("serve.tokens", n_tokens)
        meta = {"source": dep.source, "counter": dep.counter}
        out = torch.stack(toks, dim=1)
        if is_dtensor(out):
            out = out.full_tensor()
        return out.cpu().numpy(), meta

    def _take_graph(self, dep: _Deployed, key: tuple, batch_no: int) -> DecodeGraph | None:
        """The decode graph for ``key`` (the batch's buffer, its leaf-set
        generation and batch size), held for this batch; captured now if
        there is none. None where the node decodes eagerly or another batch
        holds that graph."""
        if not self._graphable:
            return None
        with self._graph_lock:
            if key in self._graphs_busy:
                return None
            self._graphs_busy.add(key)
            graph = self._graphs.get(key)
        if graph is not None:
            return graph
        try:
            with self.telemetry.span("serve.decode.capture", trace=batch_no):
                graph = DecodeGraph(self._serve_step, dep.params, self.model, key[2],
                                    self.device)
        except BaseException:
            with self._graph_lock:
                self._graphs_busy.discard(key)
            raise
        self.telemetry.count("serve.decode.capture")
        with self._graph_lock:
            self._graphs[key] = graph
        return graph

    def _give_back_graph(self, key: tuple) -> None:
        """Release a batch's graph, then drop every idle graph of a stale
        leaf set, and the oldest idle ones past ``_DECODE_GRAPHS``."""
        with self._graph_lock:
            self._graphs_busy.discard(key)
            for k in list(self._graphs):
                buf, gen, _ = k
                if k not in self._graphs_busy and (
                        gen != self._leaf_gen[buf] or len(self._graphs) > _DECODE_GRAPHS):
                    del self._graphs[k]

    # -- SLOs / observability -------------------------------------------

    def stats(self) -> dict:
        """Serving SLO rollup — also the ``serve`` dict in obs payloads."""
        with self._lock:
            swap_sorted = sorted(self._swap_ms)
            stale = list(self._stale_recent)
            swaps, requests, tokens = self._swaps, self._requests, self._tokens
            serve_seconds = self._serve_seconds
        d = self._deployed
        return {
            "deployed": d is not None,
            "source": d.source if d else "",
            "counter": d.counter if d else -1,
            "swaps": swaps,
            "requests": requests,
            "tokens": tokens,
            "tokens_per_sec": round(tokens / serve_seconds, 3) if serve_seconds > 0 else 0.0,
            "swap_ms_p50": round(_percentile(swap_sorted, 0.5), 3),
            "swap_ms_p99": round(_percentile(swap_sorted, 0.99), 3),
            "swap_ms_max": round(swap_sorted[-1], 3) if swap_sorted else 0.0,
            "staleness_mean": round(sum(stale) / len(stale), 4) if stale else 0.0,
            "staleness_max": max(stale) if stale else 0.0,
            "skipped_incompatible": self.watcher.skipped_incompatible,
        }

    def flush_obs(self) -> None:
        """Deposit one ``obs/<node>/<seq>`` blob with the serve SLO dict."""
        if not self.telemetry.enabled:
            return
        try:
            transport = self.store.transport_stats() if hasattr(self.store, "transport_stats") else None
            payload = self.telemetry.snapshot(transport)
            payload["serve"] = self.stats()
            self.store.push_obs(self.node_id, payload["seq"], payload,
                                keep=self.telemetry.obs_keep)
        except Exception:
            # observability must never take down serving
            _log.debug("serving node %s: obs flush failed", self.node_id, exc_info=True)
