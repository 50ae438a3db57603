"""Store-native observability: spans, counters, and ``obs/`` blob rollups (the
port of ``repro.core.telemetry``).

There is no server to scrape, so there is no server to hold metrics either —
telemetry rides the shared folder as its own blob family (``obs/<node>/<seq>``,
the ``obs_of`` envelope in serialize.py), excluded from ``state_hash`` exactly
like ``fleet/`` control blobs, and any peer can assemble the fleet-wide
picture read-only (``python -m repro_torch.obs watch``/``trace``).

Two layers, no dependencies beyond the stdlib:

  * ``SpanRecorder`` — a monotonic-clock flight recorder: ``with rec.span("pull")``
    records one ``SpanRecord`` into a bounded ring (old events drop, a counter
    remembers how many) and folds every span into cumulative per-phase
    aggregates (count/total/min/max) that never grow.
  * ``Telemetry`` — the per-node aggregator. Nodes, the store context, codecs,
    the strategies, the trainer, the serving node and gossip all record through
    it; every ``flush_every`` rounds ``snapshot()`` packages phase latencies,
    the staleness distribution (the FedAsync signal), bytes-per-round and chain
    depth deltas from ``PipelineStats``, prefetch hit rate, trainer throughput,
    and the drained span ring into one JSON-safe payload for
    ``WeightStore.push_obs``.

A span record is a tree node: its name, start and duration on the clock, the
recording thread (``threading.get_ident()``), its own id, its parent's id (0
for a root) and a trace id. The parent is the innermost span open on the same
thread in the same recorder; the open spans live on one thread-local stack,
touched only while telemetry is enabled. The trace id is what spans of one
unit of work share: a caller names it on a root (a node's round counter for
``push``/``pull``/``aggregate``, a serving node's batch number, a deployment's
counter) and children inherit it; a root that names none takes its own id.
Code below a span that holds no ``Telemetry`` of its own (the store's folder
round-trips and codecs, a strategy's stack and combine) records through
``child_span``: into the recorder whose span is innermost on the calling
thread, as that span's child.

A span times the host. Work the card runs asynchronously is timed as long as
the host takes to issue it: tracing never adds a host sync.

When disabled, ``span()`` returns a shared no-op context manager and every
hook is a single attribute check — instrumented code stays on the hot path
unconditionally.

Timestamps: spans are recorded on the monotonic clock (immune to NTP steps);
each ``Telemetry`` notes one ``(time.time(), clock())`` anchor pair at birth
so ``snapshot()`` can export wall-clock-aligned microseconds, which is what
lets ``chrome_trace`` merge rings from different nodes onto one timeline.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import Any, Callable, NamedTuple

__all__ = [
    "SpanRecord",
    "SpanRecorder",
    "Telemetry",
    "child_span",
    "chrome_trace",
    "collect_obs",
    "env_enabled",
    "telemetry_rollups",
]


def env_enabled(default: bool = False) -> bool:
    """True when ``REPRO_OBS`` opts this process into telemetry."""
    raw = os.environ.get("REPRO_OBS", "").strip().lower()
    if not raw:
        return default
    return raw not in ("0", "off", "false", "no")


class _NullSpan:
    """Shared no-op context manager — the disabled-path span."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: object) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class _OpenSpans(threading.local):
    """The spans open on each thread, innermost last, of every recorder. Only
    an enabled span creates a thread's stack; a read elsewhere finds None."""

    stack: "list[_Span] | None" = None


_open = _OpenSpans()


class SpanRecord(NamedTuple):
    """One recorded span; ``t0`` and ``dur`` in seconds on the recorder's
    clock, ``thread`` the recording thread's ``threading.get_ident()``."""

    name: str
    t0: float
    dur: float
    thread: int
    span_id: int
    parent: int
    trace: int


class _Span:
    __slots__ = ("_recorder", "_name", "_trace", "t0", "dur", "span_id", "parent", "trace")

    def __init__(self, recorder: "SpanRecorder", name: str, trace: int | None = None):
        self._recorder = recorder
        self._name = name
        self._trace = trace

    def __enter__(self) -> "_Span":
        rec = self._recorder
        stack = _open.stack
        if stack is None:
            stack = _open.stack = []
        parent = None
        for span in reversed(stack):
            if span._recorder is rec:
                parent = span
                break
        self.span_id = next(rec._ids)
        self.parent = parent.span_id if parent is not None else 0
        if self._trace is not None:
            self.trace = self._trace
        else:
            self.trace = parent.trace if parent is not None else self.span_id
        stack.append(self)
        self.t0 = rec.clock()
        return self

    def __exit__(self, *exc: object) -> bool:
        rec = self._recorder
        self.dur = rec.clock() - self.t0
        stack = _open.stack
        if stack[-1] is self:
            stack.pop()
        else:
            stack.remove(self)
        rec.record(self._name, self.t0, self.dur, span_id=self.span_id,
                   parent=self.parent, trace=self.trace)
        return False


def child_span(name: str, fallback: "Telemetry | None" = None):
    """A span named ``name`` in the recorder whose span is innermost on the
    calling thread, as that span's child; where no span is open there, a span
    of ``fallback`` (a Telemetry attached to a store) when it is enabled; else
    the shared no-op. For code that holds no Telemetry of its own."""
    stack = _open.stack
    if stack:
        return _Span(stack[-1]._recorder, name)
    if fallback is not None and fallback.enabled:
        return fallback.span(name)
    return _NULL_SPAN


class SpanRecorder:
    """Bounded ring of timed spans + cumulative per-phase aggregates.

    The ring holds the most recent ``capacity`` events for trace export (old
    ones drop; ``dropped`` counts them), while the per-phase aggregates fold
    every span ever recorded — so latency breakdowns stay exact even when the
    flight recorder wraps. Thread-safe: the node thread, prefetcher thread,
    watcher thread and trainer all record into one instance.
    """

    def __init__(self, capacity: int = 2048, *, clock: Callable[[], float] = time.perf_counter):
        self.capacity = max(1, int(capacity))
        self.clock = clock
        self.dropped = 0
        self.total_recorded = 0
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._events: deque[SpanRecord] = deque(maxlen=self.capacity)
        self._phases: dict[str, list[float]] = {}

    def span(self, name: str, trace: int | None = None) -> _Span:
        return _Span(self, name, trace)

    def record(self, name: str, t0: float, dur: float, *, span_id: int = 0,
               parent: int = 0, trace: int = 0) -> None:
        """Record one span that the caller timed (a root, on the calling
        thread, unless the ids are given)."""
        event = SpanRecord(name, t0, dur, threading.get_ident(), span_id, parent, trace)
        with self._lock:
            if len(self._events) == self.capacity:
                self.dropped += 1
            self._events.append(event)
            self.total_recorded += 1
            agg = self._phases.get(name)
            if agg is None:
                self._phases[name] = [1, dur, dur, dur]
            else:
                agg[0] += 1
                agg[1] += dur
                if dur < agg[2]:
                    agg[2] = dur
                if dur > agg[3]:
                    agg[3] = dur

    def drain_records(self) -> list[SpanRecord]:
        """Pop and return the ring's full records (aggregates are untouched)."""
        with self._lock:
            events = list(self._events)
            self._events.clear()
        return events

    def drain(self) -> list[tuple[str, float, float]]:
        """Pop and return the ring's events as ``(name, t0, dur)``."""
        return [(e.name, e.t0, e.dur) for e in self.drain_records()]

    def phase_stats(self) -> dict[str, dict[str, float]]:
        with self._lock:
            return {
                name: {
                    "count": int(count),
                    "total_s": total,
                    "mean_s": total / count,
                    "min_s": lo,
                    "max_s": hi,
                }
                for name, (count, total, lo, hi) in self._phases.items()
            }

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


class Telemetry:
    """Per-node telemetry aggregator feeding ``obs/<node>/<seq>`` blobs."""

    def __init__(
        self,
        node_id: str = "",
        *,
        enabled: bool | None = None,
        ring_capacity: int = 2048,
        flush_every: int = 10,
        obs_keep: int = 16,
        staleness_window: int = 256,
        clock: Callable[[], float] = time.perf_counter,
    ):
        self.node_id = node_id
        self.enabled = env_enabled() if enabled is None else bool(enabled)
        self.flush_every = max(1, int(flush_every))
        self.obs_keep = max(1, int(obs_keep))
        self.recorder = SpanRecorder(ring_capacity, clock=clock)
        self.clock = clock
        # Wall/monotonic anchor: spans live on the monotonic clock; exported
        # timestamps are anchor_unix + (t - anchor_mono), comparable across
        # nodes (to wall-clock skew, which Perfetto tolerates per-process).
        self.anchor_unix = time.time()
        self.anchor_mono = clock()
        self.seq = 0
        self.rounds = 0
        self.aggregations = 0
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._stale_count = 0
        self._stale_sum = 0.0
        self._stale_max = 0.0
        self._stale_recent: deque[float] = deque(maxlen=max(1, int(staleness_window)))
        self._train_steps = 0
        self._train_seconds = 0.0
        self._last_transport: dict[str, float] = {}
        self._rounds_at_flush = 0
        self._time_at_flush = time.time()

    # -- recording hooks (hot path) ------------------------------------

    def span(self, name: str, trace: int | None = None):
        """Context manager timing one phase, as a child of the span open
        innermost on this thread in this Telemetry; shared no-op when
        disabled. ``trace`` names the unit of work (children inherit it)."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self.recorder, name, trace)

    def count(self, name: str, n: float = 1) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def counters(self) -> dict[str, float]:
        """A copy of every counter's running total."""
        with self._lock:
            return dict(self._counters)

    def observe_staleness(self, value: float) -> None:
        """Record one peer-update staleness sample (own counter − peer counter)."""
        if not self.enabled:
            return
        value = float(value)
        with self._lock:
            self._stale_count += 1
            self._stale_sum += value
            if value > self._stale_max:
                self._stale_max = value
            self._stale_recent.append(value)

    def note_train(self, steps: int, seconds: float) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._train_steps += int(steps)
            self._train_seconds += float(seconds)

    def end_round(self, *, aggregated: bool) -> None:
        self.rounds += 1
        if aggregated:
            self.aggregations += 1

    def resume(self, rounds: int, counters: dict[str, float] | None = None) -> None:
        """Continue a resumed node's telemetry. The round count and the obs
        sequence start at ``rounds`` (the node's resumed counter): the dead
        incarnation's ``obs/<node>/<seq>`` blobs stay in the store, and a
        sequence restarted at 0 would rank them above the live snapshots.
        ``counters`` (the node's last snapshot's) carry its ``kernel.*``
        launch counts across incarnations."""
        with self._lock:
            self.rounds = self._rounds_at_flush = self.seq = int(rounds)
            for name, n in (counters or {}).items():
                if name.startswith("kernel."):
                    self._counters[name] = self._counters.get(name, 0) + n

    def should_flush(self) -> bool:
        return self.enabled and self.rounds > 0 and self.rounds % self.flush_every == 0

    # -- snapshots ------------------------------------------------------

    def _to_unix_us(self, t_mono: float) -> int:
        return int(round((self.anchor_unix + (t_mono - self.anchor_mono)) * 1e6))

    def staleness_stats(self) -> dict[str, float]:
        with self._lock:
            recent = sorted(self._stale_recent)
            count, total, peak = self._stale_count, self._stale_sum, self._stale_max
        out = {
            "count": count,
            "mean": (total / count) if count else 0.0,
            "max": peak,
        }
        if recent:
            out["p50"] = recent[len(recent) // 2]
            out["p90"] = recent[min(len(recent) - 1, int(len(recent) * 0.9))]
        else:
            out["p50"] = out["p90"] = 0.0
        return out

    def brief(self) -> dict[str, float]:
        """Tiny rollup for heartbeat payloads (thin telemetry deposits)."""
        stale = self.staleness_stats()
        phases = self.recorder.phase_stats()

        def mean_ms(name: str) -> float:
            agg = phases.get(name)
            return round(agg["mean_s"] * 1e3, 3) if agg else 0.0

        return {
            "rounds": self.rounds,
            "staleness_mean": round(stale["mean"], 3),
            "staleness_p90": round(stale["p90"], 3),
            "pull_ms": mean_ms("pull"),
            "push_ms": mean_ms("push"),
            "aggregate_ms": mean_ms("aggregate"),
        }

    def snapshot(self, transport_stats: dict[str, float] | None = None) -> dict[str, Any]:
        """Package current state into one ``obs/`` payload and advance ``seq``.

        Cumulative signals (phase aggregates, staleness, counters, transport
        stats) carry the full history — readers only need each node's latest
        blob. The span ring drains here; ``transport_delta`` and the derived
        bytes-per-round / round rate cover just the window since last flush.
        """
        now_unix = time.time()
        transport = dict(transport_stats or {})
        spans = [
            [e.name, self._to_unix_us(e.t0), int(round(e.dur * 1e6)), e.thread, e.span_id,
             e.parent, e.trace]
            for e in self.recorder.drain_records()
        ]
        with self._lock:
            counters = dict(self._counters)
            train_steps, train_seconds = self._train_steps, self._train_seconds
            last_transport = self._last_transport
            rounds_at_flush = self._rounds_at_flush
            time_at_flush = self._time_at_flush
        delta = {
            k: v - last_transport.get(k, 0)
            for k, v in transport.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)
        }
        window_rounds = max(0, self.rounds - rounds_at_flush)
        window_seconds = max(1e-9, now_unix - time_at_flush)
        hits = transport.get("decode_hits", 0)
        misses = transport.get("decode_misses", 0)
        payload: dict[str, Any] = {
            "node_id": self.node_id,
            "seq": self.seq,
            "time_unix": now_unix,
            "rounds": self.rounds,
            "aggregations": self.aggregations,
            "phases": self.recorder.phase_stats(),
            "staleness": self.staleness_stats(),
            "counters": counters,
            "train": {
                "steps": train_steps,
                "seconds": train_seconds,
                "steps_per_sec": train_steps / train_seconds if train_seconds > 0 else 0.0,
            },
            "transport": transport,
            "transport_delta": delta,
            "window": {
                "rounds": window_rounds,
                "seconds": window_seconds,
                "rounds_per_sec": window_rounds / window_seconds,
                "bytes_written_per_round": (
                    delta.get("bytes_written", 0) / window_rounds if window_rounds else 0.0
                ),
            },
            "chain_depth": transport.get("chain_depth", 0),
            "prefetch_hit_rate": hits / (hits + misses) if (hits + misses) else 0.0,
            "spans": spans,
            "dropped_spans": self.recorder.dropped,
        }
        with self._lock:
            self.seq += 1
            self._last_transport = {
                k: v
                for k, v in transport.items()
                if isinstance(v, (int, float)) and not isinstance(v, bool)
            }
            self._rounds_at_flush = self.rounds
            self._time_at_flush = now_unix
        return payload


# -- fleet-side assembly (read-only, coordinator-free) ------------------


def collect_obs(store_uri_or_folder: Any) -> dict[str, list[dict[str, Any]]]:
    """Gather every ``obs/`` payload in a store, node → payloads by seq.

    Accepts a ``make_folder`` URI, a ``SharedFolder``, or a ``ShardedFolders``
    (all groups scanned). Pure reads — never writes, never aggregates weights.
    """
    from .gossip import ShardedFolders
    from .serialize import deserialize_obs_blob
    from .store import make_folder

    folder = store_uri_or_folder
    if isinstance(folder, str):
        folder = make_folder(folder)
    folders = (
        [folder.group_folder(g) for g in range(folder.num_groups)]
        if isinstance(folder, ShardedFolders)
        else [folder]
    )
    by_node: dict[str, list[tuple[int, dict[str, Any]]]] = {}
    for f in folders:
        for key in f.keys():
            if not key.startswith("obs/"):
                continue
            blob = f.get(key)
            if blob is None:
                continue
            try:
                node_id, seq, payload = deserialize_obs_blob(blob)
            except (ValueError, KeyError):
                continue
            by_node.setdefault(node_id, []).append((seq, payload))
    return {
        node: [payload for _seq, payload in sorted(pairs, key=lambda p: p[0])]
        for node, pairs in sorted(by_node.items())
    }


def kernel_launches(obs_by_node: dict[str, list[dict[str, Any]]]) -> dict[str, int]:
    """Kernel launches a fleet's nodes made, wherever they ran: the
    ``kernel.<name>`` counters of each node's newest payload, summed by name
    (a resumed or adopted node carries its earlier incarnation's count
    forward, so the newest payload holds the node's total)."""
    totals: dict[str, int] = {}
    for payloads in obs_by_node.values():
        counters = (payloads[-1].get("counters") or {}) if payloads else {}
        for key, n in counters.items():
            if key.startswith("kernel."):
                totals[key[len("kernel."):]] = totals.get(key[len("kernel."):], 0) + int(n)
    return totals


def telemetry_rollups(obs_by_node: dict[str, list[dict[str, Any]]]) -> dict[str, Any]:
    """Fold collected ``obs/`` payloads into per-node + fleet rollups.

    Cumulative fields come from each node's latest payload; round rate spans
    first→last payload when a node deposited more than one.
    """
    nodes: dict[str, Any] = {}
    for node_id, payloads in obs_by_node.items():
        if not payloads:
            continue
        last = payloads[-1]
        phases = last.get("phases") or {}
        phase_ms = {
            name: round(agg.get("mean_s", 0.0) * 1e3, 3) for name, agg in phases.items()
        }
        stale = last.get("staleness") or {}
        rate = (last.get("window") or {}).get("rounds_per_sec", 0.0)
        if len(payloads) > 1:
            dt = last.get("time_unix", 0) - payloads[0].get("time_unix", 0)
            dr = last.get("rounds", 0) - payloads[0].get("rounds", 0)
            if dt > 0:
                rate = dr / dt
        transport = last.get("transport") or {}
        counters = last.get("counters") or {}
        nodes[node_id] = {
            # Serving nodes enrich their payloads with a "serve" dict (SLOs:
            # swap latency, rounds-behind-store staleness, throughput); its
            # presence is what distinguishes the serving tier in rollups.
            "role": "serve" if last.get("serve") else "train",
            "rounds": last.get("rounds", 0),
            # Elastic-fleet churn markers: a node counts node.adopted once
            # when a surviving worker resumes it from a lapsed lease.
            "adopted": bool(counters.get("node.adopted", 0)),
            "lease_epoch": int(counters.get("node.lease_epoch", 0)),
            "aggregations": last.get("aggregations", 0),
            "rounds_per_sec": round(float(rate), 4),
            "staleness_mean": round(float(stale.get("mean", 0.0)), 4),
            "staleness_p90": round(float(stale.get("p90", 0.0)), 4),
            "staleness_max": float(stale.get("max", 0.0)),
            "phase_ms": phase_ms,
            "bytes_written": transport.get("bytes_written", 0),
            "bytes_read": transport.get("bytes_read", 0),
            "chain_depth": last.get("chain_depth", 0),
            "prefetch_hit_rate": round(float(last.get("prefetch_hit_rate", 0.0)), 4),
            "train_steps_per_sec": round(
                float((last.get("train") or {}).get("steps_per_sec", 0.0)), 3
            ),
            "dropped_spans": last.get("dropped_spans", 0),
        }
        if last.get("serve"):
            nodes[node_id]["serve"] = last["serve"]
    fleet: dict[str, Any] = {"nodes_reporting": len(nodes)}
    if nodes:
        vals = list(nodes.values())
        fleet["rounds_total"] = sum(v["rounds"] for v in vals)
        fleet["staleness_mean"] = round(
            sum(v["staleness_mean"] for v in vals) / len(vals), 4
        )
        fleet["staleness_p90_max"] = max(v["staleness_p90"] for v in vals)
        fleet["bytes_written"] = sum(v["bytes_written"] for v in vals)
        fleet["adoptions"] = sum(1 for v in vals if v["adopted"])
        fleet["serving_nodes"] = sum(1 for v in vals if v["role"] == "serve")
        phase_names = sorted({name for v in vals for name in v["phase_ms"]})
        fleet["phase_ms"] = {
            name: round(
                sum(v["phase_ms"].get(name, 0.0) for v in vals)
                / max(1, sum(1 for v in vals if name in v["phase_ms"])),
                3,
            )
            for name in phase_names
        }
    return {"nodes": nodes, "fleet": fleet}


def chrome_trace(obs_by_node: dict[str, list[dict[str, Any]]]) -> dict[str, Any]:
    """Merge per-node span rings into one Chrome trace-event JSON document.

    Each node becomes a process (integer pid + a ``process_name`` metadata
    event); spans become ``ph: "X"`` complete events with wall-clock-anchored
    microsecond timestamps, so Perfetto / chrome://tracing lays the whole
    fleet on one timeline. Each recording thread of a node gets its own
    ``tid`` (0, 1, ... in order of first appearance), and a span's ids ride
    as ``args`` (``span``, ``parent``, ``trace``). Spans of payloads that
    carry no thread (``[name, ts, dur]``) all land on ``tid`` 0.
    """
    events: list[dict[str, Any]] = []
    for pid, (node_id, payloads) in enumerate(sorted(obs_by_node.items())):
        events.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {"name": node_id or f"node{pid}"},
            }
        )
        tids: dict[int, int] = {}
        for payload in payloads:
            for span in payload.get("spans") or []:
                name, ts_us, dur_us = span[0], int(span[1]), int(span[2])
                event = {
                    "name": str(name),
                    "cat": "repro",
                    "ph": "X",
                    "ts": ts_us,
                    "dur": max(0, dur_us),
                    "pid": pid,
                    "tid": 0,
                }
                if len(span) >= 7:
                    event["tid"] = tids.setdefault(int(span[3]), len(tids))
                    event["args"] = {"span": int(span[4]), "parent": int(span[5]),
                                     "trace": int(span[6])}
                events.append(event)
    return {"traceEvents": events, "displayTimeUnit": "ms"}
