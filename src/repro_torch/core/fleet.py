"""Multi-host fleet launcher + chaos soak harness (the port of
``repro.core.fleet``).

Generalizes ``run_multiprocess`` from "N processes, one parent" to
"N nodes × M hosts, **no parent required**". Everything the fleet needs to
coordinate — the declarative :class:`FleetSpec`, slot claims, heartbeats,
per-node results, per-worker reports — lives *in the shared folder itself*
as ``fleet/``-prefixed blobs (meta-dispatched like every other deposit, and
excluded from all federation state hashes), so the launcher mirrors the
serverless design exactly: there is no coordinator in the data path.

The moving parts:

* **FleetSpec** — nodes, rounds, strategy, transport pipeline spec, store URI
  (the existing ``cache+`` / ``shard<G>[x<L>]+`` grammar), runner kind and a
  seeded chaos schedule. ``repro_torch.fleet init`` serializes it to the shared folder;
  from then on any host can join.

* **Workers** (``repro_torch.fleet worker --store <uri>``) — each host reads the
  spec, *claims node slots* via atomic ``put_if_absent`` writes (link(2) on
  DiskFolder — atomic even on NFS), runs its claimed nodes in local OS
  processes under a :class:`ProcessSupervisor` (or threads, for in-process
  soaks at 10²-node scale), drives the chaos schedule against them, and
  deposits heartbeat + result blobs. A restarted worker (same ``worker_id``)
  reclaims its own slots.

* **Leases + crash adoption** — slot claims are not permanent: each claim is
  a lease blob (``fleet/lease/<node>/<epoch>``) whose deadline a background
  :class:`_LeaseKeeper` refreshes while its worker lives. A claim is valid
  only while its lease is fresh. When a *worker* dies (not just a node), its
  leases silently expire, and any surviving worker's adoption sweep
  re-claims the stranded slot via ``put_if_absent`` on the **next** lease
  epoch — CAS-by-key, so exactly one adopter wins by construction — then
  resumes the node from its own ``latest/`` blob. Updates pushed by adopted
  nodes carry their lease epoch in the wire meta, which FedAsync's epoch-gap
  discount uses to keep resurrected stragglers from yanking consensus.

* **Chaos engine** — extends ``kill_after`` into a *seeded, randomized
  schedule* derived deterministically from ``(seed, node_id)``: victims park
  mid-round after a drawn number of federation pushes, the worker SIGKILLs
  them the moment the parked heartbeat lands (backstop timer otherwise), then
  respawns them after ``restart_after`` — the reborn node must *resume*
  (counter, params, strategy state) from its own deposits. Stall events make
  drawn nodes sleep mid-soak (the slow-node/straggler case async federation
  must absorb). ``ChaosSpec.kill_workers`` escalates to *worker-level* chaos:
  victim workers drawn deterministically from ``(seed, worker_id)`` die whole
  (SIGKILL of the worker process and its node children under the process
  runner; an abort that strands every client mid-round under the thread
  runner), exercising the lease-expiry → adoption path end-to-end.

* **SoakReport** (``repro_torch.fleet watch`` / ``report``, or any worker) —
  assembled purely from the folder: rounds completed per node, crashes
  injected / survived, restart recoveries (``resumed``), recovery latency,
  per-pipeline :class:`PipelineStats` rollups, wall-clock / bytes budgets.
  The soak *passes* only if every node finished its rounds, every
  killed-then-restarted node reports ``resumed=True``, and **every worker
  independently computed the same fleet-wide ``state_hash``** over the data
  plane after quiescence.

The port keeps the reference's control plane byte for byte: the spec, lease,
heartbeat, result and worker blobs carry the same keys with the same
meanings, and the chaos draws (victims, park and stall points, worker-kill
thresholds) use numpy's generators exactly as the reference does — so JAX
and torch workers join one fleet, and either package's ``assemble_report``
reads it. The device is a worker-local choice (``run_worker(device=...)``),
never a spec field: the reference's ``FleetSpec.from_dict`` rejects unknown
fields. A soak node holds its model as an f32 tensor on that device and
aggregates there (one ``fed_agg`` or ``fed_opt`` launch per aggregate on the
card); its launches reach the store as ``kernel.<name>`` telemetry counters.
"""
from __future__ import annotations

import hashlib
import json
import os
import signal
import threading
import time
import uuid
from dataclasses import asdict, dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.kernels import resolve_device
from repro_torch.logs import get_logger

from .node import AsyncFederatedNode
from .serialize import deserialize_fleet_blob, serialize_fleet_blob
from .simulation import ProcessSupervisor
from .store import SharedFolder, make_folder
from .strategies import STRATEGIES, get_strategy
from .telemetry import Telemetry, collect_obs, telemetry_rollups
from .transport import normalize_transport, parse_folder_uri
from .tree import as_tensor

_log = get_logger("fleet")

FLEET_PREFIX = "fleet/"
SPEC_KEY = "fleet/spec"
_CLAIM_PREFIX = "fleet/claim/"  # legacy permanent claims (read-compat only)
_LEASE_PREFIX = "fleet/lease/"
_HEARTBEAT_PREFIX = "fleet/heartbeat/"
_RESULT_PREFIX = "fleet/result/"
_WORKER_PREFIX = "fleet/worker/"


# --------------------------------------------------------------------------
# Declarative specs
# --------------------------------------------------------------------------


@dataclass
class ChaosSpec:
    """Seeded chaos parameters; the concrete per-node schedule is derived
    deterministically by :func:`chaos_schedule` (same seed + node set →
    identical schedule on every host, with no host-to-host messages)."""

    seed: int = 0
    kills: int = 0                 # distinct SIGKILL-then-restart victims
    park_after: tuple = (2, 4)     # victim parks after U[a,b] federation pushes
    kill_grace: float = 30.0       # backstop SIGKILL this long after spawn
    restart_after: float = 0.5     # delay before the victim is respawned
    stalls: int = 0                # distinct slow-node stall victims
    stall_after: tuple = (1, 3)    # stall after U[a,b] pushes
    stall_duration: float = 1.0
    kill_workers: int = 0          # whole-WORKER kill victims (lease adoption)
    kill_workers_after: tuple = (1, 3)  # fire once a victim's node pushed U[a,b]

    def to_dict(self) -> dict:
        d = asdict(self)
        d["park_after"] = list(self.park_after)
        d["stall_after"] = list(self.stall_after)
        d["kill_workers_after"] = list(self.kill_workers_after)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ChaosSpec":
        d = dict(d)
        for key in ("park_after", "stall_after", "kill_workers_after"):
            if key in d:
                d[key] = tuple(int(v) for v in d[key])
        return cls(**d)


@dataclass
class FleetSpec:
    """One soak, declaratively: everything a joining host needs to run its
    share of the fleet. Serialized to the shared folder (``fleet/spec``) —
    the spec travels with the store, not with any process."""

    store_uri: str                 # data plane; cache+/shard<G>[x<L>]+ grammar
    name: str = "soak"
    num_nodes: int = 8
    rounds: int = 10               # federation pushes per node, across incarnations
    strategy: str = "fedavg"
    transport: str | None = None   # pipeline spec string (transport.py grammar)
    runner: str = "process"        # "process" (real SIGKILLs) | "thread" (in-process soaks)
    param_size: int = 256          # synthetic consensus model size (f32 entries)
    round_sleep: float = 0.05      # local "training" time per round
    settle: float = 1.0            # quiescence wait before the fleet hash
    result_timeout: float = 180.0  # how long a worker waits for ALL fleet results
    node_prefix: str = "node"
    lease_ttl: float = 15.0        # slot-lease freshness horizon (store clock domain)
    chaos: ChaosSpec = field(default_factory=ChaosSpec)

    def __post_init__(self) -> None:
        if isinstance(self.chaos, dict):
            self.chaos = ChaosSpec.from_dict(self.chaos)
        if self.num_nodes < 1:
            raise ValueError(f"num_nodes must be >= 1, got {self.num_nodes}")
        if self.rounds < 1:
            raise ValueError(f"rounds must be >= 1, got {self.rounds}")
        if self.runner not in ("process", "thread"):
            raise ValueError(f"runner must be 'process' or 'thread', got {self.runner!r}")
        if self.param_size < 1:
            raise ValueError(f"param_size must be >= 1, got {self.param_size}")
        if self.lease_ttl <= 0:
            raise ValueError(f"lease_ttl must be > 0, got {self.lease_ttl}")
        if self.chaos.kills < 0 or self.chaos.stalls < 0 or self.chaos.kill_workers < 0:
            raise ValueError(
                "chaos.kills / chaos.stalls / chaos.kill_workers must be >= 0")
        if self.chaos.kill_workers and self.rounds < 2:
            raise ValueError("worker-kill chaos needs rounds >= 2 (a victim's "
                             "node must push at least once before its worker "
                             "dies, so the adopter has a blob to resume from)")
        if self.chaos.kills + self.chaos.stalls > self.num_nodes:
            raise ValueError(
                f"chaos victims ({self.chaos.kills} kills + {self.chaos.stalls} "
                f"stalls) exceed num_nodes={self.num_nodes}")
        if self.chaos.kills and self.rounds < 2:
            raise ValueError("kill chaos needs rounds >= 2 (a victim must push "
                             "at least once before dying, and finish after)")
        # Fail fast on misspelled strategy/transport — at spec construction,
        # not inside every spawned client N processes later (same convention
        # as ShardedWeightStore's throwaway-pipeline probe). The grammar-only
        # normalize (no zstd import probe) keeps a spec WRITABLE from a host
        # without the module its workers have.
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}; "
                             f"options: {sorted(STRATEGIES)}")
        if self.transport is not None:
            normalize_transport(self.transport)

    # -- store access --------------------------------------------------------
    def connect(self, **kwargs):
        """Open this spec's data-plane store through the ``repro_torch.api``
        facade (the spec's transport is the default; any ``connect()`` kwarg
        can override or extend it)."""
        from repro_torch.api import connect

        kwargs.setdefault("transport", self.transport)
        return connect(self.store_uri, **kwargs)

    # -- node naming ---------------------------------------------------------
    def node_id(self, slot: int) -> str:
        return f"{self.node_prefix}{slot:04d}"

    def node_ids(self) -> list[str]:
        return [self.node_id(s) for s in range(self.num_nodes)]

    def target_of(self, slot: int) -> float:
        """Per-node consensus target for the synthetic quadratic clients —
        distinct but bounded, so the fleet's convex hull stays small."""
        return float(slot % 5)

    # -- wire ----------------------------------------------------------------
    def to_dict(self) -> dict:
        d = asdict(self)
        d["chaos"] = self.chaos.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FleetSpec":
        d = dict(d)
        if "chaos" in d and isinstance(d["chaos"], dict):
            d["chaos"] = ChaosSpec.from_dict(d["chaos"])
        return cls(**d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "FleetSpec":
        return cls.from_dict(json.loads(text))


# --------------------------------------------------------------------------
# Seeded chaos schedule
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class ChaosEvent:
    node_id: str
    kind: str                  # "kill" | "stall"
    after_pushes: int          # trigger once the node has pushed this often
    restart_after: float = 0.0  # kill only: respawn delay
    duration: float = 0.0       # stall only: sleep length


def _node_rng(seed: int, node_id: str) -> np.random.Generator:
    """Per-node generator keyed on (seed, node_id) — the schedule is a pure
    function of the spec, independent of iteration order or host."""
    digest = hashlib.sha256(f"{seed}:{node_id}".encode()).digest()
    return np.random.default_rng(int.from_bytes(digest[:8], "big"))


def chaos_schedule(spec: FleetSpec) -> dict[str, list[ChaosEvent]]:
    """The concrete, deterministic chaos schedule for ``spec``: node id →
    events. Every host derives the same schedule from the spec alone, so the
    chaos engine needs no coordination either — each worker injects exactly
    the events of the nodes it claimed."""
    chaos = spec.chaos
    ids = spec.node_ids()
    rng = np.random.default_rng(chaos.seed)
    order = [ids[i] for i in rng.permutation(len(ids))]
    victims = order[:chaos.kills]
    stalled = order[chaos.kills:chaos.kills + chaos.stalls]
    out: dict[str, list[ChaosEvent]] = {}
    for nid in victims:
        r = _node_rng(chaos.seed, nid)
        lo, hi = chaos.park_after
        park = int(r.integers(min(lo, hi), max(lo, hi) + 1))
        # a victim must have pushed at least once (there must be a blob to
        # resume from) and must NOT have finished its rounds already
        park = max(1, min(park, spec.rounds - 1))
        out[nid] = [ChaosEvent(nid, "kill", park, restart_after=chaos.restart_after)]
    for nid in stalled:
        r = _node_rng(chaos.seed, nid)
        lo, hi = chaos.stall_after
        after = max(1, min(int(r.integers(min(lo, hi), max(lo, hi) + 1)), spec.rounds))
        out.setdefault(nid, []).append(
            ChaosEvent(nid, "stall", after, duration=chaos.stall_duration))
    return out


# --------------------------------------------------------------------------
# Control plane: spec + claims + heartbeats in the shared folder
# --------------------------------------------------------------------------


def fleet_control_uri(store_uri: str) -> str:
    """The control-plane folder URI for a data-plane store URI: the innermost
    base with every ``cache+`` / ``shard<G>[x<L>]+`` wrapper stripped. For a flat
    disk store, control and data share one folder (``fleet/`` keys are
    excluded from every state hash); for a sharded store the control blobs
    live in the base directory *above* the per-group folders."""
    _wrappers, base = parse_folder_uri(store_uri)
    if base.startswith("memory://"):
        raise ValueError(
            "the fleet control plane must be reachable by every host — "
            "use a shared mount (disk path) or s3://, not memory://")
    return base


def control_folder(store_uri: str) -> SharedFolder:
    return make_folder(fleet_control_uri(store_uri))


def write_spec(control: SharedFolder, spec: FleetSpec) -> None:
    control.put(SPEC_KEY, serialize_fleet_blob("spec", spec.to_dict()))


def read_spec(control: SharedFolder, *, timeout: float = 0.0,
              poll: float = 0.2) -> FleetSpec:
    """Read (polling up to ``timeout`` — a worker may come up before the
    launcher) the fleet spec from the control folder."""
    deadline = time.monotonic() + timeout
    while True:
        blob = control.get(SPEC_KEY)
        if blob is not None:
            kind, payload = deserialize_fleet_blob(blob)
            if kind == "spec":
                return FleetSpec.from_dict(payload)
        if time.monotonic() >= deadline:
            raise TimeoutError(f"no fleet spec at {SPEC_KEY!r} after {timeout}s")
        time.sleep(poll)


def claim_key(slot: int) -> str:
    return f"{_CLAIM_PREFIX}{slot:04d}"


# -- leased slot claims -------------------------------------------------------
#
# A slot claim is a *lease*: ``fleet/lease/<node>/<epoch>`` carries the owning
# worker, the lease epoch, and a deadline in the store's wall-clock domain
# that the owner's _LeaseKeeper refreshes while it lives. Epoch keys are
# write-once (put_if_absent / link(2)), so contention — the initial claim race
# at epoch 0, and every adoption race at epoch N+1 — is CAS-by-key with
# exactly one winner by construction. Epochs only move forward: a worker that
# observes an expired lease adopts the slot by winning the NEXT epoch's key,
# and the stale epoch keys are garbage-collected by the winner. Ownership of
# a slot is therefore: "holder of the freshest epoch key, while fresh".


def lease_key(node_id: str, epoch: int) -> str:
    return f"{_LEASE_PREFIX}{node_id}/{epoch:06d}"


def _parse_lease_key(key: str) -> tuple[str, int] | None:
    if not key.startswith(_LEASE_PREFIX):
        return None
    node_id, _, tail = key[len(_LEASE_PREFIX):].rpartition("/")
    if not node_id or not tail.isdigit():
        return None
    return node_id, int(tail)


def _lease_blob(spec: FleetSpec, worker_id: str, slot: int, epoch: int) -> bytes:
    now = time.time()
    return serialize_fleet_blob("lease", {
        "worker": worker_id, "slot": slot, "node_id": spec.node_id(slot),
        "epoch": epoch, "deadline": now + spec.lease_ttl, "time": now})


def lease_fresh(payload: dict, now: float | None = None) -> bool:
    """A lease is valid only while its heartbeat-refreshed deadline has not
    lapsed. Deadlines live in the store's wall-clock domain (every worker
    reads the same mount, so ``time.time()`` skew between hosts must stay
    well under ``lease_ttl`` — the same assumption NFS lock daemons make)."""
    return float(payload.get("deadline", 0.0)) >= (
        time.time() if now is None else now)


def read_lease_index(control: SharedFolder) -> dict[str, tuple[int, dict | None]]:
    """node id -> (freshest lease epoch, its payload — None if unreadable)."""
    freshest: dict[str, int] = {}
    for key in control.keys():
        parsed = _parse_lease_key(key)
        if parsed is None:
            continue
        nid, epoch = parsed
        if epoch > freshest.get(nid, -1):
            freshest[nid] = epoch
    return {nid: (epoch, _read_fleet_blob(control, lease_key(nid, epoch)))
            for nid, epoch in freshest.items()}


def _gc_stale_leases(control: SharedFolder, node_id: str, below_epoch: int) -> None:
    """Delete superseded lease epochs for ``node_id`` — except epoch 0, which
    is the permanent founding-roster record (worker-kill victim ranking and
    the report's ``workers_lost`` are both computed from epoch-0 payloads)."""
    for key in control.keys():
        parsed = _parse_lease_key(key)
        if parsed is not None and parsed[0] == node_id and 0 < parsed[1] < below_epoch:
            control.delete(key)


def try_adopt(control: SharedFolder, spec: FleetSpec, worker_id: str,
              node_id: str, slot: int, epoch: int) -> bool:
    """CAS-claim ``node_id`` at lease ``epoch`` (the expired lease's epoch
    + 1). Racing adopters all target the same write-once key, so exactly one
    wins; the winner GCs the superseded epoch keys. True iff we adopted."""
    won = control.put_if_absent(
        lease_key(node_id, epoch), _lease_blob(spec, worker_id, slot, epoch))
    if won:
        _gc_stale_leases(control, node_id, epoch)
        _log.info("worker %s: adopted %s at lease epoch %d", worker_id,
                  node_id, epoch)
    return won


def claim_leases(control: SharedFolder, spec: FleetSpec, worker_id: str, *,
                 max_slots: int | None = None) -> dict[int, int]:
    """Claim up to ``max_slots`` node slots for ``worker_id``; returns
    slot -> lease epoch claimed at. Unleased slots are claimed at epoch 0;
    a worker restarting under the same id re-validates its own fresh leases;
    expired leases (own or foreign) are adopted at the next epoch. Slots
    under a *fresh* foreign lease are never touched — concurrent workers
    partition the fleet with no messages between them."""
    mine: dict[int, int] = {}
    index = read_lease_index(control)
    for slot in range(spec.num_nodes):
        if max_slots is not None and len(mine) >= max_slots:
            break
        nid = spec.node_id(slot)
        have = index.get(nid)
        if have is None:
            if control.put_if_absent(
                    lease_key(nid, 0), _lease_blob(spec, worker_id, slot, 0)):
                mine[slot] = 0
                continue
            # lost the epoch-0 race; the winner's blob is visible now
            have = (0, _read_fleet_blob(control, lease_key(nid, 0)))
        epoch, payload = have
        if payload is None:
            continue
        now = time.time()
        if payload.get("worker") == worker_id and lease_fresh(payload, now):
            # ours (a previous incarnation under this id): refresh and keep.
            # Only the owner ever rewrites a live epoch key, so this plain
            # put races nobody.
            control.put(lease_key(nid, epoch),
                        _lease_blob(spec, worker_id, slot, epoch))
            mine[slot] = epoch
        elif not lease_fresh(payload, now):
            # expired — even if it was ours: adopt at the next epoch so a
            # concurrent adopter and we cannot both think we own it
            if try_adopt(control, spec, worker_id, nid, slot, epoch + 1):
                mine[slot] = epoch + 1
    return mine


def claim_slots(control: SharedFolder, spec: FleetSpec, worker_id: str, *,
                max_slots: int | None = None) -> list[int]:
    """Lease-based slot claim (see :func:`claim_leases`); returns the claimed
    slot numbers, sorted."""
    return sorted(claim_leases(control, spec, worker_id, max_slots=max_slots))


class _LeaseKeeper:
    """One per worker: refreshes every owned lease at ``lease_ttl / 3`` so
    ownership survives exactly as long as the worker does. Worker death —
    SIGKILL, OOM, power loss — needs no cleanup path: the keeper dies with
    the process, the leases lapse, and survivors adopt. ``stop()`` is for
    *simulated* death (thread-runner worker-kill chaos) and orderly exits."""

    def __init__(self, control: SharedFolder, spec: FleetSpec, worker_id: str):
        self._control = control
        self._spec = spec
        self._worker_id = worker_id
        self._owned: dict[str, tuple[int, int]] = {}  # node -> (slot, epoch)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def add(self, node_id: str, slot: int, epoch: int) -> None:
        with self._lock:
            self._owned[node_id] = (slot, epoch)

    def drop(self, node_id: str) -> None:
        with self._lock:
            self._owned.pop(node_id, None)

    def owns(self, node_id: str) -> bool:
        with self._lock:
            return node_id in self._owned

    def owned(self) -> dict[str, tuple[int, int]]:
        with self._lock:
            return dict(self._owned)

    def epoch_of(self, node_id: str) -> int:
        with self._lock:
            entry = self._owned.get(node_id)
        return entry[1] if entry is not None else 0

    def refresh_now(self) -> None:
        for nid, (slot, epoch) in self.owned().items():
            try:
                self._control.put(
                    lease_key(nid, epoch),
                    _lease_blob(self._spec, self._worker_id, slot, epoch))
            except Exception:
                _log.debug("worker %s: lease refresh of %s failed",
                           self._worker_id, nid, exc_info=True)

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name=f"lease-keeper-{self._worker_id}")
            self._thread.start()

    def _run(self) -> None:
        interval = max(0.05, self._spec.lease_ttl / 3.0)
        while not self._stop.wait(interval):
            self.refresh_now()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)


def _heartbeat(control: SharedFolder, node_id: str, payload: dict) -> None:
    control.put(f"{_HEARTBEAT_PREFIX}{node_id}", serialize_fleet_blob("heartbeat", payload))


def _read_fleet_blob(control: SharedFolder, key: str) -> dict | None:
    blob = control.get(key)
    if blob is None:
        return None
    try:
        _kind, payload = deserialize_fleet_blob(blob)
    except (ValueError, KeyError):
        return None
    return payload


# --------------------------------------------------------------------------
# Worker-level chaos: seeded whole-worker kills
# --------------------------------------------------------------------------


def founding_workers(control: SharedFolder) -> list[str]:
    """The workers holding epoch-0 leases — the roster worker-kill chaos
    draws its victims from. Epoch 0 never changes after the initial claims,
    so every host derives the same set (late joiners and adopters hold only
    higher epochs and are never victims)."""
    out: set[str] = set()
    for key in control.keys():
        parsed = _parse_lease_key(key)
        if parsed is not None and parsed[1] == 0:
            payload = _read_fleet_blob(control, key)
            if payload is not None and payload.get("worker") is not None:
                out.add(str(payload["worker"]))
    return sorted(out)


def worker_kill_victims(control: SharedFolder, chaos: ChaosSpec) -> list[str]:
    """The ``chaos.kill_workers`` victim worker ids, deterministically from
    ``(seed, worker_id)``: rank founding workers by a seeded hash, take the
    first N. Any host computes the same list from the store alone."""
    if chaos.kill_workers < 1:
        return []
    ranked = sorted(
        founding_workers(control),
        key=lambda w: hashlib.sha256(
            f"{chaos.seed}:workerkill:{w}".encode()).hexdigest())
    return ranked[:chaos.kill_workers]


class _KillSwitch:
    """Executes ``ChaosSpec.kill_workers`` against the worker it lives in.

    Waits until the whole fleet is claimed (the victim rank must be computed
    over the complete founding roster on every host), checks whether this
    worker is drawn, then fires once one of its nodes has pushed a seeded
    number of times — i.e. mid-soak, while other nodes are still mid-round,
    so slots are genuinely stranded.

    Firing in ``sigkill`` mode (the CLI worker — a real OS process) SIGKILLs
    the supervised node children and then the worker process itself: no
    cleanup, no lease release, exactly a host loss. ``simulate`` mode (for
    in-process workers sharing a test/benchmark process) stops the lease
    keeper, aborts the clients, and makes ``run_worker`` return without a
    results-wait or worker blob — the same observable store state as a real
    death, minus the signal.
    """

    def __init__(self, control: SharedFolder, spec: FleetSpec, worker_id: str,
                 slots: list[int], keeper: _LeaseKeeper, *,
                 mode: str = "simulate"):
        if mode not in ("simulate", "sigkill", "off"):
            raise ValueError(f"unknown worker-kill mode {mode!r}")
        self._control = control
        self._spec = spec
        self._worker_id = worker_id
        self._slots = list(slots)
        self._keeper = keeper
        self.mode = mode
        self.fired = False
        self.abort = threading.Event()  # thread-runner clients watch this
        self._halt = threading.Event()  # stops the watcher without aborting
        self._reaper: Callable[[], None] | None = None
        self._thread: threading.Thread | None = None

    def set_reaper(self, fn: Callable[[], None]) -> None:
        """Runner hook that SIGKILLs/aborts this worker's node children when
        the switch fires — a dead worker takes its children with it."""
        self._reaper = fn

    def start(self) -> None:
        if (self._spec.chaos.kill_workers < 1 or self.mode == "off"
                or not self._slots):
            return
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"kill-switch-{self._worker_id}")
        self._thread.start()

    def _run(self) -> None:
        spec, chaos = self._spec, self._spec.chaos
        deadline = time.monotonic() + default_worker_timeout(spec)
        while not self._halt.is_set():
            if len(read_lease_index(self._control)) >= spec.num_nodes:
                break
            if time.monotonic() >= deadline:
                return  # fleet never fully claimed: worker-kill chaos forfeits
            time.sleep(0.05)
        if self._worker_id not in worker_kill_victims(self._control, chaos):
            return
        r = _node_rng(chaos.seed, f"worker:{self._worker_id}")
        lo, hi = chaos.kill_workers_after
        threshold = max(1, min(int(r.integers(min(lo, hi), max(lo, hi) + 1)),
                               spec.rounds - 1))
        nids = [spec.node_id(s) for s in self._slots]
        while not self._halt.is_set() and time.monotonic() < deadline:
            for nid in nids:
                hb = _read_fleet_blob(
                    self._control, f"{_HEARTBEAT_PREFIX}{nid}")
                if hb is not None and int(hb.get("pushes", 0)) >= threshold:
                    self.fire()
                    return
            time.sleep(0.05)

    def fire(self) -> None:
        _log.warning("worker %s: worker-kill chaos firing (%s mode)",
                     self._worker_id, self.mode)
        self.fired = True
        self._halt.set()
        self._keeper.stop()  # death means silence: leases must lapse
        self.abort.set()
        reaper = self._reaper
        if reaper is not None:
            try:
                reaper()
            except Exception:
                _log.debug("worker %s: reaper failed", self._worker_id,
                           exc_info=True)
        if self.mode == "sigkill":
            os.kill(os.getpid(), signal.SIGKILL)

    def stop(self) -> None:
        self._halt.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)


# --------------------------------------------------------------------------
# The soak client (module-level: spawn must pickle it)
# --------------------------------------------------------------------------


class _SimulatedCrash(RuntimeError):
    """Thread-runner stand-in for a SIGKILL: the client dies mid-round
    without depositing a result; the worker restarts it with resume."""


class _WorkerAborted(RuntimeError):
    """Thread-runner stand-in for whole-worker death: the client aborts
    mid-round with no result and is NOT restarted by its own worker — a
    surviving worker must adopt the stranded slot."""


def _soak_client(spec_dict: dict, slot: int, *, park_after_pushes: int | None = None,
                 stall_after: int | None = None, stall_duration: float = 0.0,
                 crash_mode: str = "sigkill", adopted_epoch: int = 0,
                 abort_event: "threading.Event | None" = None,
                 device: "str | torch.device" = "cuda") -> dict:
    """One fleet node: quadratic consensus training federated through the
    spec's store. Pushes a heartbeat every federation step (via the node's
    ``on_step`` hook), deposits its result blob itself on completion — the
    worker never relays data — and, as a chaos victim, parks mid-round after
    ``park_after_pushes`` pushes so the SIGKILL lands deterministically.

    A nonzero ``adopted_epoch`` means this run is a surviving worker resuming
    a slot stranded by worker death: the node stamps the lease epoch into its
    wire updates (FedAsync's epoch-gap discount reads it back) and counts
    the adoption in telemetry. ``abort_event`` (thread runner only) is the
    worker-kill switch: when set, the client dies mid-round exactly as its
    host would.

    The model ``w`` is an f32 tensor on ``device`` and the strategy
    aggregates there: on the card every aggregate is one ``fed_agg`` or
    ``fed_opt`` launch. Asking for the card without one raises."""
    dev = resolve_device(device)
    spec = FleetSpec.from_dict(spec_dict)
    node_id = spec.node_id(slot)
    control = control_folder(spec.store_uri)
    data = make_folder(spec.store_uri)
    t0 = time.time()
    state: dict[str, Any] = {"first_push": None}
    # Every soak node runs instrumented: the node flushes an obs/ snapshot
    # each round (flush_every=1 — soak rounds are few and blobs tiny), which
    # is what SoakReport's telemetry rollups and `repro_torch.obs` read back.
    tel = Telemetry(node_id, enabled=True, flush_every=1)
    adopted = adopted_epoch > 0
    if adopted:
        tel.count("node.adopted")
        tel.count("node.lease_epoch", adopted_epoch)

    def on_step(node, _aggregated) -> None:
        if state["first_push"] is None:
            state["first_push"] = time.time()
        # heartbeats are thin telemetry deposits: liveness plus the brief
        # rollup (round count, staleness, phase means)
        _heartbeat(control, node_id, {
            "node_id": node_id, "slot": slot, "counter": node.counter,
            "pushes": node.num_pushes, "status": "running",
            "resumed": node.resumed is not None, "time": time.time(),
            "adopted": adopted, "lease_epoch": adopted_epoch,
            "obs": tel.brief()})

    node = AsyncFederatedNode(
        strategy=get_strategy(spec.strategy, device=dev), shared_folder=data,
        node_id=node_id, transport=spec.transport, on_step=on_step,
        telemetry=tel, lease_epoch=adopted_epoch)
    resumed = node.resumed is not None
    start_counter = node.counter
    if resumed:
        w = as_tensor(node.resumed.params["w"]).to(dev, torch.float32)
    else:
        w = torch.zeros((spec.param_size,), dtype=torch.float32, device=dev)
    target = spec.target_of(slot)

    while node.counter < spec.rounds:
        if abort_event is not None and abort_event.is_set():
            raise _WorkerAborted(node_id)  # the host died under us
        w = w + 0.3 * (target - w)  # local "training"
        aggregated = node.update_parameters({"w": w}, num_examples=1 + slot % 5)
        if aggregated is not None:
            w = aggregated["w"]
        if park_after_pushes is not None and node.num_pushes >= park_after_pushes:
            _heartbeat(control, node_id, {
                "node_id": node_id, "slot": slot, "counter": node.counter,
                "pushes": node.num_pushes, "status": "parked",
                "resumed": resumed, "time": time.time()})
            if crash_mode == "raise":
                raise _SimulatedCrash(node_id)
            while True:  # mid-round: hold still until the SIGKILL lands
                time.sleep(0.05)
        if stall_after is not None and node.num_pushes == stall_after:
            time.sleep(stall_duration)  # the slow-node stall
        time.sleep(spec.round_sleep)

    result = {
        "node_id": node_id, "slot": slot, "resumed": resumed,
        "start_counter": start_counter, "final_counter": node.counter,
        "pushes": node.num_pushes, "aggregations": node.num_aggregations,
        "skipped_pulls": node.num_skipped_pulls,
        "wall_seconds": time.time() - t0,
        "first_push_unix": state["first_push"],
        "finished_unix": time.time(),
        "params_l2": float(torch.linalg.vector_norm(w)),
        "adopted": adopted, "lease_epoch": adopted_epoch,
        "transport_stats": dict(node.transport_stats()),
    }
    blob = serialize_fleet_blob("result", result)
    if adopted:
        # An adopter's deposit always stands: if the node's original runner is
        # still alive (its worker's lease lapsed spuriously — starvation, not
        # death — and we split-brained it), the churn ledger must still read
        # adopted=True for this stranded lease no matter which runner wrote.
        control.put(f"{_RESULT_PREFIX}{node_id}", blob)
    elif not control.put_if_absent(f"{_RESULT_PREFIX}{node_id}", blob):
        # Epoch-0 deposit racing an adopter that already wrote: never clobber
        # it — this runner lost its lease, the adopter owns the record.
        _log.info("%s: result already deposited by an adopter; keeping theirs",
                  node_id)
    _heartbeat(control, node_id, {
        "node_id": node_id, "slot": slot, "counter": node.counter,
        "pushes": node.num_pushes, "status": "done", "resumed": resumed,
        "adopted": adopted, "lease_epoch": adopted_epoch,
        "time": time.time()})
    return result


# --------------------------------------------------------------------------
# Workers
# --------------------------------------------------------------------------


@dataclass
class WorkerReport:
    worker_id: str
    slots: list[int]
    crashes_injected: int = 0
    restarts: int = 0
    fleet_state_hash: str | None = None
    all_results_seen: bool = False
    wall_seconds: float = 0.0
    recoveries: dict = field(default_factory=dict)  # node -> SIGKILL→first-push s
    results: dict = field(default_factory=dict)     # node -> result payload
    adoptions: dict = field(default_factory=dict)   # node -> lease-lapse→adopt s
    killed: bool = False                            # worker-kill chaos fired here


def default_worker_timeout(spec: FleetSpec) -> float:
    """Generous bound on one worker's run phase: startup + rounds + chaos."""
    per_round = spec.round_sleep + 1.0
    chaos = spec.chaos.kill_grace + spec.chaos.restart_after if spec.chaos.kills else 0.0
    churn = spec.lease_ttl * 4 if spec.chaos.kill_workers else 0.0
    return (120.0 + spec.rounds * per_round + chaos + churn
            + spec.chaos.stalls * spec.chaos.stall_duration)


def fleet_state_hash(spec_or_uri: "FleetSpec | str") -> str:
    """The fleet-wide data-plane state hash every worker must agree on after
    quiescence. Built over the spec's store URI, so flat and sharded fleets
    hash exactly what their nodes federate through (fleet/ and state/ control
    blobs excluded)."""
    uri = spec_or_uri.store_uri if isinstance(spec_or_uri, FleetSpec) else spec_or_uri
    from repro_torch.api import connect

    return connect(uri).state_hash()


def wait_all_results(control: SharedFolder, spec: FleetSpec, *,
                     timeout: float, poll: float = 0.25) -> bool:
    """Block until every fleet node's result blob is present (global
    quiescence) or ``timeout`` passes; True on full coverage."""
    want = {f"{_RESULT_PREFIX}{nid}" for nid in spec.node_ids()}
    deadline = time.monotonic() + timeout
    while True:
        have = {k for k in control.keys() if k.startswith(_RESULT_PREFIX)}
        if want <= have:
            return True
        if time.monotonic() >= deadline:
            return False
        time.sleep(poll)


def run_worker(store_uri: str | None = None, *, spec: FleetSpec | None = None,
               worker_id: str | None = None, max_slots: int | None = None,
               timeout: float | None = None, spec_timeout: float = 60.0,
               control: SharedFolder | None = None,
               worker_kill_mode: str = "simulate",
               device: "str | torch.device" = "cuda",
               claimed: threading.Event | None = None) -> WorkerReport:
    """One host's whole contribution to the soak: read the spec, claim slot
    leases, run + chaos the claimed nodes (keeping the leases fresh and
    adopting any slots stranded by a dead worker), wait for fleet-wide
    quiescence, compute the fleet state hash independently, deposit the
    worker report. Run this once per host (``python -m repro_torch.fleet
    worker``); no invocation is special — the fleet has no parent.

    ``worker_kill_mode`` controls how worker-kill chaos lands on a drawn
    victim: ``"sigkill"`` (the CLI — this worker is its own OS process)
    really SIGKILLs; ``"simulate"`` (in-process workers) aborts the clients
    and returns early without a report; ``"off"`` makes this worker immune.

    ``device`` is where this worker's nodes train and aggregate (default the
    card; ``"cpu"`` when asked). It is this host's choice, not the spec's.
    ``claimed``, when given, is set once this worker's leases are claimed
    (or the claim raised)."""
    if control is None:
        if store_uri is None:
            if spec is None:
                raise ValueError("need store_uri, spec, or control")
            store_uri = spec.store_uri
        control = control_folder(store_uri)
    if spec is None:
        spec = read_spec(control, timeout=spec_timeout)
    worker_id = worker_id or f"worker-{uuid.uuid4().hex[:8]}"
    device = str(resolve_device(device))  # fail here, not in every node
    if timeout is None:
        timeout = default_worker_timeout(spec)
    t0 = time.time()
    try:
        claims = claim_leases(control, spec, worker_id, max_slots=max_slots)
    finally:
        if claimed is not None:
            claimed.set()
    slots = sorted(claims)
    _log.info("worker %s: claimed slots %s of fleet %r (%s runner)",
              worker_id, slots, spec.name, spec.runner)
    keeper = _LeaseKeeper(control, spec, worker_id)
    for slot, epoch in claims.items():
        keeper.add(spec.node_id(slot), slot, epoch)
    keeper.start()
    switch = _KillSwitch(control, spec, worker_id, slots, keeper,
                         mode=worker_kill_mode)
    switch.start()
    try:
        schedule = chaos_schedule(spec)
        runner = (_run_slots_threaded if spec.runner == "thread"
                  else _run_slots_processes)
        report = runner(control, spec, worker_id, claims, schedule, timeout,
                        keeper=keeper, switch=switch, device=device)
    finally:
        switch.stop()
    if switch.fired:
        # This worker is "dead": no results wait, no hash, no worker blob —
        # its silence (and lapsing leases) IS the signal survivors act on.
        report.killed = True
        report.wall_seconds = time.time() - t0
        return report
    # Global quiescence, then the fleet-wide hash every worker must agree on.
    report.all_results_seen = wait_all_results(control, spec, timeout=spec.result_timeout)
    if not report.all_results_seen:
        _log.warning("worker %s: quiescence timeout — not every node deposited "
                     "a result within %.0fs", worker_id, spec.result_timeout)
    time.sleep(spec.settle)
    report.fleet_state_hash = fleet_state_hash(spec)
    report.wall_seconds = time.time() - t0
    keeper.stop()
    control.put(f"{_WORKER_PREFIX}{worker_id}", serialize_fleet_blob("worker", {
        "worker": worker_id, "slots": list(report.slots),
        "crashes_injected": report.crashes_injected,
        "restarts": report.restarts,
        "fleet_state_hash": report.fleet_state_hash,
        "all_results_seen": report.all_results_seen,
        "wall_seconds": report.wall_seconds,
        "recoveries": dict(report.recoveries),
        "adoptions": dict(report.adoptions),
        "time": time.time()}))
    return report


def _chaos_kwargs(events: list[ChaosEvent]) -> dict:
    kwargs: dict[str, Any] = {}
    for ev in events:
        if ev.kind == "kill":
            kwargs["park_after_pushes"] = ev.after_pushes
        elif ev.kind == "stall":
            kwargs["stall_after"] = ev.after_pushes
            kwargs["stall_duration"] = ev.duration
    return kwargs


def _stray_leases(control: SharedFolder, spec: FleetSpec,
                  keeper: _LeaseKeeper) -> list[tuple[str, int, int, float]]:
    """Slots stranded by a dead worker, as seen from this worker: the lease
    is not ours, not fresh, and the node has no result blob yet. Returns
    ``(node_id, slot, lapsed_epoch, lapsed_deadline)`` per stray."""
    out: list[tuple[str, int, int, float]] = []
    for nid, (epoch, payload) in read_lease_index(control).items():
        if payload is None or keeper.owns(nid) or lease_fresh(payload):
            continue
        if control.get(f"{_RESULT_PREFIX}{nid}") is not None:
            continue  # finished before its worker died: nothing to adopt
        try:
            slot = int(payload["slot"])
        except (KeyError, TypeError, ValueError):
            continue
        if not 0 <= slot < spec.num_nodes or spec.node_id(slot) != nid:
            continue
        out.append((nid, slot, epoch, float(payload.get("deadline", 0.0))))
    return out


def _run_slots_processes(control: SharedFolder, spec: FleetSpec, worker_id: str,
                         claims: dict[int, int],
                         schedule: dict[str, list[ChaosEvent]],
                         timeout: float, *, keeper: _LeaseKeeper,
                         switch: _KillSwitch, device: str) -> WorkerReport:
    """Run the claimed slots as real OS processes under a ProcessSupervisor,
    injecting this worker's share of the chaos schedule: SIGKILL a victim the
    moment its parked heartbeat lands (backstop timer otherwise), respawn it
    after the scheduled delay — the respawn must resume, not restart. Between
    polls the worker sweeps for leases stranded by a *dead worker* and adopts
    them: CAS the next lease epoch, then spawn the node here with resume."""
    slots = sorted(claims)
    report = WorkerReport(worker_id, list(slots))
    sup = ProcessSupervisor()
    spec_dict = spec.to_dict()
    slot_of = {spec.node_id(s): s for s in slots}
    # A dead worker takes its children with it: when the kill switch fires it
    # SIGKILLs every supervised node first, then this process. Otherwise the
    # orphaned children would finish and deposit results, and the stranded
    # slots the survivors must adopt would never exist.
    switch.set_reaper(lambda: [_safe_kill(sup, n) for n in list(slot_of)])
    kill_events: dict[str, ChaosEvent] = {}
    killed_at: dict[str, float] = {}
    adopt_at: dict[str, float] = {}
    restart_due: dict[str, float] = {}
    adopt_every = max(0.5, spec.lease_ttl / 2)
    next_adopt_scan = time.monotonic() + adopt_every
    results_deadline: float | None = None
    want_results = spec.chaos.kill_workers > 0
    try:
        for slot in slots:
            nid = spec.node_id(slot)
            events = schedule.get(nid, [])
            sup.spawn(nid, _soak_client, (spec_dict, slot),
                      {**_chaos_kwargs(events), "device": device})
            kill = next((e for e in events if e.kind == "kill"), None)
            if kill is not None:
                kill_events[nid] = kill
                # backstop: if the parked heartbeat never shows (crashed some
                # other way, wedged before parking), SIGKILL anyway
                sup.schedule_kill(nid, spec.chaos.kill_grace)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if switch.fired:
                return report  # this worker is dead; the reaper ran already
            for nid in list(kill_events):
                if control.get(f"{_RESULT_PREFIX}{nid}") is not None:
                    # Clean finish before the chaos landed (e.g. resumed past
                    # its rounds): disarm the backstop — a spurious SIGKILL
                    # after the result blob would count a crash that never
                    # happened and restart a node that already finished.
                    kill_events.pop(nid)
                    sup.cancel_scheduled_kills(nid)
                    _log.info("worker %s: %s finished before chaos; backstop "
                              "disarmed", worker_id, nid)
                    continue
                hb = _read_fleet_blob(control, f"{_HEARTBEAT_PREFIX}{nid}")
                if hb is not None and hb.get("status") == "parked":
                    sup.kill(nid)  # mid-round, deterministically
            for nid in sup.poll():
                kill = kill_events.pop(nid, None)
                if kill is None:
                    continue
                if control.get(f"{_RESULT_PREFIX}{nid}") is not None:
                    # Settled *cleanly* between the last scan and the backstop
                    # firing — that's a finish, not a crash.
                    sup.cancel_scheduled_kills(nid)
                    _log.info("worker %s: %s settled cleanly; not a crash",
                              worker_id, nid)
                    continue
                _log.info("worker %s: chaos SIGKILL landed on %s",
                          worker_id, nid)
                killed_at[nid] = time.time()
                report.crashes_injected += 1
                restart_due[nid] = time.monotonic() + kill.restart_after
            now = time.monotonic()
            for nid, due in list(restart_due.items()):
                if now >= due:
                    del restart_due[nid]
                    # restart WITHOUT the park: the reborn node must resume
                    # from its own deposits and run to completion
                    _log.info("worker %s: restarting %s (must resume)",
                              worker_id, nid)
                    sup.spawn(nid, _soak_client, (spec_dict, slot_of[nid]),
                              {"device": device})
                    report.restarts += 1
            if spec.chaos.kill_workers and now >= next_adopt_scan:
                next_adopt_scan = now + adopt_every
                for nid, slot, epoch, lapsed in _stray_leases(control, spec, keeper):
                    if not try_adopt(control, spec, worker_id, nid, slot,
                                     epoch + 1):
                        continue  # another survivor won the CAS
                    keeper.add(nid, slot, epoch + 1)
                    slot_of[nid] = slot
                    report.adoptions[nid] = max(0.0, time.time() - lapsed)
                    adopt_at[nid] = time.time()
                    sup.spawn(nid, _soak_client, (spec_dict, slot),
                              {"adopted_epoch": epoch + 1, "device": device})
            own_done = not sup.unsettled() and not restart_due
            if own_done:
                if not want_results:
                    break
                # Churn soaks linger briefly after their own slots finish so
                # a lease stranded by a late worker death still gets adopted.
                if results_deadline is None:
                    results_deadline = time.monotonic() + spec.result_timeout
                have = {k[len(_RESULT_PREFIX):] for k in control.keys()
                        if k.startswith(_RESULT_PREFIX)}
                if set(spec.node_ids()) <= have or time.monotonic() >= results_deadline:
                    break
            else:
                results_deadline = None
            time.sleep(0.05)
        sup.join(max(0.0, deadline - time.monotonic()))
    finally:
        sup.shutdown()
    for nid in slot_of:
        res = sup.result(nid)
        if res is not None and res.error is None and isinstance(res.result, dict):
            report.results[nid] = res.result
    for nid, t_evt in {**killed_at, **adopt_at}.items():
        first_push = (report.results.get(nid) or {}).get("first_push_unix")
        if first_push:
            report.recoveries[nid] = max(0.0, first_push - t_evt)
    return report


def _safe_kill(sup: ProcessSupervisor, name: str) -> None:
    try:
        sup.kill(name)
    except Exception:
        pass  # the reaper runs during worker death; best-effort only


def _run_slots_threaded(control: SharedFolder, spec: FleetSpec, worker_id: str,
                        claims: dict[int, int],
                        schedule: dict[str, list[ChaosEvent]],
                        timeout: float, *, keeper: _LeaseKeeper,
                        switch: _KillSwitch, device: str) -> WorkerReport:
    """Thread runner for in-process soaks (the 10²-node benchmark regime,
    where an OS process per node would be interpreter-startup-bound). Chaos
    kills become mid-round exceptions that abort the client without a result
    deposit — same observable contract as a SIGKILL minus the signal — and
    the restarted client must resume exactly as in process mode. Worker-kill
    chaos becomes the switch's abort event: every client of a drawn worker
    raises mid-round and is NOT restarted here, stranding its lease for a
    surviving worker's adoption sweep."""
    slots = sorted(claims)
    report = WorkerReport(worker_id, list(slots))
    spec_dict = spec.to_dict()
    lock = threading.Lock()
    killed_at: dict[str, float] = {}
    adopt_at: dict[str, float] = {}
    threads: list[threading.Thread] = []

    def drive(slot: int, adopted_epoch: int = 0) -> None:
        nid = spec.node_id(slot)
        # Adopted slots run clean: their chaos events belonged to the dead
        # worker's incarnation, and re-parking a resumed node would deadlock.
        events = [] if adopted_epoch else schedule.get(nid, [])
        kwargs = _chaos_kwargs(events)
        kill = next((e for e in events if e.kind == "kill"), None)
        while True:
            try:
                result = _soak_client(spec_dict, slot, crash_mode="raise",
                                      adopted_epoch=adopted_epoch,
                                      abort_event=switch.abort, device=device,
                                      **kwargs)
            except _WorkerAborted:
                return  # worker death: no result, no restart — strand it
            except _SimulatedCrash:
                _log.info("worker %s: simulated crash of %s; restarting",
                          worker_id, nid)
                with lock:
                    report.crashes_injected += 1
                    killed_at[nid] = time.time()
                time.sleep(kill.restart_after if kill is not None else 0.0)
                kwargs = {}  # the restart runs clean — and must resume
                with lock:
                    report.restarts += 1
                continue
            with lock:
                report.results[nid] = result
            return

    def start_runner(slot: int, adopted_epoch: int = 0) -> None:
        t = threading.Thread(target=drive, args=(slot, adopted_epoch),
                             daemon=True, name=f"fleet-{spec.node_id(slot)}")
        threads.append(t)
        t.start()

    for slot in slots:
        start_runner(slot)
    deadline = time.monotonic() + timeout
    adopt_every = max(0.5, spec.lease_ttl / 2)
    next_adopt_scan = time.monotonic() + adopt_every
    results_deadline: float | None = None
    want_results = spec.chaos.kill_workers > 0
    while time.monotonic() < deadline:
        if switch.fired:
            return report  # dead worker: leave the runners to abort
        now = time.monotonic()
        if spec.chaos.kill_workers and now >= next_adopt_scan:
            next_adopt_scan = now + adopt_every
            for nid, slot, epoch, lapsed in _stray_leases(control, spec, keeper):
                if not try_adopt(control, spec, worker_id, nid, slot, epoch + 1):
                    continue  # another survivor won the CAS
                keeper.add(nid, slot, epoch + 1)
                with lock:
                    report.adoptions[nid] = max(0.0, time.time() - lapsed)
                adopt_at[nid] = time.time()
                start_runner(slot, adopted_epoch=epoch + 1)
        own_done = all(not t.is_alive() for t in threads)
        if own_done:
            if not want_results:
                break
            # Churn soaks linger after their own slots finish so a lease
            # stranded by a late worker death still gets adopted here.
            if results_deadline is None:
                results_deadline = time.monotonic() + spec.result_timeout
            have = {k[len(_RESULT_PREFIX):] for k in control.keys()
                    if k.startswith(_RESULT_PREFIX)}
            if set(spec.node_ids()) <= have or time.monotonic() >= results_deadline:
                break
        else:
            results_deadline = None
        time.sleep(0.05)
    for t in threads:
        t.join(timeout=0.5)
    # Recoveries are derived AFTER the joins, only for runners that delivered
    # a result — a straggler thread past the deadline can at worst add a
    # killed_at entry nobody reads, never a half-built latency.
    with lock:
        for nid, t_evt in {**killed_at, **adopt_at}.items():
            first_push = (report.results.get(nid) or {}).get("first_push_unix")
            if first_push:
                report.recoveries[nid] = max(0.0, first_push - t_evt)
    return report


# --------------------------------------------------------------------------
# Fleet-wide report (watch / any worker)
# --------------------------------------------------------------------------


@dataclass
class SoakReport:
    """Everything the soak acceptance needs, assembled purely from the shared
    folder — by ``repro_torch.fleet watch``, by any worker, by anything that can
    read the mount."""

    name: str
    num_nodes: int
    rounds: int
    claims: dict            # slot -> worker id
    results: dict           # node -> result payload
    workers: dict           # worker id -> worker payload
    victims: list           # scheduled SIGKILL victims (from the seeded schedule)
    stalled: list           # scheduled slow nodes
    resumed: dict           # node -> bool
    rounds_completed: dict  # node -> final counter
    crashes_injected: int
    restarts: int
    recovery_latency: dict  # node -> seconds (SIGKILL → restarted node's first push)
    stranded: list          # nodes whose lease epoch advanced (worker died under them)
    adopted: dict           # node -> bool (result deposited by an adopter)
    adoption_latency: dict  # node -> seconds (lease lapse → adoption CAS win)
    workers_lost: list      # founding workers that never deposited a report
    fleet_hashes: dict      # worker -> fleet state hash
    pipeline_stats: dict    # summed PipelineStats counters across all nodes
    telemetry: dict         # obs/ rollups: per-node staleness + phase latency
    total_pushes: int
    wall_seconds: float
    rounds_per_sec: float
    complete: bool          # every node deposited a result
    converged: bool         # complete AND all workers computed one hash
    recovered: bool         # every scheduled victim resumed
    passed: bool

    def to_dict(self) -> dict:
        return asdict(self)

    def summary(self) -> str:
        hashes = sorted(set(self.fleet_hashes.values()))
        lines = [
            f"fleet {self.name!r}: {len(self.results)}/{self.num_nodes} nodes "
            f"reported, {len(self.workers)} workers",
            f"  rounds/node: {self.rounds}  total pushes: {self.total_pushes}  "
            f"rounds/sec: {self.rounds_per_sec:.2f}",
            f"  crashes injected: {self.crashes_injected}  restarts: {self.restarts}  "
            f"victims resumed: {sum(bool(self.resumed.get(v)) for v in self.victims)}"
            f"/{len(self.victims)}",
            f"  fleet state hash: {hashes if len(hashes) != 1 else hashes[0]} "
            f"({'converged' if self.converged else 'NOT converged'})",
            self._telemetry_line(),
            f"  passed: {self.passed}",
        ]
        if self.recovery_latency:
            mean = sum(self.recovery_latency.values()) / len(self.recovery_latency)
            lines.insert(3, f"  recovery latency: mean {mean:.2f}s over "
                            f"{len(self.recovery_latency)} restarts")
        if self.stranded or self.workers_lost:
            n_adopted = sum(bool(self.adopted.get(n)) for n in self.stranded)
            churn = (f"  churn: workers lost {len(self.workers_lost)} "
                     f"({', '.join(self.workers_lost) or 'none'})  "
                     f"stranded nodes adopted {n_adopted}/{len(self.stranded)}")
            if self.adoption_latency:
                mean = (sum(self.adoption_latency.values())
                        / len(self.adoption_latency))
                churn += f"  adoption latency mean {mean:.2f}s"
            lines.insert(-2, churn)
        return "\n".join(lines)

    def _telemetry_line(self) -> str:
        fleet = (self.telemetry or {}).get("fleet") or {}
        if not fleet.get("nodes_reporting"):
            return "  telemetry: no obs/ blobs found"
        phases = fleet.get("phase_ms") or {}
        phase_txt = " ".join(
            f"{name} {phases[name]:.2f}ms"
            for name in ("pull", "push", "aggregate") if name in phases)
        return (
            f"  telemetry: {fleet['nodes_reporting']}/{self.num_nodes} nodes, "
            f"staleness mean {fleet.get('staleness_mean', 0.0):.2f} "
            f"p90 {fleet.get('staleness_p90_max', 0.0):.2f}, "
            f"phase means {phase_txt or 'n/a'}")


def assemble_report(control: SharedFolder, spec: FleetSpec | None = None) -> SoakReport:
    """Fold every ``fleet/`` blob in the control folder into one SoakReport.
    Read-only — safe to run concurrently with the fleet, from any host."""
    if spec is None:
        spec = read_spec(control)
    results: dict[str, dict] = {}
    workers: dict[str, dict] = {}
    claims: dict[int, str] = {}
    leases: dict[str, tuple[int, dict]] = {}  # node -> (freshest epoch, payload)
    founding: set[str] = set()
    for key in control.keys():
        if not key.startswith(FLEET_PREFIX) or key == SPEC_KEY:
            continue
        payload = _read_fleet_blob(control, key)
        if payload is None:
            continue
        if key.startswith(_RESULT_PREFIX):
            results[str(payload.get("node_id"))] = payload
        elif key.startswith(_WORKER_PREFIX):
            workers[str(payload.get("worker"))] = payload
        elif key.startswith(_CLAIM_PREFIX):
            claims[int(payload.get("slot", -1))] = str(payload.get("worker"))
        elif key.startswith(_LEASE_PREFIX):
            parsed = _parse_lease_key(key)
            if parsed is None:
                continue
            nid, epoch = parsed
            if epoch == 0 and payload.get("worker") is not None:
                founding.add(str(payload["worker"]))
            if nid not in leases or epoch > leases[nid][0]:
                leases[nid] = (epoch, payload)
    # Leases are the live claim ledger; a legacy permanent claim blob only
    # stands where no lease was ever written for its slot.
    for nid, (_epoch, payload) in leases.items():
        try:
            claims[int(payload["slot"])] = str(payload.get("worker"))
        except (KeyError, TypeError, ValueError):
            pass
    schedule = chaos_schedule(spec)
    victims = sorted(n for n, evs in schedule.items()
                     if any(e.kind == "kill" for e in evs))
    stalled = sorted(n for n, evs in schedule.items()
                     if any(e.kind == "stall" for e in evs))
    resumed = {n: bool(r.get("resumed")) for n, r in results.items()}
    rounds_completed = {n: int(r.get("final_counter", 0)) for n, r in results.items()}
    crashes = sum(int(w.get("crashes_injected", 0)) for w in workers.values())
    restarts = sum(int(w.get("restarts", 0)) for w in workers.values())
    recovery: dict[str, float] = {}
    for w in workers.values():
        for nid, latency in (w.get("recoveries") or {}).items():
            recovery[str(nid)] = float(latency)
    # Churn ledger: a lease epoch above 0 means the founding worker died under
    # that node and someone CAS-won the next epoch — the node was stranded.
    stranded = sorted(n for n, (epoch, _p) in leases.items() if epoch > 0)
    adopted = {n: bool(results[n].get("adopted")) for n in stranded
               if n in results}
    adoption_latency: dict[str, float] = {}
    for w in workers.values():
        for nid, latency in (w.get("adoptions") or {}).items():
            adoption_latency[str(nid)] = float(latency)
    workers_lost = sorted(founding - set(workers))
    hashes = {wid: str(w["fleet_state_hash"]) for wid, w in workers.items()
              if w.get("fleet_state_hash")}
    stats: dict[str, float] = {}
    for r in results.values():
        for k, v in (r.get("transport_stats") or {}).items():
            if isinstance(v, (int, float)):
                stats[k] = stats.get(k, 0) + v
    # Telemetry rollups come from the DATA plane's obs/ blobs alone — the
    # per-node staleness/latency picture survives even when a node died
    # before depositing its fleet/ result.
    try:
        telemetry = telemetry_rollups(collect_obs(spec.store_uri))
    except Exception:
        _log.debug("telemetry rollup failed for %s", spec.store_uri,
                   exc_info=True)
        telemetry = {"nodes": {}, "fleet": {"nodes_reporting": 0}}
    total_pushes = sum(int(r.get("pushes", 0)) for r in results.values())
    wall = max([float(w.get("wall_seconds", 0.0)) for w in workers.values()]
               + [float(r.get("wall_seconds", 0.0)) for r in results.values()]
               + [0.0])
    # Throughput over the *active* federation span (first push → last finish),
    # not the worker wall, which also counts quiescence waits and settle time.
    starts = [r.get("first_push_unix") for r in results.values() if r.get("first_push_unix")]
    ends = [r.get("finished_unix") for r in results.values() if r.get("finished_unix")]
    active = (max(ends) - min(starts)) if starts and ends else 0.0
    complete = set(results) >= set(spec.node_ids())
    converged = complete and len(hashes) >= 1 and len(set(hashes.values())) == 1
    recovered = all(resumed.get(v, False) for v in victims)
    # A node-kill victim orphaned by its worker's death may never eat its
    # scheduled SIGKILL — only victims that were NOT stranded owe a crash.
    crash_ok = crashes >= len([v for v in victims if v not in set(stranded)])
    adopted_ok = all(adopted.get(n, False) for n in stranded)
    churn_ok = spec.chaos.kill_workers < 1 or len(workers_lost) >= 1
    passed = (
        complete and converged and recovered and adopted_ok and churn_ok
        and crash_ok
        and all(rounds_completed.get(n, 0) >= spec.rounds for n in spec.node_ids())
    )
    return SoakReport(
        name=spec.name, num_nodes=spec.num_nodes, rounds=spec.rounds,
        claims=claims, results=results, workers=workers,
        victims=victims, stalled=stalled, resumed=resumed,
        rounds_completed=rounds_completed, crashes_injected=crashes,
        restarts=restarts, recovery_latency=recovery,
        stranded=stranded, adopted=adopted,
        adoption_latency=adoption_latency, workers_lost=workers_lost,
        fleet_hashes=hashes,
        pipeline_stats=stats, telemetry=telemetry, total_pushes=total_pushes,
        wall_seconds=wall,
        rounds_per_sec=(total_pushes / active) if active > 0 else 0.0,
        complete=complete, converged=converged, recovered=recovered,
        passed=passed)


def watch(store_uri: str, *, interval: float = 2.0, timeout: float = 600.0,
          printer: Callable[[str], None] = print) -> SoakReport:
    """Poll the control folder until the soak completes (every node reported
    AND every claiming worker deposited its fleet hash) or ``timeout``
    passes; prints one progress line per poll. Pure reader — running it adds
    nothing to the data path."""
    control = control_folder(store_uri)
    spec = read_spec(control, timeout=timeout)
    deadline = time.monotonic() + timeout
    while True:
        report = assemble_report(control, spec)
        expected_workers = set(report.claims.values())
        printer(
            f"[fleet {spec.name}] nodes {len(report.results)}/{spec.num_nodes} "
            f"workers {len(report.fleet_hashes)}/{max(1, len(expected_workers))} "
            f"crashes {report.crashes_injected} restarts {report.restarts}")
        done = report.complete and expected_workers and (
            expected_workers <= set(report.fleet_hashes))
        if done or time.monotonic() >= deadline:
            return report
        time.sleep(interval)


def run_fleet_local(spec: FleetSpec, num_workers: int = 2, *,
                    timeout: float | None = None,
                    worker_prefix: str = "local",
                    device: "str | torch.device" = "cuda") -> SoakReport:
    """Single-host convenience (and the benchmark harness): write the spec,
    run ``num_workers`` worker loops concurrently in this process — each
    claiming its share of slots exactly as separate hosts would — and
    assemble the fleet report. The multi-host flow is the same thing with
    ``repro_torch.fleet worker`` once per machine. Every worker's nodes run
    on ``device``.

    Worker ``i`` starts once worker ``i - 1`` has claimed its leases, so
    ``local<i>`` holds the slots ``[i·⌈N/W⌉, (i+1)·⌈N/W⌉)`` and a seeded
    chaos schedule lands on the same workers in every run (started together,
    the workers would split the slots by a race)."""
    if num_workers < 1:
        raise ValueError(f"num_workers must be >= 1, got {num_workers}")
    control = control_folder(spec.store_uri)
    write_spec(control, spec)
    per_worker = -(-spec.num_nodes // num_workers)  # ceil
    errors: list[BaseException] = []

    claimed = [threading.Event() for _ in range(num_workers)]

    def run(i: int) -> None:
        try:
            run_worker(spec=spec, control=control,
                       worker_id=f"{worker_prefix}{i}", max_slots=per_worker,
                       timeout=timeout, device=device, claimed=claimed[i])
        except BaseException as e:  # noqa: BLE001 - surfaced after join
            errors.append(e)
        finally:
            claimed[i].set()

    threads = [threading.Thread(target=run, args=(i,), daemon=True,
                                name=f"fleet-worker-{i}")
               for i in range(num_workers)]
    for t, done in zip(threads, claimed):
        t.start()
        done.wait()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return assemble_report(control, spec)
