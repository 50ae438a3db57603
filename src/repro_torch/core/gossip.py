"""Sharded gossip weight store — O(group) federation for 10⁴-node fleets
(the port of ``repro.core.gossip``, wire-compatible with it: a torch node and
a JAX node join one sharded fleet, elect the same groups and holders, and
write summaries of the same values for the same group state).

The flat ``WeightStore`` scans every fleet member on each ``state_hash`` /
``pull``, so the store itself becomes the bottleneck long before the ROADMAP's
"millions of users": per-step cost is O(fleet). This module partitions the
fleet into *node groups*, each owning its own ``SharedFolder`` (any existing
backend — memory, disk, s3, cache-wrapped), so a node's per-step ``push`` /
``state_hash`` / ``pull`` touch only its home group's folder: O(group).

Cross-group information flows by gossip instead of scanning:

* Every push refreshes the pushing node's *group summary* — the
  example-weighted mean of the group's latest params, carrying the total
  ``num_examples`` behind it and a version vector (node → counter). The
  summary is deposited under a versioned key
  ``summary/<origin>/<version>-<content hash>`` in the group's own folder;
  the zero-padded version scalar (sum of counters + 1) makes freshness
  comparable from a key listing alone — no blob reads — and the hash makes
  version-scalar ties between racing writers resolve deterministically.

* Groups form a ring. After pushing, a node *forwards* every summary its home
  folder holds (its own group's and any it previously received) to the next
  ``gossip_fanout`` **populated** groups on the ring, skipping-but-seeding
  empty groups so holes in a hash-assigned fleet never partition the ring.
  A forward is a cheap key-listing comparison plus a blob copy only when the
  target's copy is missing or older — steady state writes nothing.

* ``pull`` returns the home group's real peer updates plus a bounded sample
  of foreign-group summaries as pseudo-peers (node id ``group:<origin>``,
  weighted by the group's total example count), so the existing client-side
  strategies fold remote groups into aggregation unchanged.

An update therefore propagates fleet-wide within at most one populated-group
hop per gossip round: every group hears about it within ``num_groups`` rounds
(the ring diameter), a bound the reference's property tests prove under
adversarial push orderings.

**Hierarchical tiers** (``shard<G>x<L>+<uri>``): one flat ring still makes
every group index every other group's summary — O(num_groups) per pull. With
``L > 1`` the groups form a *summary tree* instead (``GossipHierarchy``):
level-0 rings are confined to segments of ``branching ≈ G**(1/L)`` groups;
each segment deterministically elects (stable hash — no coordinator, no
messages) an *aggregator* group whose folder collects the segment's summaries
and holds their fold — one level-1 ``SuperSummary`` blob under
``summary1/<origin>/…`` — forwarded on a shorter ring of aggregators,
recursively, until the top tier is a single ring. Any segment member's push
performs the aggregator duties by writing into the elected folder, so the
election never needs the aggregator group to have live members. A push then
touches O(branching · levels) = O(G**(1/L) · L) folders and a pull indexes one
summary chain — own segment at level 0 plus one sibling set per tier — instead
of N/G summaries; the per-tier sibling sets partition the fleet, so nothing is
double-counted. Information crosses the fleet within ``levels ×
per-ring-diameter`` pushes (property-tested at ≥2 levels).

Consistency model: the summary layer is eventually consistent. Two same-group
writers racing a refresh can leave one contribution out of the summary until
either pushes again (last-writer-wins per version scalar); real ``latest/``
deposits are never involved in the race, so within-group federation stays
exactly as strong as the flat store.

``ShardedWeightStore`` presents the ``WeightStore`` interface, so
``AsyncFederatedNode`` / ``SyncFederatedNode`` work unchanged on top;
``make_folder("shard<G>+<uri>")`` routes URIs here (see ``ShardedFolders``).
"""
from __future__ import annotations

import hashlib
import math
import threading
import time
from typing import Callable, Iterable, Mapping, Sequence

import numpy as np

from .serialize import (
    FlatDecodeUnsupported,
    FlatUpdate,
    GroupSummary,
    NodeUpdate,
    SuperSummary,
    content_hash,
    decode_params_flat,
    deserialize_fleet_blob,
    deserialize_group_summary,
    deserialize_super_summary,
    serialize_fleet_blob,
)
from .store import SharedFolder, WeightStore
from .telemetry import child_span
from .transport import TransportPipeline, _LruCache
from .tree import tree_weighted_mean
from repro_torch.logs import get_logger

_log = get_logger("gossip")

_SUMMARY_PREFIX = "summary/"
GROUP_PEER_PREFIX = "group:"  # node_id prefix of summary pseudo-peers in pull()


def _summary_prefix(level: int) -> str:
    """Key prefix of one summary tier: level 0 keeps the flat-ring layout
    (``summary/``) so single-tier stores are the L=1 degenerate case on disk
    too; tiers deposit under ``summary<level>/``."""
    return _SUMMARY_PREFIX if level == 0 else f"summary{level}/"


def group_peer_id(origin: int, level: int = 0) -> str:
    """Pseudo-peer node id a (super-)summary decodes to: ``group:<origin>``
    at level 0 (unchanged from the flat ring), ``group:L<level>.<origin>``
    for tiers."""
    if level == 0:
        return f"{GROUP_PEER_PREFIX}{origin}"
    return f"{GROUP_PEER_PREFIX}L{level}.{origin}"

# one grammar owns all routing: the shard-wrapper syntax is defined once, in
# transport.py, next to the rest of the folder-URI/pipeline grammar
from .transport import _SHARD_RE as SHARD_URI_RE  # noqa: E402


# --------------------------------------------------------------------------
# Group assignment
# --------------------------------------------------------------------------


def default_group_of(node_id: str, num_groups: int) -> int:
    """Stable hash assignment: the same node id maps to the same group on any
    machine, any process, any fleet composition — a node can compute its home
    group knowing nothing but its own id."""
    if num_groups < 1:
        raise ValueError(f"num_groups must be >= 1, got {num_groups}")
    h = int.from_bytes(hashlib.sha256(node_id.encode()).digest()[:8], "big")
    return h % num_groups


def balanced_groups(node_ids: Iterable[str], num_groups: int) -> dict[str, int]:
    """Explicit balanced assignment for a *known* fleet: deterministic in the
    node **set** (any iteration order), group sizes differ by at most one, so
    no group is empty once ``len(node_ids) >= num_groups``. Use as the
    ``group_of`` override when the fleet roster is known up front; the default
    hash assignment needs no roster but only balances in expectation."""
    if num_groups < 1:
        raise ValueError(f"num_groups must be >= 1, got {num_groups}")
    ordered = sorted(set(node_ids), key=lambda n: (hashlib.sha256(n.encode()).hexdigest(), n))
    return {n: i % num_groups for i, n in enumerate(ordered)}


# --------------------------------------------------------------------------
# Roster blobs — epoch-versioned fleet membership, in the store itself
# --------------------------------------------------------------------------
#
# Elastic fleets change composition mid-soak: workers die, their nodes get
# adopted, new workers join. The membership truth lives where everything else
# does — as blobs. ``fleet/roster/<epoch>`` holds the sorted node set at that
# epoch; epochs are write-once (``put_if_absent``), so concurrent publishers
# race on the *next* key and exactly one wins (same CAS-by-key discipline as
# slot leases). Readers take the highest epoch present. The ``fleet/`` prefix
# keeps rosters out of every state hash, like all launcher control traffic.

ROSTER_PREFIX = "fleet/roster/"


def _roster_key(epoch: int) -> str:
    return f"{ROSTER_PREFIX}{epoch:06d}"


def read_roster(folder: SharedFolder) -> tuple[int, list[str]] | None:
    """Freshest roster in ``folder`` -> (epoch, sorted node ids), or None."""
    best = -1
    for key in folder.keys():
        if key.startswith(ROSTER_PREFIX):
            tail = key[len(ROSTER_PREFIX):]
            if tail.isdigit():
                best = max(best, int(tail))
    # walk downward: the freshest key could lose a race with a concurrent
    # delete/GC, and an older epoch is a valid (just stale) answer
    while best >= 0:
        blob = folder.get(_roster_key(best))
        if blob is not None:
            try:
                kind, payload = deserialize_fleet_blob(blob)
                if kind == "roster":
                    return int(payload.get("epoch", best)), [
                        str(n) for n in payload.get("nodes", [])]
            except (ValueError, KeyError):
                pass
        best -= 1
    return None


def write_roster(folder: SharedFolder, node_ids: Iterable[str], *,
                 retries: int = 8) -> int:
    """Publish ``node_ids`` as the current roster; returns the epoch it lives
    at. No-op (returns the current epoch) when the membership set is unchanged;
    otherwise CAS-bumps to the next epoch, retrying through concurrent
    publishers until one epoch holds this exact set."""
    nodes = sorted(set(str(n) for n in node_ids))
    for _ in range(retries):
        cur = read_roster(folder)
        if cur is not None and cur[1] == nodes:
            return cur[0]
        epoch = 0 if cur is None else cur[0] + 1
        blob = serialize_fleet_blob(
            "roster", {"epoch": epoch, "nodes": nodes, "time": time.time()})
        if folder.put_if_absent(_roster_key(epoch), blob):
            return epoch
    raise RuntimeError(
        f"roster write lost {retries} consecutive epoch races; giving up")


# --------------------------------------------------------------------------
# Hierarchical topology — a pure function of (num_groups, levels)
# --------------------------------------------------------------------------


def _elect(level: int, origin: int, size: int) -> int:
    """Stable-hash aggregator election: which of the ``size`` children of
    (level, origin) carries the segment's super-summary. Every participant
    computes the same answer from the tuple alone — no coordinator, no
    messages, no dependence on who is alive."""
    h = int.from_bytes(
        hashlib.sha256(f"agg:{level}:{origin}".encode()).digest()[:8], "big")
    return h % size


class GossipHierarchy:
    """Static summary-tree topology over ``num_groups`` level-0 groups.

    Everything here is arithmetic on origin indices — deterministic in
    (num_groups, levels), so every node (and every fresh store instance)
    derives the identical tree with zero communication. Level-t *origins*
    (0..counts[t]) name summary blobs: a level-0 origin is a group, a level-t
    origin is one segment of level-(t-1) origins, folded into a single
    ``SuperSummary`` held in the folder of its hash-elected aggregator group
    (``holder``). Rings at every non-top level are confined to one parent
    segment; the top level is a single global ring. ``levels=1`` degenerates
    exactly to the flat ring (one level-0 ring over all groups, no tiers).
    """

    def __init__(self, num_groups: int, levels: int = 1):
        if num_groups < 1:
            raise ValueError(f"num_groups must be >= 1, got {num_groups}")
        if levels < 1:
            raise ValueError(f"levels must be >= 1, got {levels}")
        self.num_groups = num_groups
        self.levels = levels
        # L-th root of G: every tier's rings end up comparably sized, which is
        # what makes the per-push folder count O(G**(1/L) * L) = O(log G)
        self.branching = (
            max(2, math.ceil(num_groups ** (1.0 / levels))) if levels > 1
            else num_groups
        )
        counts = [num_groups]
        for _ in range(1, levels):
            counts.append(max(1, math.ceil(counts[-1] / self.branching)))
        self.counts = counts  # counts[t] = number of level-t origins
        self._holders: dict[tuple[int, int], int] = {}
        self._scopes: dict[int, dict[int, frozenset[int]]] = {}

    def children(self, level: int, origin: int) -> range:
        """Level-(level-1) origins folded into (level, origin)."""
        s = self.branching
        lo = origin * s
        return range(lo, min(lo + s, self.counts[level - 1]))

    def holder(self, level: int, origin: int) -> int:
        """The group whose folder holds (level, origin)'s summary blob. Level
        0: the group itself. Tiers: the elected child's holder, recursively —
        distinct origins at one level have disjoint subtrees, so their holders
        never collide."""
        if level == 0:
            return origin
        key = (level, origin)
        g = self._holders.get(key)
        if g is None:
            kids = self.children(level, origin)
            g = self.holder(level - 1, kids[_elect(level, origin, len(kids))])
            self._holders[key] = g
        return g

    def path(self, group: int) -> list[int]:
        """``group``'s ancestor origin at each level: path[0] is the group,
        path[t] the level-t segment covering it (contiguous chunking makes
        this a plain integer division)."""
        p = [group]
        for _ in range(1, self.levels):
            p.append(p[-1] // self.branching)
        return p

    def ring(self, level: int, origin: int) -> range:
        """Origins of the level-``level`` ring containing ``origin``: the
        sibling chunk under one parent, except the top level — one global
        ring (its origins have no parent to confine them)."""
        if level >= self.levels - 1:
            return range(self.counts[level])
        s = self.branching
        lo = (origin // s) * s
        return range(lo, min(lo + s, self.counts[level]))

    def scope(self, group: int) -> dict[int, frozenset[int]]:
        """Pull admissibility: level -> origins whose (super-)summaries
        ``group``'s pulls fold in as pseudo-peers. Level 0 covers the own
        segment's other groups; each tier covers exactly the leaf groups no
        lower level reaches (the own-path origin is excluded at every level —
        it covers the puller itself). The per-level sets therefore partition
        the foreign fleet: nothing is double-counted."""
        sc = self._scopes.get(group)
        if sc is None:
            p = self.path(group)
            sc = {
                t: frozenset(o for o in self.ring(t, p[t]) if o != p[t])
                for t in range(self.levels)
            }
            self._scopes[group] = sc
        return sc

    def diameter(self) -> int:
        """Worst-case push count for information to cross the fleet:
        ``levels × max per-ring diameter`` (the property-tested bound)."""
        per_ring = max(
            len(self.ring(t, 0)) for t in range(self.levels)
        )
        return self.levels * per_ring

    def __repr__(self) -> str:
        return (f"GossipHierarchy(num_groups={self.num_groups}, "
                f"levels={self.levels}, branching={self.branching}, "
                f"counts={self.counts})")


# --------------------------------------------------------------------------
# Per-group folder routing
# --------------------------------------------------------------------------


def _append_group(uri: str, group: int) -> str:
    """Derive group ``group``'s folder URI from the base URI, preserving any
    ``cache+``/``retry+`` wrapping ('shard4+cache+/mnt/x' caches each group
    folder; 'shard4+retry+/mnt/x' retries each group folder's I/O)."""
    if uri.startswith("cache+"):
        return "cache+" + _append_group(uri[len("cache+"):], group)
    if uri.startswith("retry+"):
        return "retry+" + _append_group(uri[len("retry+"):], group)
    if uri == "memory://":
        # anonymous memory:// mints a fresh in-process folder per make_folder
        # call; ShardedFolders caches one instance per group, which is the
        # identity that matters. Named memory://<name> URIs fall through to
        # the path-suffix branch so each group shares one registry entry.
        return "memory://"
    return uri.rstrip("/") + f"/group{group:04d}"


class ShardedFolders:
    """Handle to a family of per-group folders (lazily created, cached).

    Built from a base URI (``make_folder("shard<G>+<uri>")`` returns one) or
    an explicit ``factory``. Not itself a ``SharedFolder`` — it is the routing
    table a ``ShardedWeightStore`` shards over, and ``_BaseNode`` accepts it
    wherever ``shared_folder=`` is taken.
    """

    def __init__(
        self,
        num_groups: int,
        uri: str | None = None,
        *,
        levels: int = 1,
        factory: Callable[[int], SharedFolder] | None = None,
    ):
        if num_groups < 1:
            raise ValueError(f"num_groups must be >= 1, got {num_groups}")
        if levels < 1:
            raise ValueError(f"levels must be >= 1, got {levels}")
        if (uri is None) == (factory is None):
            raise ValueError("pass exactly one of uri= or factory=")
        self.num_groups = num_groups
        self.levels = levels  # summary tiers the store gossips over (1 = flat ring)
        self.uri = uri
        self._factory = factory
        self._folders: dict[int, SharedFolder] = {}
        self._lock = threading.Lock()

    @classmethod
    def from_uri(cls, uri: str) -> "ShardedFolders":
        m = SHARD_URI_RE.match(uri)
        if not m:
            raise ValueError(
                f"not a shard URI: {uri!r} (expected 'shard<G>[x<L>]+<uri>')")
        levels = int(m.group(2)) if m.group(2) is not None else 1
        if levels < 1:
            raise ValueError(f"shard<G>x<L>+ needs L >= 1, got {uri!r}")
        return cls(int(m.group(1)), m.group(3), levels=levels)

    def group_uri(self, group: int) -> str | None:
        if self.uri is None:
            return None
        return _append_group(self.uri, group)

    def group_folder(self, group: int) -> SharedFolder:
        if not 0 <= group < self.num_groups:
            raise ValueError(f"group {group} out of range [0, {self.num_groups})")
        with self._lock:
            folder = self._folders.get(group)
            if folder is None:
                if self._factory is not None:
                    folder = self._factory(group)
                else:
                    from .store import make_folder  # lazy: store routes shard URIs here

                    folder = make_folder(self.group_uri(group))
                self._folders[group] = folder
            return folder

    @classmethod
    def from_folders(cls, folders: Sequence[SharedFolder], *,
                     levels: int = 1) -> "ShardedFolders":
        folders = list(folders)
        return cls(len(folders), levels=levels, factory=lambda g: folders[g])

    def __len__(self) -> int:
        return self.num_groups

    def __repr__(self) -> str:
        src = self.uri if self.uri is not None else "<factory>"
        return (f"ShardedFolders(num_groups={self.num_groups}, "
                f"levels={self.levels}, uri={src!r})")


# --------------------------------------------------------------------------
# The sharded store
# --------------------------------------------------------------------------


def _summary_key(origin: int, version: int, blob_hash: str, *,
                 level: int = 0) -> str:
    """``summary[<level>]/<origin>/<version>-<hash>``: the zero-padded version
    makes freshness a plain string comparison from a key listing, and the
    content hash makes the key name its exact bytes — two racing refreshes
    that land on the same version scalar produce *distinct* keys, every folder
    picks the same (lexically largest) winner, and decoded-summary caches
    keyed on the key can never alias different params."""
    return f"{_summary_prefix(level)}{origin:04d}/{version:012d}-{blob_hash}"


def _parse_summary_key(key: str) -> tuple[int, str, str] | None:
    """-> (level, zero-padded origin string, 'version-hash'). Origin and
    version stay strings on the scan path — zero-padding makes lexical order
    numeric, and skipping int conversions matters when a pull re-indexes every
    summary key; the composite version orders by scalar first, content hash as
    the deterministic tie-break."""
    if not key.startswith("summary"):
        return None
    tier, _, tail = key[len("summary"):].partition("/")
    if tier == "":
        level = 0  # flat 'summary/' prefix — the level-0 layout
    elif tier.isdigit():
        level = int(tier)
    else:
        return None
    origin, _, version = tail.partition("/")
    if not (origin.isdigit() and version):
        return None
    return level, origin, version


def _version_scalar(composite: str) -> int:
    return int(composite.partition("-")[0])


class ShardedWeightStore:
    """``WeightStore``-compatible facade over per-group stores + gossip.

    ``folders`` is a ``ShardedFolders`` handle, a ``shard<G>+<uri>`` string,
    or an explicit sequence of ``SharedFolder`` (one per group).

    ``group_of`` overrides the stable-hash assignment: a mapping
    (node → group, e.g. from ``balanced_groups``) or a callable
    ``node_id -> group``; unmapped nodes fall back to the hash.

    ``gossip_fanout`` is how many *populated* downstream ring neighbors each
    push forwards summaries to; ``summary_sample`` bounds how many foreign
    summaries one ``pull`` folds in (rotating deterministically through all
    origins across successive pulls, so every group is eventually sampled).

    Operations that identify the acting node (``push`` via ``update.node_id``,
    ``state_hash(exclude_node=...)``, ``pull(exclude=...)``,
    ``pull_round(..., exclude=...)``) route to that node's home group and stay
    O(group). Fleet-wide calls with no node context (``node_ids()``,
    ``pull()`` with no exclude, ``clear()``) scan every group — diagnostics,
    not the hot path.
    """

    def __init__(
        self,
        folders: "ShardedFolders | str | Sequence[SharedFolder]",
        *,
        group_of: Mapping[str, int] | Callable[[str], int] | None = None,
        gossip_fanout: int = 1,
        summary_sample: int = 16,
        transport: str | None = None,
        keep_history: bool = False,
        rebase_every: int = 10,
        delta_density_threshold: float = 0.5,
        topk_fraction: float = 0.01,
        compress: str = "none",
        decode_cache_entries: int = 256,
        roster_folder: SharedFolder | None = None,
        roster_check_every: int = 8,
    ):
        if isinstance(folders, str):
            folders = ShardedFolders.from_uri(folders)
        elif not isinstance(folders, ShardedFolders):
            folders = ShardedFolders.from_folders(folders)
        self.folders = folders
        self.num_groups = folders.num_groups
        # summary-tree depth rides on the folder handle ('shard<G>x<L>+');
        # levels=1 is the flat ring — one global level-0 ring, no tiers
        self.levels = max(1, int(getattr(folders, "levels", 1)))
        self.hierarchy = GossipHierarchy(self.num_groups, self.levels)
        # fail fast, like WeightStore: per-group stores are built lazily on
        # first push, far too late to learn transport= or compress= was
        # misspelled (or zstd unavailable). The throwaway pipeline runs the
        # full spec-grammar validation; per-group stores build their own.
        probe = TransportPipeline.from_spec(
            transport, compress=compress, topk_fraction=topk_fraction)
        self.transport = probe.spec
        if gossip_fanout < 1:
            raise ValueError(f"gossip_fanout must be >= 1, got {gossip_fanout}")
        self.gossip_fanout = gossip_fanout
        if summary_sample < 1:
            raise ValueError(f"summary_sample must be >= 1, got {summary_sample}")
        self.summary_sample = summary_sample
        self._group_of = group_of
        self._keep_history = keep_history
        self._store_kwargs = dict(
            rebase_every=rebase_every,
            delta_density_threshold=delta_density_threshold,
            topk_fraction=topk_fraction,
            compress=compress,
            decode_cache_entries=decode_cache_entries,
        )
        # interned LeafSpecs for summary decode (shared across group folders —
        # a summary key names its exact bytes, so layouts interned here are
        # valid wherever the blob was copied by gossip)
        self._specs: dict = {}
        self._stores: dict[int, WeightStore] = {}
        # Memoized summary indexes, group -> (listing token, index, populated).
        # ``SharedFolder.list_version()`` is a folder-level listing-change
        # token: while it holds still, the parsed index is reused verbatim and
        # steady-state pulls/forwards skip the O(keys) re-split entirely
        # (hits/misses surface via PipelineStats). Entries are only ever
        # replaced whole (atomic under the GIL) and the cached index is
        # treated as read-only by every consumer.
        self._index_memo: dict[int, tuple] = {}
        self._lock = threading.Lock()
        self._push_seq = 0  # paces the empty-group rechecks in _forward
        self._assumed_empty: set[int] = set()  # groups last seen memberless
        # Decoded-summary cache. A summary key names its exact content
        # (origin + version + content hash; forwarded copies are
        # byte-identical), so a decoded pseudo-update can be reused across
        # pulls AND across group folders with no version-token dance — the key
        # is the identity. Held one-per-origin plus rotation slack: a smaller
        # bound would evict inside the rotating sample window and re-pay an
        # O(num_groups) decode stream every cycle.
        self._summary_cache = _LruCache(
            max(4 * max(summary_sample, 16), self.num_groups)
        )
        # Rotation bookkeeping per pulling node: its own window counter (a
        # store-global counter would stride past some origins forever when the
        # instance is shared by several nodes), which (origin, version-hash)
        # pairs its pulls have already been handed, and whether unseen pairs
        # remain (drives the state-hash nudge that keeps rotation alive when
        # the folder itself is quiet). Keyed per node, so concurrent pulls by
        # different nodes touch different entries.
        self._window: dict[str, int] = {}
        self._served: dict[str, set] = {}
        self._rotation_pending: dict[str, bool] = {}
        # Elastic membership: group assignment re-resolves against the
        # freshest ``fleet/roster/<epoch>`` blob (see write_roster). The
        # roster folder is passed explicitly or lazily derived from the base
        # URI; URI-less factory stores opt in via roster_folder=. Epoch bumps
        # are checked every ``roster_check_every`` pushes plus on explicit
        # refresh_roster() calls; all roster state mutates under self._lock.
        self._roster_folder = roster_folder
        self._roster_probed = roster_folder is not None
        self._roster_check_every = max(1, int(roster_check_every))
        self._roster_epoch = -1
        self._roster_groups: dict[str, int] | None = None
        self._home: dict[str, int] = {}  # last-seen home, for push migration
        # instrumentation — bumped under _stats_lock: a shared instance
        # serves many threaded nodes, and bare += would lose updates
        self._stats_lock = threading.Lock()
        self.num_summary_refreshes = 0
        self.num_summary_forwards = 0  # ring copies + tier down-copies
        self.num_super_folds = 0  # SuperSummary deposits (levels > 1)
        self.num_regroups = 0  # roster epoch bumps absorbed
        # summary-layer wire traffic (refresh deposits + ring-forward copies);
        # per-group latest/base/history bytes live on the per-group stores
        self.summary_bytes_written = 0
        # attached per-node Telemetry (attach_telemetry); per-group stores
        # created later inherit it
        self._telemetry = None

    # -- routing -------------------------------------------------------------
    def group_of(self, node_id: str) -> int:
        # roster assignment wins when a roster has been absorbed: it is the
        # dynamic-membership truth. Nodes the roster has not (yet) heard of
        # fall through to the static override / stable hash, so a node can
        # always push before its membership propagates.
        roster = self._roster_groups
        if roster is not None:
            g = roster.get(node_id)
            if g is not None:
                return g
        if self._group_of is not None:
            if callable(self._group_of):
                g = int(self._group_of(node_id))
                if not 0 <= g < self.num_groups:
                    raise ValueError(f"group_of({node_id!r}) = {g} out of range")
                return g
            g = self._group_of.get(node_id)
            if g is not None:
                return int(g)
        return default_group_of(node_id, self.num_groups)

    # -- dynamic membership ---------------------------------------------------
    def _ensure_roster_folder(self) -> SharedFolder | None:
        """The folder roster blobs live in: explicit ``roster_folder=``, else
        (for URI-built shards) the wrapper-stripped base URI's folder — the
        same place the fleet launcher keeps its control plane. Factory-built
        stores without an explicit folder never probe (there is no base)."""
        if not self._roster_probed:
            with self._lock:
                if not self._roster_probed:
                    self._roster_probed = True
                    uri = self.folders.uri
                    if uri is not None:
                        from .store import make_folder
                        from .transport import parse_folder_uri

                        _wrappers, base = parse_folder_uri(uri)
                        # anonymous memory:// has no cross-store identity to
                        # anchor a roster; named memory://<name> does (shared
                        # registry), as do disk/s3 bases.
                        if base != "memory://":
                            self._roster_folder = make_folder(base)
        return self._roster_folder

    def refresh_roster(self) -> bool:
        """Absorb the freshest roster epoch, recomputing ``balanced_groups``
        over its membership. True when the epoch advanced (a regroup)."""
        folder = self._ensure_roster_folder()
        if folder is None:
            return False
        cur = read_roster(folder)
        if cur is None:
            return False
        epoch, nodes = cur
        with self._lock:
            if epoch <= self._roster_epoch:
                return False
            self._roster_groups = balanced_groups(nodes, self.num_groups) \
                if nodes else None
            self._roster_epoch = epoch
        # A regroup dissolves the old grouping: summaries (and supers folded
        # from them) computed under the previous epoch still credit departed
        # members, so cached decodes must not satisfy post-epoch pulls — drop
        # them along with the listing memo and the empty-group assumptions,
        # and let the folders' own refresh cycle rebuild the fresh view.
        self._summary_cache.clear()
        self._index_memo.clear()
        self._assumed_empty.clear()
        with self._stats_lock:
            self.num_regroups += 1
        _log.info("roster epoch %d absorbed: %d members regrouped over %d groups",
                  epoch, len(nodes), self.num_groups)
        return True

    @property
    def roster_epoch(self) -> int:
        """Freshest roster epoch absorbed so far (-1: none)."""
        return self._roster_epoch

    def _migrate_node(self, node_id: str, old_group: int, new_group: int) -> None:
        """A regrouped node's deposits move home: drop its keys from the old
        group's folder so the next push to the new home is the single copy.
        The old group's summary drains the departed contribution on its next
        member refresh; readers racing this delete fall back to pull_node's
        cross-group scan."""
        folder = self._folder(old_group)
        prefixes = (f"base/{node_id}/", f"chain/{node_id}/",
                    f"history/{node_id}/", f"state/{node_id}")
        for key in folder.keys():
            if key == f"latest/{node_id}" or key.startswith(prefixes):
                folder.delete(key)
        _log.info("node %s migrated group %d -> %d", node_id, old_group, new_group)

    def _store(self, group: int) -> WeightStore:
        with self._lock:
            store = self._stores.get(group)
            if store is None:
                store = WeightStore(
                    self.folders.group_folder(group),
                    transport=self.transport,
                    keep_history=self._keep_history,
                    **self._store_kwargs,
                )
                if self._telemetry is not None:
                    store.attach_telemetry(self._telemetry)
                self._stores[group] = store
            return store

    def _folder(self, group: int) -> SharedFolder:
        return self._store(group).folder

    # keep_history must fan out to every per-group store, present and future
    # (SyncFederatedNode flips it post-construction).
    @property
    def keep_history(self) -> bool:
        return self._keep_history

    @keep_history.setter
    def keep_history(self, value: bool) -> None:
        self._keep_history = value
        with self._lock:
            stores = list(self._stores.values())
        for store in stores:
            store.keep_history = value

    # -- summary plumbing -----------------------------------------------------
    @staticmethod
    def _summary_index(keys: Iterable[str]) -> dict[tuple[int, str], list]:
        """(level, zero-padded origin string) -> [freshest 'version-hash', its
        key, stale keys], from a key listing alone — freshness comparisons AND
        garbage collection need no blob reads and no relisting (stale keys a
        racing writer adds after this listing are caught by the next pass)."""
        index: dict[tuple[int, str], list] = {}
        for key in keys:
            parsed = _parse_summary_key(key)
            if parsed is None:
                continue
            level, origin, version = parsed
            have = index.get((level, origin))
            if have is None:
                index[(level, origin)] = [version, key, []]
            elif version > have[0]:
                have[2].append(have[1])
                have[0], have[1] = version, key
            else:
                have[2].append(key)
        return index

    def _indexed(self, group: int) -> tuple[dict[tuple[int, str], list], bool]:
        """``group``'s folder summary index plus its populated flag (any
        ``latest/`` key), memoized on the folder's listing-change token.
        While ``list_version()`` holds still the parsed index is reused —
        steady-state pulls and no-op forwards skip the O(keys) re-split.
        Backends without a token (None) re-index every call; a missed
        DiskFolder invalidation self-heals on the next listing change, and
        the returned index must be treated as read-only (it is shared)."""
        folder = self._folder(group)
        stats = self._store(group).pipeline.stats
        token = folder.list_version()
        if token is not None:
            memo = self._index_memo.get(group)
            if memo is not None and memo[0] == token:
                stats.incr("summary_index_hits")
                return memo[1], memo[2]
        stats.incr("summary_index_misses")
        keys = folder.keys()
        index = self._summary_index(keys)
        populated = any(k.startswith("latest/") for k in keys)
        if token is not None:
            self._index_memo[group] = (token, index, populated)
        return index, populated

    @staticmethod
    def _replace_summaries(folder: SharedFolder, stale: list | None) -> None:
        """GC an origin's superseded summary keys after a fresher put."""
        if stale is None:
            return
        for key in stale[2]:
            folder.delete(key)
        folder.delete(stale[1])

    def load_summary(self, group: int, origin: int,
                     level: int = 0) -> GroupSummary | SuperSummary | None:
        """Freshest readable level-``level`` summary of ``origin`` held in
        ``group``'s folder (diagnostics + tests; pull() uses the same
        resolution)."""
        folder = self._folder(group)
        entry = self._summary_index(folder.keys()).get((level, f"{origin:04d}"))
        if entry is None:
            return None
        _vtag, freshest, stale = entry
        loads = deserialize_group_summary if level == 0 else deserialize_super_summary
        # freshest first, stale fallbacks next — tolerates a racing GC
        for key in [freshest, *sorted(stale, reverse=True)]:
            blob = folder.get(key)
            if blob is not None:
                try:
                    return loads(blob)
                except (ValueError, KeyError):
                    continue
        return None

    @staticmethod
    def _group_mean(updates: list[NodeUpdate], weights: list[int]):
        """Example-weighted mean of the group's latest params. When the store
        pulled spec-sharing FlatUpdates (the steady state), this accumulates
        the host flats in numpy, in the reference's order and precision, so a
        torch node and a JAX node write summaries of the same values; mixed
        structures fall back to the per-leaf tree mean."""
        first = updates[0]
        spec = getattr(first, "spec", None)
        if spec is not None and all(
            getattr(u, "spec", None) is not None and spec.compatible(u.spec)
            for u in updates
        ):
            coeffs = np.asarray(weights, np.float64)
            coeffs = (coeffs / coeffs.sum()).astype(np.float32)
            # in-place accumulation: no (K, N) stack transient on the push path
            out = np.multiply(updates[0].flat, coeffs[0])
            scratch = np.empty_like(out)
            for c, u in zip(coeffs[1:], updates[1:]):
                np.multiply(u.flat, c, out=scratch)
                out += scratch
            return spec.unflatten(out)
        return tree_weighted_mean([u.params for u in updates], weights)

    def _refresh_summary(self, group: int) -> None:
        """Recompute ``group``'s own summary from its latest set and deposit it
        if fresher than what the folder already holds. Every pushing node runs
        this — the 'election' is simply that a stale folder gets refreshed by
        whichever member pushes next, and version-ordered keys make the race
        last-writer-wins without blob reads."""
        store = self._store(group)
        updates = store.pull()
        if not updates:
            return
        vv = {u.node_id: int(u.counter) for u in updates}
        version = sum(c + 1 for c in vv.values())
        folder = store.folder
        current = self._indexed(group)[0].get((0, f"{group:04d}"))
        if current is not None and _version_scalar(current[0]) >= version:
            return
        weights = [max(1, u.num_examples) for u in updates]
        summary = GroupSummary(
            params=self._group_mean(updates, weights),
            num_examples=sum(weights),
            origin=group,
            version=version,
            version_vector=vv,
            timestamp=max(u.timestamp for u in updates),
        )
        # summaries ride the same pipeline envelope as every other deposit
        blob = store.pipeline.encode_summary(summary)
        folder.put(_summary_key(group, version, content_hash(blob)), blob)
        with self._stats_lock:
            self.summary_bytes_written += len(blob)
            self.num_summary_refreshes += 1
        self._replace_summaries(folder, current)
        _log.debug("group %d: refreshed summary v%d (%d members, %d bytes)",
                   group, version, len(updates), len(blob))

    def _forward(self, group: int) -> None:
        """Forward the level-0 summaries ``group``'s folder holds to the next
        ``gossip_fanout`` populated groups on its level-0 ring (the whole
        fleet at ``levels=1``; the group's own segment under a hierarchy —
        cross-segment flow is the tiers' job). Empty groups en route don't
        count toward the fanout — so hash-assignment holes never cut the
        ring — and are *seeded once* per origin rather than kept fresh (their
        folder is read only by a node that later joins, whose own pushes then
        pull the group into the live ring); between periodic rechecks they
        don't even cost a listing. A populated target that is already as
        fresh costs one key listing, no writes."""
        ring = self.hierarchy.ring(0, group)
        if len(ring) <= 1:
            return
        index, _populated = self._indexed(group)
        ringset = set(ring)
        held = [
            (k, e) for k, e in index.items()
            if k[0] == 0 and int(k[1]) in ringset
        ]
        if not held:
            return
        folder = self._folder(group)
        blobs: dict[str, bytes | None] = {}  # one home-folder read per origin,
        relayed = 0                          # however many targets need it
        # every 16th push, re-list groups assumed empty: one that gained its
        # first member starts receiving forwards within bounded delay
        recheck = self._push_seq % 16 == 0
        pos = group - ring[0]
        for step in range(1, len(ring)):
            target = ring[(pos + step) % len(ring)]
            if target in self._assumed_empty and not recheck:
                continue
            target_folder = self._folder(target)
            target_index, populated = self._indexed(target)
            for origin, (vtag, key, _stale) in held:
                have = target_index.get(origin)
                if have is not None and (not populated or have[0] >= vtag):
                    continue  # empty targets: seed once, don't keep fresh
                if key not in blobs:
                    blobs[key] = folder.get(key)
                blob = blobs[key]
                if blob is None:  # GC'd under us — a racing writer is fresher
                    continue
                target_folder.put(key, blob)
                with self._stats_lock:
                    self.summary_bytes_written += len(blob)
                    self.num_summary_forwards += 1
                self._replace_summaries(target_folder, have)
            if populated:
                self._assumed_empty.discard(target)
                relayed += 1
                if relayed >= self.gossip_fanout:
                    break
            else:
                self._assumed_empty.add(target)

    # -- summary tiers (levels > 1) -------------------------------------------
    def _fold_super(self, level: int, origin: int, holder_group: int) -> None:
        """Fold (level, origin)'s child summaries — gathered in the holder
        group's folder by the level-(level-1) ring — into one ``SuperSummary``
        deposit, if any child is fresher than the current super. The version
        scalar is the sum of folded child version scalars, so it is monotone
        in child freshness and comparable from key listings alone; the
        freshness check therefore reads no blobs in the steady state."""
        hier = self.hierarchy
        folder = self._folder(holder_group)
        index, _pop = self._indexed(holder_group)
        child_entries = []
        for child in hier.children(level, origin):
            e = index.get((level - 1, f"{child:04d}"))
            if e is not None:
                child_entries.append((child, e))
        if not child_entries:
            return
        version = sum(_version_scalar(e[0]) for _, e in child_entries)
        cur = index.get((level, f"{origin:04d}"))
        if cur is not None and _version_scalar(cur[0]) >= version:
            return
        updates, weights = [], []
        child_versions: dict[str, int] = {}
        vv: dict[str, int] = {}
        for child, (vtag, key, _stale) in child_entries:
            update = self._summary_cache.get(key)
            if update is None:
                blob = folder.get(key)
                if blob is None:
                    continue  # GC'd under us — a racing folder is fresher
                update = self._decode_summary(blob)
                if update is None:
                    continue
                self._summary_cache.put(key, update)
            updates.append(update)
            weights.append(max(1, update.num_examples))
            child_versions[str(child)] = _version_scalar(vtag)
            # per-child counter maxima, NOT a fleet-wide node vector: the
            # propagated counter (max over children) stays exact at every
            # level while blob metadata stays O(branching), and the per-node
            # truth remains one level-0 hop away via child_versions
            vv[update.node_id] = int(update.counter)
        if not updates:
            return
        version = sum(child_versions.values())
        if cur is not None and _version_scalar(cur[0]) >= version:
            return  # undecodable stragglers dropped us below the held super
        summary = SuperSummary(
            params=self._group_mean(updates, weights),
            num_examples=sum(weights),
            origin=origin,
            level=level,
            version=version,
            child_versions=child_versions,
            version_vector=vv,
            timestamp=max(u.timestamp for u in updates),
        )
        blob = self._store(holder_group).pipeline.encode_super_summary(summary)
        folder.put(_summary_key(origin, version, content_hash(blob),
                                level=level), blob)
        with self._stats_lock:
            self.summary_bytes_written += len(blob)
            self.num_super_folds += 1
        self._replace_summaries(folder, cur)
        _log.debug("super L%d.%d folded v%d (%d children, %d bytes) -> group %d",
                   level, origin, version, len(updates), len(blob), holder_group)

    def _forward_super(self, level: int, origin: int, holder_group: int) -> None:
        """Forward the level-``level`` supers the holder's folder carries to
        the next ``gossip_fanout`` aggregators on the level-``level`` ring.
        Unlike level 0 there is no populated check and no seeding: ring
        positions are origins, their holder folders are structurally active
        whether or not the holder group has live members (any descendant's
        push writes into them)."""
        hier = self.hierarchy
        ring = hier.ring(level, origin)
        if len(ring) <= 1:
            return
        index, _pop = self._indexed(holder_group)
        ringset = set(ring)
        held = [
            (k, e) for k, e in index.items()
            if k[0] == level and int(k[1]) in ringset
        ]
        if not held:
            return
        folder = self._folder(holder_group)
        blobs: dict[str, bytes | None] = {}
        pos = origin - ring[0]
        for step in range(1, min(len(ring), self.gossip_fanout + 1)):
            target_origin = ring[(pos + step) % len(ring)]
            target_group = hier.holder(level, target_origin)
            if target_group == holder_group:
                continue
            target_folder = self._folder(target_group)
            target_index, _tp = self._indexed(target_group)
            for key2, (vtag, key, _stale) in held:
                have = target_index.get(key2)
                if have is not None and have[0] >= vtag:
                    continue
                if key not in blobs:
                    blobs[key] = folder.get(key)
                blob = blobs[key]
                if blob is None:
                    continue
                target_folder.put(key, blob)
                with self._stats_lock:
                    self.summary_bytes_written += len(blob)
                    self.num_summary_forwards += 1
                self._replace_summaries(target_folder, have)

    def _down_copy(self, group: int, level: int, holder_group: int) -> None:
        """Copy the sibling supers ``group``'s pulls are scoped to from its
        level-``level`` chain folder into its own folder, so a pull touches
        exactly one folder no matter how deep the tree. Own-path origins are
        skipped (they cover the puller itself); fresh copies land under the
        same content-addressed keys, so decoded-summary caching is unaffected
        by which folder a blob was read from."""
        if holder_group == group:
            return
        allowed = self.hierarchy.scope(group).get(level)
        if not allowed:
            return
        index, _pop = self._indexed(holder_group)
        held = [
            (k, e) for k, e in index.items()
            if k[0] == level and int(k[1]) in allowed
        ]
        if not held:
            return
        own_index, _op = self._indexed(group)
        folder = self._folder(holder_group)
        own_folder = self._folder(group)
        for key2, (vtag, key, _stale) in held:
            have = own_index.get(key2)
            if have is not None and have[0] >= vtag:
                continue
            blob = folder.get(key)
            if blob is None:
                continue
            own_folder.put(key, blob)
            with self._stats_lock:
                self.summary_bytes_written += len(blob)
                self.num_summary_forwards += 1
            self._replace_summaries(own_folder, have)

    def _tier_work(self, group: int) -> None:
        """One push's tier duties along ``group``'s ancestor chain: fold the
        covering super at each level, forward it on that level's ring, and
        down-copy sibling supers into the home folder for the next pull.
        O(branching) key work per level — O(branching × levels) per push."""
        hier = self.hierarchy
        path = hier.path(group)
        for t in range(1, self.levels):
            origin = path[t]
            holder_group = hier.holder(t, origin)
            with child_span(f"gossip.l{t}.fold", self._telemetry):
                self._fold_super(t, origin, holder_group)
            with child_span(f"gossip.l{t}.forward", self._telemetry):
                self._forward_super(t, origin, holder_group)
            with child_span("gossip.down", self._telemetry):
                self._down_copy(group, t, holder_group)

    def _decode_summary(self, blob: bytes) -> NodeUpdate | None:
        """(Super-)summary blob → pseudo-peer update, decoded straight into a
        flat vector (a ``FlatUpdate`` sharing this store's interned specs) so
        that downstream client-side aggregation stays on the flat hot path;
        falls back to the tree decode for non-f32-embeddable params."""
        try:
            spec, flat, meta = decode_params_flat(blob, self._specs)
            if "summary_of" in meta:
                origin, level = int(meta["summary_of"]), 0
            elif "super_summary_of" in meta:
                origin = int(meta["super_summary_of"])
                level = int(meta.get("level", 1))
            else:
                return None
            version_vector = meta.get("version_vector", {})
            return FlatUpdate(
                flat, spec,
                num_examples=int(meta["num_examples"]),
                node_id=group_peer_id(origin, level),
                # Node-counter units (freshest covered member's counter), NOT
                # the version scalar: staleness-aware strategies (FedAsync)
                # compare this against their own epoch counter. For tiers the
                # max over per-child maxima IS the max over covered nodes.
                counter=max((int(v) for v in version_vector.values()), default=0),
                timestamp=float(meta.get("timestamp", 0.0)),
                metrics={"summary_of": origin, "summary_level": level,
                         "summary_version": int(meta["version"])},
            )
        except FlatDecodeUnsupported:
            pass
        except (ValueError, KeyError, ImportError):
            # ImportError: a zstd-wrapped summary forwarded from a group whose
            # writer has a zstd module, read by a node without one — skip it
            # (eventual consistency), never crash the pull.
            return None
        try:
            summary = deserialize_group_summary(blob)
            level = 0
        except (ValueError, KeyError, ImportError):
            try:
                summary = deserialize_super_summary(blob)
                level = summary.level
            except (ValueError, KeyError, ImportError):
                return None
        return NodeUpdate(
            params=summary.params,
            num_examples=summary.num_examples,
            node_id=group_peer_id(summary.origin, level),
            counter=max(summary.version_vector.values(), default=0),
            timestamp=summary.timestamp,
            metrics={"summary_of": summary.origin, "summary_level": level,
                     "summary_version": summary.version},
        )

    def _peer_summaries(self, group: int, exclude: str) -> list[NodeUpdate]:
        """Foreign (super-)summaries in ``group``'s folder as pseudo-peer
        updates, bounded to ``summary_sample`` per pull (rotating through all
        admissible entries across successive pulls). Under a hierarchy only
        the scope partition is admissible — own level-0 segment plus one
        sibling set per tier — so a leaked or stale out-of-scope blob can
        never double-count a subtree. Tracks which ((level, origin), version)
        pairs ``exclude``'s pulls have been handed so ``state_hash`` can keep
        nudging the node until the rotation has covered everything."""
        folder = self._folder(group)
        index, _pop = self._indexed(group)
        scope = self.hierarchy.scope(group)
        # (level, zero-padded origin) pairs sort level-major, numeric within a
        # level — a deterministic rotation order shared by every node
        admissible = sorted(
            k for k in index
            if k[0] < self.levels and int(k[1]) in scope[k[0]]
        )
        current = {(k, index[k][0]) for k in admissible}
        served = self._served.get(exclude, set()) & current  # drop superseded pairs
        seq = self._window.get(exclude, 0)
        self._window[exclude] = seq + 1
        window = admissible
        if self.summary_sample and len(admissible) > self.summary_sample:
            # Tile the entry space per pulling node: ITS successive pulls see
            # disjoint sample windows, so all entries are covered in
            # ceil(n/sample) of its pulls and the decoded-summary cache
            # reaches steady state just as fast.
            start = (seq * self.summary_sample) % len(admissible)
            window = (admissible + admissible)[start:start + self.summary_sample]
        out = []
        for key2 in window:
            vtag, key, _stale = index[key2]
            served.add((key2, vtag))  # handed to this pull, readable or not
            cached = self._summary_cache.get(key)  # refreshes LRU position
            if cached is not None:
                out.append(cached)
                continue
            blob = folder.get(key)
            if blob is None:
                continue
            update = self._decode_summary(blob)
            if update is None:
                continue
            self._summary_cache.put(key, update)
            out.append(update)
        self._served[exclude] = served
        self._rotation_pending[exclude] = len(served) < len(current)
        return out

    # -- the WeightStore interface -------------------------------------------
    def push(self, update: NodeUpdate) -> None:
        self._push_seq += 1
        # paced roster check: one base-folder key listing every
        # _roster_check_every pushes keeps regrouping live without putting a
        # scan on every hot-path push
        if (self._push_seq - 1) % self._roster_check_every == 0:
            self.refresh_roster()
        group = self.group_of(update.node_id)
        old = self._home.get(update.node_id)
        self._home[update.node_id] = group
        if old is not None and old != group:
            self._migrate_node(update.node_id, old, group)
        # this push populates ``group`` — never skip it as an empty hole again
        # (an instance shared by many nodes learns this for every group it
        # routes; per-node instances rely on the periodic recheck instead)
        self._assumed_empty.discard(group)
        self._store(group).push(update)
        # the outer "gossip" span is the dashboard's phase; the l<k> sub-spans
        # show where summary time goes per level
        with child_span("gossip", self._telemetry):
            with child_span("gossip.l0.refresh", self._telemetry):
                self._refresh_summary(group)
            with child_span("gossip.l0.forward", self._telemetry):
                self._forward(group)
            if self.levels > 1:
                self._tier_work(group)

    def state_hash(self, exclude_node: str | None = None) -> str:
        with child_span("state_hash", self._telemetry):
            return self._state_hash(exclude_node)

    def _state_hash(self, exclude_node: str | None) -> str:
        """O(group-folder keys): only the caller's home folder is hashed. The
        caller's own deposits AND its own group's summary (which its push just
        refreshed) are excluded, so Algorithm 1's skip check survives; foreign
        summaries forwarded in by upstream groups are included — their arrival
        is precisely the cross-group change a node must react to."""
        if exclude_node is None:
            h = hashlib.sha256()
            for g in range(self.num_groups):
                # state/ blobs are optimizer recovery data, fleet/ blobs are
                # launcher control traffic, obs/ blobs are telemetry — none
                # is federation signal, excluded exactly as the flat store does
                h.update(self._folder(g).state_hash(
                    exclude=("state/", "fleet/", "obs/")).encode())
            return h.hexdigest()[:16]
        group = self.group_of(exclude_node)
        # own-path summary prefixes at every level: the node's own push
        # refreshes its group summary AND (when it is on an aggregator's
        # folder) re-folds the covering supers — self-inflicted churn that
        # must not defeat Algorithm 1's skip check. Sibling entries at each
        # level stay included: their arrival IS the cross-group signal.
        path = self.hierarchy.path(group)
        exclude = (
            f"latest/{exclude_node}",
            f"base/{exclude_node}/",
            f"chain/{exclude_node}/",
            f"history/{exclude_node}/",
            *(f"{_summary_prefix(t)}{path[t]:04d}/" for t in range(self.levels)),
            "state/",
            "fleet/",
            "obs/",
        )
        base = self._folder(group).state_hash(exclude=exclude)
        if self._rotation_pending.get(exclude_node):
            # The folder may be quiet, but this node's pulls have not yet
            # been handed every foreign summary (origins > summary_sample):
            # without this nudge the node's skip check would freeze the
            # rotation and some groups would never be folded in. Mixing in
            # the node's own window counter keeps the hash moving until
            # coverage is complete, then it settles back to the folder hash.
            seq = self._window.get(exclude_node, 0)
            return hashlib.sha256(
                f"{base}:rotation:{seq}".encode()
            ).hexdigest()[:16]
        return base

    def node_ids(self) -> list[str]:
        out: set[str] = set()
        for g in range(self.num_groups):
            out.update(self._store(g).node_ids())
        return sorted(out)

    def pull(self, exclude: str | None = None) -> list[NodeUpdate]:
        """With ``exclude`` (the caller): home-group peers as real updates plus
        a bounded sample of foreign-group summaries as pseudo-peers. Without:
        a fleet-wide scan of real updates (no summaries — they would double
        count), for diagnostics."""
        if exclude is None:
            out = []
            for g in range(self.num_groups):
                out.extend(self._store(g).pull())
            return out
        group = self.group_of(exclude)
        return self._store(group).pull(exclude=exclude) + self._peer_summaries(group, exclude)

    def pull_node(self, node_id: str) -> NodeUpdate | None:
        home = self.group_of(node_id)
        update = self._store(home).pull_node(node_id)
        if update is None and self._roster_groups is not None:
            # Regroup race: a roster bump moved the node's home before its
            # deposits migrated (migration happens on its next push). A
            # resuming node must still find its latest blob, so fall back to
            # an O(groups) sweep — miss path only, never the steady state.
            for g in range(self.num_groups):
                if g == home:
                    continue
                update = self._store(g).pull_node(node_id)
                if update is not None:
                    break
        return update

    # -- strategy-state recovery + prefetch: route to the home group ----------
    def push_strategy_state(self, node_id: str, strategy: str, counter: int,
                            state: dict) -> None:
        self._store(self.group_of(node_id)).push_strategy_state(
            node_id, strategy, counter, state)

    def pull_strategy_state(self, node_id: str) -> tuple[dict, dict] | None:
        return self._store(self.group_of(node_id)).pull_strategy_state(node_id)

    # -- observability blobs: deposit to the home group, read fleet-wide ------
    def attach_telemetry(self, telemetry) -> None:
        self._telemetry = telemetry
        with self._lock:
            stores = list(self._stores.values())
        for store in stores:
            store.attach_telemetry(telemetry)

    def push_obs(self, node_id: str, seq: int, payload: dict, *,
                 keep: int | None = None) -> None:
        self._store(self.group_of(node_id)).push_obs(
            node_id, seq, payload, keep=keep)

    def pull_obs(self, node_id: str | None = None) -> list[tuple[str, int, dict]]:
        if node_id is not None:
            return self._store(self.group_of(node_id)).pull_obs(node_id)
        out = []
        for g in range(self.num_groups):
            out.extend(self._store(g).pull_obs())
        return out

    def start_prefetch(self, interval: float = 0.1, *, exclude: str):
        """Background-warm the decoded-update cache of ``exclude``'s home
        group (the only folder its pulls touch). Requires the node id —
        sharded prefetch has no meaning without a home group."""
        return self._store(self.group_of(exclude)).start_prefetch(
            interval, exclude=exclude)

    def stop_prefetch(self) -> None:
        with self._lock:
            stores = list(self._stores.values())
        for store in stores:
            store.stop_prefetch()

    def pull_round(self, counter: int, exclude: str | None = None) -> list[NodeUpdate]:
        """Sync-mode barrier set. With ``exclude`` this is the caller's home
        group only: synchronous federation is per-group under sharding (set
        ``SyncFederatedNode(num_nodes=<group size>)``); cross-group state still
        arrives via async gossip summaries on ``pull``."""
        if exclude is None:
            out = []
            for g in range(self.num_groups):
                out.extend(self._store(g).pull_round(counter))
            return out
        return self._store(self.group_of(exclude)).pull_round(counter, exclude=exclude)

    def clear(self) -> None:
        for g in range(self.num_groups):
            self._store(g).clear()
        # Version scalars restart after a clear, so cached decodes and the
        # populated/seeded/served memos are all invalid — drop every bit of
        # derived state along with the blobs.
        self._summary_cache.clear()
        self._index_memo.clear()
        self._assumed_empty.clear()
        self._window.clear()
        self._served.clear()
        self._rotation_pending.clear()
        self._specs.clear()

    def cache_stats(self) -> dict[str, int]:
        """Aggregate decode-cache + byte counters across the per-group stores,
        including the gossip summary traffic (refreshes + ring forwards) —
        often the dominant wire cost at fleet scale."""
        hits = misses = read = 0
        index_hits = index_misses = 0
        written = self.summary_bytes_written
        with self._lock:
            stores = list(self._stores.values())
        for store in stores:
            hits += store.decode_hits
            misses += store.decode_misses
            written += store.bytes_written
            read += store.bytes_read
            pstats = store.pipeline.stats.as_dict()
            index_hits += pstats.get("summary_index_hits", 0)
            index_misses += pstats.get("summary_index_misses", 0)
        return {"decode_hits": hits, "decode_misses": misses,
                "bytes_written": written, "bytes_read": read,
                "summary_bytes_written": self.summary_bytes_written,
                "summary_index_hits": index_hits,
                "summary_index_misses": index_misses}
