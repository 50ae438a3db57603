"""The serverless weight store (the port of ``repro.core.store``).

The paper's central abstraction: "any remote folder accessible by the client
machine" (S3 bucket, blob container, NFS mount). A client *pushes* its update
blob under its node-id key, reads the folder *state hash* to detect change,
and *pulls* the latest blob per peer.

Backends:
  * ``InMemoryFolder`` — thread-safe shared dict; mirrors the paper's
    python-multithreading simulation setup.
  * ``DiskFolder``    — a filesystem directory with atomic writes; this is the
    production backend (point it at an NFS/gcsfuse/s3fs mount).
  * ``S3Folder``      — not ported yet (ROADMAP Queue 1 item 13a, slice 3); the
    class exists so the public API matches and raises ``NotImplementedError``.
  * ``CachingFolder`` — read-through wrapper over any backend: skips
    re-downloading blobs whose per-key ``version`` metadata is unchanged
    (the Algorithm 1 state-hash fast path at per-peer granularity).

All backends implement the tiny ``SharedFolder`` byte-blob protocol; the
``WeightStore`` wrapper above them speaks ``NodeUpdate`` pytrees, keeps one
*latest* blob per node (plus optional history), and exposes the state-hash
fast path from Algorithm 1. The wire *transport* itself — how an update
becomes deposited bytes — lives in ``transport.py`` as a codec pipeline
(``TransportPipeline``); the store routes every push/decode through it.

Stores are host-side: blobs, decoded flats and specs are numpy. Two packages
writing one folder agree on ``state_hash`` — it depends only on the folder.
"""
from __future__ import annotations

import hashlib
import os
import random
import tempfile
import threading
import time
import urllib.parse
from abc import ABC, abstractmethod
from typing import Any

from .serialize import (
    NodeUpdate,
    deserialize_obs_blob,
    deserialize_strategy_state,
    serialize_obs_blob,
    serialize_strategy_state,
)
from .transport import (
    _LruCache,
    Prefetcher,
    StoreContext,
    TransportPipeline,
    family_transport_spec,
    parse_folder_uri,
)
from repro_torch.logs import get_logger

_log = get_logger("store")

def _exclusion(exclude: "str | tuple[str, ...] | None"):
    """Normalize a state_hash exclusion — None, one exact key, or a tuple of
    exact keys / prefixes (trailing '/') — into a fast per-key predicate:
    one set lookup plus one C-level tuple-startswith, hoisted out of the
    per-key loop (state_hash runs this over every key in the folder)."""
    if exclude is None:
        return None
    if isinstance(exclude, str):
        exclude = (exclude,)
    exact = frozenset(e for e in exclude if not e.endswith("/"))
    prefixes = tuple(e for e in exclude if e.endswith("/"))
    if prefixes:
        return lambda key: key in exact or key.startswith(prefixes)
    return exact.__contains__


class SharedFolder(ABC):
    """Byte-blob folder: the minimal contract a 'remote folder' must satisfy."""

    @abstractmethod
    def put(self, key: str, blob: bytes) -> None: ...

    @abstractmethod
    def get(self, key: str) -> bytes | None: ...

    @abstractmethod
    def keys(self) -> list[str]: ...

    @abstractmethod
    def delete(self, key: str) -> None: ...

    def version(self, key: str) -> Any | None:
        """Cheap per-key change token (vclock, stat tuple, etag). Two calls
        returning equal non-None values imply the blob content is unchanged.
        ``None`` means the backend cannot answer cheaply (or the key is
        missing) — callers must fetch."""
        return None

    def list_version(self) -> Any | None:
        """Cheap folder-level change token: two calls returning equal
        non-None values imply the *key listing* (membership, not blob
        contents) is unchanged, so a parsed index over ``keys()`` may be
        reused. ``None`` means the backend cannot answer cheaper than
        listing — callers must re-list. Used by the sharded gossip store to
        skip re-splitting every summary key on steady-state pulls."""
        return None

    def put_if_absent(self, key: str, blob: bytes) -> bool:
        """Create ``key`` only if it does not exist; True when THIS call
        created it. The fleet launcher's slot-claim primitive: concurrent
        workers race ``put_if_absent`` on the same claim key and exactly one
        wins. Backends with an atomic create (``DiskFolder`` via link(2),
        ``InMemoryFolder`` under its lock) override this with a genuinely
        atomic version; this default is check-put-readback — best effort
        only, last-writer-wins backends (S3 without conditional puts) can
        double-claim under a tight race."""
        if self.get(key) is not None:
            return False
        self.put(key, blob)
        return self.get(key) == blob

    def state_hash(self, exclude: str | tuple[str, ...] | None = None) -> str:
        """Hash of (key, version) pairs — cheap change detection. ``exclude``
        drops keys (the caller's own deposits: exact keys, or prefixes ending
        in '/') so a client's push does not defeat its own skip check
        (Algorithm 1's hash comparison).

        Default derives versions from blob hashes; backends override with
        cheaper metadata (mtime, etag) when available.
        """
        skip = _exclusion(exclude)
        h = hashlib.sha256()
        for key in sorted(self.keys()):
            if skip is not None and skip(key):
                continue
            blob = self.get(key)
            if blob is not None:
                h.update(key.encode())
                h.update(hashlib.sha256(blob).digest())
        return h.hexdigest()[:16]


class InMemoryFolder(SharedFolder):
    """Thread-safe in-process folder (the paper's simulation backend)."""

    def __init__(self):
        self._blobs: dict[str, bytes] = {}
        self._versions: dict[str, int] = {}
        self._vclock = 0
        self._lock = threading.RLock()

    def put(self, key: str, blob: bytes) -> None:
        with self._lock:
            self._vclock += 1
            self._blobs[key] = blob
            self._versions[key] = self._vclock

    def get(self, key: str) -> bytes | None:
        with self._lock:
            return self._blobs.get(key)

    def keys(self) -> list[str]:
        with self._lock:
            return list(self._blobs.keys())

    def delete(self, key: str) -> None:
        with self._lock:
            # the vclock doubles as the listing token, so deletes must
            # advance it even though the departed key's version is dropped
            if self._blobs.pop(key, None) is not None:
                self._vclock += 1
            self._versions.pop(key, None)

    def version(self, key: str) -> int | None:
        with self._lock:
            return self._versions.get(key)

    def list_version(self) -> int:
        with self._lock:
            return self._vclock

    def put_if_absent(self, key: str, blob: bytes) -> bool:
        with self._lock:
            if key in self._blobs:
                return False
            self._vclock += 1
            self._blobs[key] = blob
            self._versions[key] = self._vclock
            return True

    def state_hash(self, exclude: str | tuple[str, ...] | None = None) -> str:
        skip = _exclusion(exclude)
        with self._lock:
            items = sorted(
                (k, v) for k, v in self._versions.items()
                if skip is None or not skip(k)
            )
        h = hashlib.sha256(repr(items).encode())
        return h.hexdigest()[:16]


class DiskFolder(SharedFolder):
    """Filesystem-backed folder with atomic writes (tmp + rename).

    Safe for multiple processes on a shared mount: readers never observe a
    torn write because rename is atomic on POSIX.
    """

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, key: str) -> str:
        # Percent-encoding is reversible even when the key (a node id, say)
        # itself contains '/', '__', or '%' — '.replace("/", "__")' was not.
        safe = urllib.parse.quote(key, safe="")
        return os.path.join(self.directory, safe + ".npz")

    def put(self, key: str, blob: bytes) -> None:
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
            # Stamp an explicit nanosecond mtime: the filesystem clock can be
            # coarse (1s on NFS), and inode numbers recycle, so without this a
            # rapid same-size rewrite could repeat a version() token and let a
            # CachingFolder serve stale bytes as a hit.
            now = time.time_ns()
            os.utime(tmp, ns=(now, now))
            os.replace(tmp, self._path(key))
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def put_if_absent(self, key: str, blob: bytes) -> bool:
        """Atomic create: write a temp file, then link(2) it to the final
        name — link fails with EEXIST when the name is taken, and it is
        atomic on POSIX filesystems *including NFS* (unlike O_EXCL on NFSv2),
        which is exactly the mount a multi-host fleet shares. This is the
        mutual-exclusion primitive behind fleet slot claims."""
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
            now = time.time_ns()
            os.utime(tmp, ns=(now, now))
            try:
                os.link(tmp, self._path(key))
            except FileExistsError:
                return False
            return True
        finally:
            os.unlink(tmp)

    def get(self, key: str) -> bytes | None:
        path = self._path(key)
        for _ in range(3):  # retry: concurrent replace() can race open()
            try:
                with open(path, "rb") as f:
                    return f.read()
            except FileNotFoundError:
                return None
            except OSError:
                time.sleep(0.01)
        return None

    def keys(self) -> list[str]:
        out = []
        for name in os.listdir(self.directory):
            if name.endswith(".npz"):
                out.append(urllib.parse.unquote(name[: -len(".npz")]))
        return out

    def delete(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except FileNotFoundError:
            pass

    def version(self, key: str) -> tuple[int, int, int] | None:
        try:
            st = os.stat(self._path(key))
        except FileNotFoundError:
            return None
        # put() always replaces via a fresh temp file, so the inode changes on
        # every write — (inode, mtime, size) survives coarse mtime clocks.
        return (st.st_ino, st.st_mtime_ns, st.st_size)

    def list_version(self) -> tuple[int, int, int] | None:
        """Directory stat as the listing token: every put (mkstemp + rename
        into the directory) and delete (unlink) updates the directory's
        mtime/ctime on POSIX. A sub-nanosecond double-write could repeat a
        token, so consumers must only use this where a missed invalidation
        self-heals on the next write (the gossip summary index does)."""
        try:
            st = os.stat(self.directory)
        except FileNotFoundError:
            return None
        return (st.st_mtime_ns, st.st_ctime_ns, st.st_size)

    def state_hash(self, exclude: str | tuple[str, ...] | None = None) -> str:
        skip = _exclusion(exclude)
        items = []
        for name in sorted(os.listdir(self.directory)):
            if not name.endswith(".npz"):
                continue
            if skip is not None and skip(urllib.parse.unquote(name[: -len(".npz")])):
                continue
            path = os.path.join(self.directory, name)
            try:
                st = os.stat(path)
            except FileNotFoundError:
                continue
            # include the inode: a same-size rewrite within one mtime tick on a
            # coarse-timestamp mount must still change the hash (put() always
            # replaces via a fresh temp file)
            items.append((name, st.st_ino, st.st_mtime_ns, st.st_size))
        return hashlib.sha256(repr(items).encode()).hexdigest()[:16]


class S3Folder(SharedFolder):
    """S3-backed folder: not ported yet (ROADMAP Queue 1 item 13a, slice 3)."""

    def __new__(cls, directory: str):
        raise NotImplementedError(
            "S3Folder is not ported yet (ROADMAP Queue 1 item 13a, slice 3); use a local "
            "or mounted path, or memory://")


class CachingFolder(SharedFolder):
    """Read-through cache over any SharedFolder.

    ``get`` first asks the inner backend for the key's cheap ``version`` token
    and returns the locally cached blob when it matches — so a peer whose
    deposit has not changed since the last pull costs one metadata lookup
    instead of a full download. This extends Algorithm 1's whole-store
    state-hash fast path to per-peer granularity, which matters once one slow
    peer would otherwise force re-downloading every fast peer's blob.

    Byte counters (``bytes_fetched`` / ``bytes_saved``) make transport
    experiments measurable. The cache holds at most ``max_entries`` blobs
    (LRU): a long sync federation with ``keep_history`` mints a new
    ``history/...`` key every round, and an unbounded cache would grow with
    the full federation trace.
    """

    def __init__(self, inner: SharedFolder, *, max_entries: int = 64):
        self.inner = inner
        self._cache: "_LruCache" = _LruCache(max_entries)  # key -> (version, blob)
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.bytes_fetched = 0
        self.bytes_saved = 0

    @property
    def max_entries(self) -> int:
        return self._cache.capacity

    @max_entries.setter
    def max_entries(self, value: int) -> None:
        self._cache.capacity = value

    def put(self, key: str, blob: bytes) -> None:
        self.inner.put(key, blob)
        # Invalidate rather than cache: version(key) here could already belong
        # to a concurrent writer's blob, and pairing their token with our bytes
        # would be a *persistent* stale hit. The next get refetches once.
        with self._lock:
            self._cache.pop(key)

    def put_if_absent(self, key: str, blob: bytes) -> bool:
        created = self.inner.put_if_absent(key, blob)
        with self._lock:
            self._cache.pop(key)  # same reasoning as put(): never pre-cache
        return created

    def get(self, key: str) -> bytes | None:
        # Read the version token *before* the blob: if a writer lands between
        # the two reads we may cache a fresh blob under a stale token, which
        # only costs one redundant refetch next time — never a stale hit.
        v = self.inner.version(key)
        if v is not None:
            with self._lock:
                hit = self._cache.get(key)  # refreshes LRU position
                if hit is not None and hit[0] == v:
                    self.hits += 1
                    self.bytes_saved += len(hit[1])
                    return hit[1]
        blob = self.inner.get(key)
        with self._lock:
            self.misses += 1
            if blob is not None:
                self.bytes_fetched += len(blob)
                if v is not None:
                    self._cache.put(key, (v, blob))
        return blob

    def keys(self) -> list[str]:
        return self.inner.keys()

    def delete(self, key: str) -> None:
        self.inner.delete(key)
        with self._lock:
            self._cache.pop(key)

    def version(self, key: str) -> Any | None:
        return self.inner.version(key)

    def list_version(self) -> Any | None:
        return self.inner.list_version()

    def state_hash(self, exclude: str | tuple[str, ...] | None = None) -> str:
        return self.inner.state_hash(exclude=exclude)

    def cache_stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "bytes_fetched": self.bytes_fetched,
                "bytes_saved": self.bytes_saved,
            }


class RetryFolder(SharedFolder):
    """Transient-I/O armor over any SharedFolder: retries ``get``/``put``/
    ``keys`` (and ``version``/``delete``) with capped exponential backoff plus
    jitter when the inner backend raises ``OSError``/``TimeoutError`` — the
    flaky-NFS / object-store blips that would otherwise kill a fleet worker
    mid-round. ``retry+<uri>`` in the folder-URI grammar builds one.

    ``put_if_absent`` is deliberately single-attempt: after an ambiguous
    failure the key may exist with *our* bytes, and a retry would report
    ``False`` for a claim we actually won. Lease/claim writers already treat
    an exception as "not mine" and re-scan, which is safe under at-most-once.

    ``retries`` counts attempts that were retried; ``WeightStore`` folds the
    chain's total into ``PipelineStats.folder_retries`` so it surfaces in
    ``transport_stats()`` next to every other wire counter.
    """

    _RETRYABLE = (OSError, TimeoutError)

    def __init__(self, inner: SharedFolder, *, attempts: int = 4,
                 base_delay: float = 0.05, max_delay: float = 1.0):
        if attempts < 1:
            raise ValueError("attempts must be >= 1")
        self.inner = inner
        self.attempts = attempts
        self.base_delay = base_delay
        self.max_delay = max_delay
        self.retries = 0
        self._lock = threading.Lock()

    def _call(self, fn, *args):
        delay = self.base_delay
        for attempt in range(self.attempts):
            try:
                return fn(*args)
            except self._RETRYABLE:
                if attempt == self.attempts - 1:
                    raise
                with self._lock:
                    self.retries += 1
                # full jitter: sleep U(0, min(cap, base * 2^attempt))
                time.sleep(random.uniform(0.0, min(self.max_delay, delay)))
                delay *= 2.0

    def put(self, key: str, blob: bytes) -> None:
        self._call(self.inner.put, key, blob)

    def put_if_absent(self, key: str, blob: bytes) -> bool:
        return self.inner.put_if_absent(key, blob)  # at-most-once (see class doc)

    def get(self, key: str) -> bytes | None:
        return self._call(self.inner.get, key)

    def keys(self) -> list[str]:
        return self._call(self.inner.keys)

    def delete(self, key: str) -> None:
        self._call(self.inner.delete, key)

    def version(self, key: str) -> Any | None:
        return self._call(self.inner.version, key)

    def list_version(self) -> Any | None:
        return self._call(self.inner.list_version)

    def state_hash(self, exclude: str | tuple[str, ...] | None = None) -> str:
        return self._call(self.inner.state_hash, exclude)


def folder_retries(folder) -> int:
    """Total transient-I/O retries across a folder's wrapper chain (walks
    ``.inner`` links so ``cache+retry+<uri>`` compositions count too)."""
    total = 0
    while folder is not None:
        if isinstance(folder, RetryFolder):
            total += folder.retries
        folder = getattr(folder, "inner", None)
    return total


TRANSPORTS = ("full", "quantized", "delta", "delta_q", "topk")



class WeightStore:
    """Typed view over a SharedFolder: one latest NodeUpdate per node.

    .. note:: New code should open stores through :func:`repro_torch.api.connect`,
       which validates the full URI/transport grammar in one place and picks
       the right store kind per URI. This constructor keeps working unchanged.

    Implements the push / state-hash-check / pull triad from Algorithm 1.
    ``keep_history`` additionally retains per-counter blobs so experiments can
    audit the full federation trace.

    The wire path is a ``TransportPipeline`` (see ``transport.py``) selected
    by ``transport=`` — a legacy name or a pipeline spec string such as::

        "delta(chain=4)|zstd"      # delta-against-delta chains + zstd frames
        "topk(adaptive)"           # error-feedback top-k, k ∝ residual norm
        "quantized|npz"            # int8 blobs inside deflate envelopes

    ``compress=`` ("none" / "npz" / "zstd") appends the envelope stage for
    callers using legacy names. Readers are policy-oblivious: blobs are
    self-describing, so heterogeneous pipelines coexist in one folder.

    ``pull``/``pull_node`` keep a bounded decoded-update cache keyed on the
    folder's per-key ``version`` token, so a peer whose deposit is unchanged
    costs one metadata lookup instead of an npz decode. Decodes land
    *directly in flat host f32 vectors* (``FlatUpdate`` with a shared
    per-structure ``LeafSpec``); blobs whose leaves cannot embed losslessly
    in f32 (int/f64) fall back to the per-leaf tree decode. Cached update
    objects are returned by reference — treat pulled params as read-only.

    ``prefetch_interval`` (or ``start_prefetch()``) runs a background thread
    that warms the decoded-update cache from cheap ``version()`` listings
    between federation steps. Wire counters live on ``pipeline.stats``.
    """

    def __init__(
        self,
        folder: SharedFolder,
        *,
        quantized: bool = False,
        keep_history: bool = False,
        transport: str | None = None,
        families=None,
        rebase_every: int = 10,
        delta_density_threshold: float = 0.5,
        topk_fraction: float = 0.01,
        compress: str = "none",
        decode_cache_entries: int = 64,
        prefetch_interval: float | None = None,
    ):
        # Leaf-family selector sugar: families= builds the family(...) spec
        # (see transport.family_transport_spec) so pushes ship only the named
        # leaf families. An explicit transport= already encodes the policy —
        # passing both would be ambiguous.
        if families is not None:
            if transport is not None:
                raise ValueError("pass families= or transport=, not both")
            transport = family_transport_spec(families)
        self.folder = folder
        self.pipeline = TransportPipeline.from_spec(
            transport,
            quantized=quantized,
            compress=compress,
            rebase_every=rebase_every,
            delta_density_threshold=delta_density_threshold,
            topk_fraction=topk_fraction,
        )
        self.transport = self.pipeline.spec
        self.keep_history = keep_history
        self._ctx = StoreContext(folder, self.pipeline.stats)
        # decoded-update cache: latest/<node> key -> (version token, update).
        # Companion to CachingFolder: that layer skips the *download* of an
        # unchanged blob, this one skips the npz *decode* — keyed on the same
        # cheap folder.version() token. 0 disables.
        self.decode_cache_entries = decode_cache_entries
        self._decoded_latest = _LruCache(decode_cache_entries)
        self._prefetcher: Prefetcher | None = None
        if prefetch_interval is not None:
            self.start_prefetch(prefetch_interval)

    # -- legacy views onto the pipeline --------------------------------------
    @property
    def quantized(self) -> bool:
        return self.pipeline.policy.name == "quantized"

    @property
    def compress(self) -> str:
        return self.pipeline.compress

    @property
    def rebase_every(self) -> int:
        return self.pipeline.policy.rebase_every

    @rebase_every.setter
    def rebase_every(self, value: int) -> None:
        self.pipeline.policy.rebase_every = value

    @property
    def delta_density_threshold(self) -> float:
        return self.pipeline.policy.density_threshold

    @delta_density_threshold.setter
    def delta_density_threshold(self, value: float) -> None:
        self.pipeline.policy.density_threshold = value

    @property
    def topk_fraction(self) -> float:
        return self.pipeline.policy.topk_fraction

    @topk_fraction.setter
    def topk_fraction(self, value: float) -> None:
        self.pipeline.policy.topk_fraction = value

    @property
    def bytes_written(self) -> int:
        return self.pipeline.stats.bytes_written

    @property
    def bytes_read(self) -> int:
        return self.pipeline.stats.bytes_read

    @property
    def decode_hits(self) -> int:
        return self.pipeline.stats.decode_hits

    @property
    def decode_misses(self) -> int:
        return self.pipeline.stats.decode_misses

    def transport_stats(self) -> dict:
        """Every wire counter of this store's pipeline, one dict."""
        retried = folder_retries(self.folder)
        if retried:
            self.pipeline.stats.set_value("folder_retries", retried)
        return self.pipeline.stats.as_dict()

    # -- push ---------------------------------------------------------------
    def push(self, update: NodeUpdate) -> None:
        blob, is_delta = self.pipeline.push(update, self._ctx)
        if self.keep_history:
            if is_delta:
                # history stays self-contained (and, for topk, exact)
                blob = self.pipeline.encode_history(update)
            self._ctx.put(f"history/{update.node_id}/{update.counter:06d}", blob)

    # -- strategy-state recovery blobs ---------------------------------------
    def push_strategy_state(self, node_id: str, strategy: str, counter: int,
                            state: dict) -> None:
        """Persist a node's optimizer state under ``state/<node>`` (riding
        the pipeline's envelope) so a restarted node can resume its server-
        optimizer trajectory, not just its params."""
        blob = serialize_strategy_state(
            node_id, strategy, counter, state,
            compress=self.pipeline.compress)
        self._ctx.put(f"state/{node_id}", blob)

    def pull_strategy_state(self, node_id: str) -> tuple[dict, dict] | None:
        """-> (state arrays, meta) from ``state/<node>``, or None."""
        blob = self._ctx.get(f"state/{node_id}")
        if blob is None:
            return None
        try:
            return deserialize_strategy_state(blob)
        except (ValueError, KeyError):
            return None

    # -- observability blobs --------------------------------------------------
    def attach_telemetry(self, telemetry) -> None:
        """Route this store's folder round-trips and codec work through a
        ``Telemetry`` instance (put/get/encode/decode spans)."""
        self._ctx.telemetry = telemetry

    def push_obs(self, node_id: str, seq: int, payload: dict, *,
                 keep: int | None = None) -> None:
        """Deposit one telemetry snapshot under ``obs/<node>/<seq>``.

        Writes go straight to the folder, not through the pipeline context:
        observability traffic must not skew the wire counters it exists to
        report. ``keep`` bounds the per-node trail — the deposit ``keep``
        sequences back is GC'd with each flush.
        """
        self.folder.put(f"obs/{node_id}/{seq:06d}",
                        serialize_obs_blob(node_id, seq, payload))
        if keep is not None and seq - keep >= 0:
            try:
                self.folder.delete(f"obs/{node_id}/{seq - keep:06d}")
            except OSError:
                _log.debug("obs GC failed for %s seq %d", node_id, seq - keep,
                           exc_info=True)

    def pull_obs(self, node_id: str | None = None) -> list[tuple[str, int, dict]]:
        """All (node_id, seq, payload) telemetry snapshots, seq-ordered."""
        out = []
        for key in sorted(self.folder.keys()):
            if not key.startswith("obs/"):
                continue
            nid, _, _seq = key[len("obs/"):].rpartition("/")
            if node_id is not None and nid != node_id:
                continue
            blob = self.folder.get(key)
            if blob is None:
                continue
            try:
                out.append(deserialize_obs_blob(blob))
            except (ValueError, KeyError):
                continue
        return out

    # -- state hash fast path -------------------------------------------------
    def state_hash(self, exclude_node: str | None = None) -> str:
        # A node's deposits span latest/, base/ + chain/ (delta rebases and
        # chain links) and history/; all of them must be excluded or the
        # node's own push would defeat its own skip check. state/ blobs are
        # optimizer recovery data and fleet/ blobs are launcher control
        # traffic (specs, claims, heartbeats, soak results) and obs/ blobs
        # are telemetry snapshots — none is federation signal, so all are
        # excluded for every node: a heartbeat or telemetry flush landing
        # between two pulls must not trigger a fleet-wide re-pull.
        exclude: tuple[str, ...] = ("state/", "fleet/", "obs/")
        if exclude_node:
            exclude = (
                f"latest/{exclude_node}",
                f"base/{exclude_node}/",
                f"chain/{exclude_node}/",
                f"history/{exclude_node}/",
                "state/",
                "fleet/",
                "obs/",
            )
        return self.folder.state_hash(exclude=exclude)

    # -- pull ---------------------------------------------------------------
    def node_ids(self) -> list[str]:
        return sorted(
            key[len("latest/"):] for key in self.folder.keys() if key.startswith("latest/")
        )

    def _decode(self, blob: bytes, node_id: str) -> NodeUpdate | None:
        """Decode a self-describing blob; None when a delta's reference chain
        cannot be resolved yet (caller refetches — the writer is mid-rebase
        or mid-GC)."""
        return self.pipeline.decode(blob, node_id, self._ctx)

    def _pull_latest(self, node_id: str) -> NodeUpdate | None:
        key = f"latest/{node_id}"
        stats = self.pipeline.stats
        # Version token read BEFORE the blob (same ordering as CachingFolder):
        # a writer landing in between can only cache a fresh update under a
        # stale token — one redundant decode next time, never a stale hit.
        v = self.folder.version(key) if self.decode_cache_entries else None
        if v is not None:
            hit = self._decoded_latest.get(key)  # refreshes LRU position
            if hit is not None and hit[0] == v:
                stats.incr("decode_hits")
                return hit[1]
        for _ in range(3):
            blob = self._ctx.get(key)
            if blob is None:
                return None
            update = self._decode(blob, node_id)
            if update is not None:
                stats.incr("decode_misses")
                if v is not None:
                    self._decoded_latest.put(key, (v, update))
                return update
            time.sleep(0.01)  # writer mid-rebase; refetch latest + bases
        return None

    def pull(self, exclude: str | None = None) -> list[NodeUpdate]:
        """Latest update per node (optionally excluding the caller's own)."""
        out = []
        for node_id in self.node_ids():
            if node_id == exclude:
                continue
            update = self._pull_latest(node_id)
            if update is not None:
                out.append(update)
        return out

    def pull_node(self, node_id: str) -> NodeUpdate | None:
        return self._pull_latest(node_id)

    def pull_round(self, counter: int, exclude: str | None = None) -> list[NodeUpdate]:
        """Exact-round blobs (requires keep_history=True) — used by the
        synchronous barrier so every client aggregates the identical set even
        if a fast peer has already deposited round t+1."""
        prefix = "history/"
        out = []
        for key in sorted(self.folder.keys()):
            if not key.startswith(prefix):
                continue
            # node ids may themselves contain '/' — split the counter off the
            # right instead of assuming exactly three segments.
            node_id, _, ctr = key[len(prefix):].rpartition("/")
            if not ctr.isdigit() or int(ctr) != counter or node_id == exclude:
                continue
            blob = self._ctx.get(key)
            if blob is not None:
                out.append(self._decode(blob, node_id))
        return [u for u in out if u is not None]

    # -- background prefetch --------------------------------------------------
    def warm_cache(self, exclude: str | None = None) -> int:
        """One prefetch sweep: decode every ``latest/`` blob whose cheap
        ``version()`` token is missing from (or stale in) the decoded-update
        cache. Returns how many peers were warmed. Safe to call from a
        background thread concurrently with pulls (all caches are locked)."""
        if not self.decode_cache_entries:
            return 0
        stats = self.pipeline.stats
        warmed = 0
        for node_id in self.node_ids():
            if node_id == exclude:
                continue
            key = f"latest/{node_id}"
            v = self.folder.version(key)
            hit = self._decoded_latest.get(key)
            if v is not None and hit is not None and hit[0] == v:
                continue
            if self._pull_latest(node_id) is not None:
                warmed += 1
        stats.incr("prefetch_cycles")
        stats.incr("prefetched", warmed)
        return warmed

    def start_prefetch(self, interval: float = 0.1, *,
                       exclude: str | None = None) -> Prefetcher:
        """Run ``warm_cache`` on a daemon thread every ``interval`` seconds
        (``exclude`` skips the owning node's own key). Returns the
        ``Prefetcher`` handle; ``stop_prefetch()`` (or handle.stop()) ends
        it."""
        if self._prefetcher is not None:
            self._prefetcher.stop()
        self._prefetcher = Prefetcher(self, interval=interval, exclude=exclude)
        return self._prefetcher

    def stop_prefetch(self) -> None:
        if self._prefetcher is not None:
            self._prefetcher.stop()
            self._prefetcher = None

    def clear(self) -> None:
        for key in self.folder.keys():
            self.folder.delete(key)
        self.pipeline.reset()
        self._ctx.clear()
        self._decoded_latest.clear()


_MEMORY_REGISTRY: dict[str, "InMemoryFolder"] = {}
_MEMORY_REGISTRY_LOCK = threading.Lock()


def make_folder(uri: str):
    """Folder factory: 'memory://', 's3://bucket/prefix', a local path, or any
    of those behind a read-through cache via a 'cache+' prefix
    (e.g. 'cache+/mnt/shared/exp1', 'cache+s3://bucket/exp1') and/or a
    transient-I/O retry layer via a 'retry+' prefix
    (e.g. 'retry+/mnt/flaky-nfs/exp1', 'cache+retry+s3://bucket/exp1').

    Bare 'memory://' mints a fresh anonymous folder per call; a named
    'memory://<name>' resolves through a process-global registry, so every
    store connected to the same name shares one folder — the in-process
    analogue of a shared mount (what the serving tier and multi-store tests
    rely on).

    The URI grammar is the folder-side half of the transport spec grammar;
    ``transport.parse_folder_uri`` owns the parse. Wrappers apply
    outermost-first: 'cache+retry+<base>' caches over the retrying folder.

    A 'shard<G>+<uri>' prefix returns a ``ShardedFolders`` handle — G
    per-group folders of the inner kind (e.g. 'shard16+/mnt/shared/exp1') —
    which the federated nodes turn into a gossip-sharded
    ``ShardedWeightStore``; 'shard<G>x<L>+<uri>' federates the G groups
    through an L-level summary tree. ``s3://`` is not ported yet (ROADMAP
    Queue 1 item 13a) and raises ``NotImplementedError``.

    .. note:: Most callers want :func:`repro_torch.api.connect`, which wraps
       this factory and returns a ready store for any URI.
    """
    wrappers, base = parse_folder_uri(uri)
    for i, (name, _args) in enumerate(wrappers):
        if name == "shard":
            if i != 0:
                raise ValueError(
                    f"shard<G>+ must be the outermost wrapper in {uri!r}")
            if any(n == "shard" for n, _ in wrappers[1:]):
                raise ValueError(
                    f"shard<G>+ may appear only once in {uri!r}")
            from .gossip import ShardedFolders  # circular-import guard

            return ShardedFolders.from_uri(uri)
    if base.startswith("memory://"):
        name = base[len("memory://"):].strip("/")
        if name:
            with _MEMORY_REGISTRY_LOCK:
                folder: SharedFolder = _MEMORY_REGISTRY.setdefault(
                    name, InMemoryFolder())
        else:
            folder = InMemoryFolder()
    elif base.startswith("s3://"):
        folder = S3Folder(base[len("s3://"):])
    else:
        folder = DiskFolder(base)
    # innermost wrapper wraps first, so the leftmost prefix ends up outermost
    for name, _args in reversed(wrappers):
        folder = RetryFolder(folder) if name == "retry" else CachingFolder(folder)
    return folder
