"""Composable transport pipeline — the weight store's wire layer.

The port of ``repro.core.transport``. Everything that turns a ``NodeUpdate``
into deposited bytes (and back) lives here, behind one seam:

  * A ``Codec`` owns one wire *policy*. Wire blobs are self-describing
    (``delta_of`` / ``quantized`` meta), so readers dispatch on the blob, not
    on the local codec stack, and fleets can mix pipelines — and packages.
  * A ``TransportPipeline`` is built from one spec string, e.g.
    ``"quantized|zstd"``. The same grammar drives folder-URI routing
    (``cache+``, ``retry+``, ``shard<G>+``) via ``parse_folder_uri``.
  * ``PipelineStats`` carries every wire counter.

Spec grammar (ported whole, so every spec the reference accepts validates
here too)::

    pipeline  := stage ("|" stage)*
    stage     := name | name "(" args ")"
    args      := arg ("," arg)*
    arg       := key "=" value | flag          # e.g. chain=4, q, adaptive

    policy stages : full | quantized | delta(chain=<int>, q, rebase=<int>)
                    | topk(adaptive, fraction=<float>)
                    | family(<name>=<sub-policy>, ...)
    envelope      : npz | zstd                 # at most one, always last

    uri       := (wrapper "+")* base   # wrapper: cache | retry | shard<G>[x<L>]
    base      := path | memory:// | s3://bucket/prefix

Every policy of the reference is here, with both envelopes: ``full``,
``quantized``, ``delta`` (chains, ``q``, rebases), error-feedback ``topk``
(adaptive) and ``family``. A delta blob decodes the same in either package;
one whose chain cannot be resolved decodes to ``None`` (the caller refetches),
never to stale parameters.
"""
from __future__ import annotations

import re
import threading
from typing import Any

import numpy as np

from .serialize import (
    FlatDecodeUnsupported,
    NodeUpdate,
    apply_update_delta_flat,
    canonicalize_params,
    content_hash,
    decode_params_flat,
    deserialize_update,
    deserialize_update_delta,
    deserialize_update_delta_flat,
    deserialize_update_quantized,
    flat_update_from_meta,
    maybe_decompress,
    peek_meta,
    serialize_group_summary,
    serialize_super_summary,
    serialize_update,
    serialize_update_delta,
    serialize_update_delta_from_flat,
    serialize_update_quantized,
)
from .telemetry import child_span
from .tree import LeafSpec, tree_size_bytes
from repro_torch.logs import get_logger

_log = get_logger("transport")

# cycle/corruption guard on the reader's chain walk; far above any real
# ``chain=`` bound (writers re-anchor long before this)
_MAX_RESOLVE_HOPS = 64


class _LruCache:
    """Tiny insertion-ordered LRU (dict-backed), internally locked: stores
    are shared across threads and the prefetch thread races pulls."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._data: dict = {}
        self._lock = threading.Lock()

    def get(self, key):
        """Value for ``key`` (refreshing its LRU position), else None."""
        with self._lock:
            hit = self._data.get(key)
            if hit is not None:
                self._data.pop(key, None)
                self._data[key] = hit
            return hit

    def put(self, key, value) -> None:
        with self._lock:
            self._data.pop(key, None)
            self._data[key] = value
            while len(self._data) > self.capacity:
                self._data.pop(next(iter(self._data)))

    def pop(self, key) -> None:
        with self._lock:
            self._data.pop(key, None)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()

    def __len__(self) -> int:
        return len(self._data)


# --------------------------------------------------------------------------
# Spec grammar — one parser for transport pipelines AND folder URIs
# --------------------------------------------------------------------------

_STAGE_RE = re.compile(r"^([A-Za-z_][\w]*)\s*(?:\((.*)\))?$", re.DOTALL)
# ``shard<G>+<uri>`` — G node groups; ``shard<G>x<L>+<uri>`` — an L-level tree
_SHARD_RE = re.compile(r"^shard(\d+)(?:x(\d+))?\+(.+)$", re.DOTALL)

_POLICIES = ("full", "quantized", "delta", "topk", "family")
_ENVELOPES = ("npz", "zstd")

# legacy transport names → pipeline specs (wire output byte-identical)
LEGACY_TRANSPORTS = {
    "full": "full",
    "quantized": "quantized",
    "delta": "delta",
    "delta_q": "delta(q)",
    "topk": "topk",
}


def _split_top(text: str, sep: str) -> list[str]:
    """Split on ``sep`` at paren depth 0 only."""
    parts: list[str] = []
    depth = 0
    cur: list[str] = []
    for ch in text:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth < 0:
                raise ValueError(f"unbalanced parentheses in {text!r}")
        if ch == sep and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if depth != 0:
        raise ValueError(f"unbalanced parentheses in {text!r}")
    parts.append("".join(cur))
    return parts


def parse_stage(text: str) -> tuple[str, dict]:
    """``"delta(chain=4,q)"`` → ``("delta", {"chain": "4", "q": True})``."""
    m = _STAGE_RE.match(text.strip())
    if not m:
        raise ValueError(f"malformed transport stage {text!r}")
    name = m.group(1).lower()
    args: dict = {}
    body = m.group(2)
    if body is not None and body.strip():
        for part in _split_top(body, ","):
            part = part.strip()
            if not part:
                raise ValueError(f"malformed arguments in stage {text!r}")
            if "=" in part:
                k, _, v = part.partition("=")
                args[k.strip()] = v.strip()
            else:
                args[part] = True
    return name, args


def parse_pipeline_spec(spec: str) -> list[tuple[str, dict]]:
    """Split a pipeline spec into ``(stage name, args)`` tuples."""
    if not isinstance(spec, str) or not spec.strip():
        raise ValueError(f"empty transport spec {spec!r}")
    return [parse_stage(part) for part in _split_top(spec, "|")]


def _int_arg(args: dict, key: str, default: int | None, stage: str) -> int | None:
    v = args.get(key)
    if v is None:
        return default
    try:
        out = int(v)
    except (TypeError, ValueError):
        raise ValueError(f"{stage}: {key}= wants an integer, got {v!r}") from None
    return out


def _validate_stages(stages: list[tuple[str, dict]]) -> tuple[tuple[str, dict], str]:
    """-> ((policy name, normalized policy args), envelope name or 'none').
    Raises ValueError on anything the registry does not know."""
    policy: list[tuple[str, dict]] = []
    envelope = "none"
    for i, (name, args) in enumerate(stages):
        if name in _ENVELOPES:
            if i != len(stages) - 1:
                raise ValueError(
                    f"envelope stage {name!r} must be the last pipeline stage")
            envelope = name
        elif name in _POLICIES:
            policy.append((name, dict(args)))
        else:
            known = ", ".join(sorted(_POLICIES + _ENVELOPES))
            raise ValueError(f"unknown transport stage {name!r}; known: {known}")
    if not policy:
        raise ValueError("transport spec needs a policy stage "
                         f"(one of {', '.join(_POLICIES)})")
    # ``topk|delta`` is the explicit form of ``topk``; any other policy
    # stacking is an error.
    if policy[0][0] == "topk" and len(policy) == 2:
        dn, dargs = policy[1]
        if dn != "delta" or dargs:
            raise ValueError(
                "topk implies its own delta encoding; only a bare '|delta' "
                f"may follow it (got {dn!r} with args {dargs})")
        policy = policy[:1]
    if len(policy) > 1:
        raise ValueError("at most one policy stage per pipeline "
                         "(topk|delta being the one legal stack)")
    name, args = policy[0]
    if name in ("full", "quantized"):
        if args:
            raise ValueError(f"{name} takes no arguments (got {args})")
        return (name, {}), envelope
    if name == "family":
        if not args:
            raise ValueError(
                "family(...) needs at least one <name>=<sub-policy> argument")
        fams: dict[str, str] = {}
        for fam, sub in args.items():
            sub_spec = "full" if sub is True else str(sub)
            try:
                (sub_name, sub_args), sub_env = _validate_stages(
                    parse_pipeline_spec(sub_spec))
            except ValueError as e:
                raise ValueError(
                    f"family: bad sub-spec for {fam!r}: {e}") from None
            if sub_name not in ("full", "quantized", "delta"):
                raise ValueError(
                    f"family: {fam!r} sub-policy must be full, quantized or "
                    f"delta (got {sub_name!r})")
            if sub_name == "delta" and (sub_args.get("chain", 1) != 1
                                        or sub_args.get("q")
                                        or "rebase" in sub_args):
                raise ValueError(
                    f"family: {fam!r} takes a bare 'delta' (chain/q/rebase "
                    "are whole-pipeline knobs, not per-family ones)")
            if sub_env != "none":
                # a per-family envelope token hoists to the whole blob, and
                # every such token must agree
                if envelope not in ("none", sub_env):
                    raise ValueError(
                        f"family: {fam!r} asks for envelope {sub_env!r} but "
                        f"the pipeline already carries {envelope!r}")
                envelope = sub_env
            fams[fam] = sub_name
        return ("family", {"families": fams}), envelope
    if name == "delta":
        unknown = set(args) - {"chain", "q", "rebase"}
        if unknown:
            raise ValueError(f"delta: unknown arguments {sorted(unknown)}")
        chain = _int_arg(args, "chain", 1, "delta")
        if chain < 1:
            raise ValueError(f"delta: chain must be >= 1, got {chain}")
        rebase = _int_arg(args, "rebase", None, "delta")
        if rebase is not None and rebase < 1:
            raise ValueError(f"delta: rebase must be >= 1, got {rebase}")
        quantize = bool(args.get("q", False))
        if quantize and chain > 1:
            raise ValueError(
                "delta: chains require lossless reconstruction — q (int8 "
                "values) cannot be combined with chain > 1")
        out = {"chain": chain, "q": quantize}
        if rebase is not None:
            out["rebase"] = rebase
        return (name, out), envelope
    # topk
    out = {"adaptive": False, "fraction": None}
    for k, v in args.items():
        if k == "adaptive" and v is True:
            out["adaptive"] = True
        elif k == "fraction":
            out["fraction"] = float(v)
        else:
            # a bare float flag is shorthand for fraction=
            try:
                out["fraction"] = float(k) if v is True else float("nan")
            except ValueError:
                out["fraction"] = float("nan")
            if not np.isfinite(out["fraction"]):
                raise ValueError(f"topk: unknown argument {k!r}") from None
    if out["fraction"] is not None and not 0.0 < out["fraction"] <= 1.0:
        raise ValueError(f"topk: fraction must be in (0, 1], got {out['fraction']}")
    return ("topk", out), envelope


def _canonical(policy: tuple[str, dict], envelope: str) -> str:
    name, args = policy
    rendered = []
    if name == "delta":
        if args.get("chain", 1) != 1:
            rendered.append(f"chain={args['chain']}")
        if args.get("q"):
            rendered.append("q")
        if "rebase" in args:
            rendered.append(f"rebase={args['rebase']}")
    elif name == "topk":
        if args.get("adaptive"):
            rendered.append("adaptive")
        if args.get("fraction") is not None:
            rendered.append(f"fraction={args['fraction']:g}")
    elif name == "family":
        rendered.extend(
            f"{fam}={sub}" for fam, sub in sorted(args["families"].items()))
    spec = f"{name}({','.join(rendered)})" if rendered else name
    return spec if envelope == "none" else f"{spec}|{envelope}"


def normalize_transport(transport: str | None = None, *, quantized: bool = False,
                        compress: str = "none") -> str:
    """Legacy name or pipeline spec → canonical pipeline spec (what two specs
    are compared by)."""
    if transport is None:
        transport = "quantized" if quantized else "full"
    transport = LEGACY_TRANSPORTS.get(transport, transport)
    policy, envelope = _validate_stages(parse_pipeline_spec(transport))
    if compress not in ("none", "npz", "zstd"):
        raise ValueError(f"unknown compress {compress!r}; options: "
                         "('none', 'npz', 'zstd')")
    if compress != "none":
        if envelope != "none" and envelope != compress:
            raise ValueError(
                f"spec {transport!r} already carries envelope {envelope!r}; "
                f"conflicting compress={compress!r}")
        envelope = compress
    return _canonical(policy, envelope)


def family_transport_spec(families, default: str = "full") -> str:
    """Leaf-family selector → canonical ``family(...)`` spec string."""
    if isinstance(families, str):
        families = (families,)
    if hasattr(families, "items"):
        fams = {str(k): str(v) for k, v in families.items()}
    else:
        fams = {str(name): default for name in families}
    if not fams:
        raise ValueError("family selector needs at least one family name")
    return normalize_transport(
        "family(" + ",".join(f"{k}={v}" for k, v in sorted(fams.items())) + ")")


def parse_folder_uri(uri: str) -> tuple[list[tuple[str, dict]], str]:
    """Folder-URI side of the grammar: ``"shard8+cache+/mnt/x"`` →
    ``([("shard", {"groups": 8, "levels": 1}), ("cache", {})], "/mnt/x")``.
    Wrappers apply outermost-first; the base URI is whatever remains."""
    wrappers: list[tuple[str, dict]] = []
    while True:
        m = _SHARD_RE.match(uri)
        if m:
            levels = int(m.group(2)) if m.group(2) is not None else 1
            if levels < 1:
                raise ValueError(
                    f"shard<G>x<L>+ needs L >= 1, got {levels} in {uri!r}")
            wrappers.append(("shard", {"groups": int(m.group(1)),
                                       "levels": levels}))
            uri = m.group(3)
            continue
        if uri.startswith("cache+"):
            wrappers.append(("cache", {}))
            uri = uri[len("cache+"):]
            continue
        if uri.startswith("retry+"):
            wrappers.append(("retry", {}))
            uri = uri[len("retry+"):]
            continue
        return wrappers, uri


# --------------------------------------------------------------------------
# Per-pipeline stats
# --------------------------------------------------------------------------


class PipelineStats:
    """Every wire counter one transport pipeline accumulates (the reference's
    field set, so telemetry payloads keep their schema). Mutations go through
    ``incr``/``set_value``/``record_max`` under one lock: the node thread and
    the prefetch thread bump them concurrently."""

    _INT_FIELDS = (
        "bytes_written", "bytes_read", "encodes", "decodes",
        "decode_hits", "decode_misses", "rebases", "reanchors",
        "chain_depth", "max_chain_depth", "resolve_hops", "max_resolve_hops",
        "topk_k", "prefetch_cycles", "prefetched", "folder_retries",
        "summary_index_hits", "summary_index_misses",
    )
    _FLOAT_FIELDS = ("residual_norm", "topk_fraction_effective")

    def __init__(self):
        self._lock = threading.Lock()
        self._zero()

    def _zero(self) -> None:
        for f in self._INT_FIELDS:
            setattr(self, f, 0)
        for f in self._FLOAT_FIELDS:
            setattr(self, f, 0.0)

    def incr(self, field: str, n: int | float = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def set_value(self, field: str, value: int | float) -> None:
        with self._lock:
            setattr(self, field, value)

    def record_max(self, field: str, value: int | float) -> None:
        with self._lock:
            if value > getattr(self, field):
                setattr(self, field, value)

    def as_dict(self) -> dict[str, int | float]:
        with self._lock:
            return {f: getattr(self, f)
                    for f in self._INT_FIELDS + self._FLOAT_FIELDS}

    def reset(self) -> None:
        # zero in place under the existing lock — never swap the lock
        with self._lock:
            self._zero()


class StoreContext:
    """The folder handle codecs read and write through: every byte that
    crosses it is counted on the pipeline's stats, and the shared reader
    caches (interned LeafSpecs, decoded base and chain states) live here so
    the write side, the read side and the prefetch thread share one view."""

    def __init__(self, folder, stats: PipelineStats, *,
                 decoded_base_entries: int = 32):
        self.folder = folder
        self.stats = stats
        # attached by the owning store (``attach_telemetry``): its spans take
        # the folder round-trips and codec work done where no span is open on
        # the calling thread (a prefetch thread); under an open span they are
        # that span's children (``telemetry.child_span``)
        self.telemetry = None
        # interned LeafSpecs: one per decoded structure
        self.specs: dict = {}
        # blob content hash -> (spec, flat) | (None, tree params): decoded
        # full bases AND reconstructed chain states (a chain link's hash
        # names the exact state it reconstructs to)
        self.decoded_bases = _LruCache(decoded_base_entries)

    def put(self, key: str, blob: bytes) -> None:
        with child_span("put", self.telemetry):
            self.folder.put(key, blob)
        self.stats.incr("bytes_written", len(blob))

    def get(self, key: str) -> bytes | None:
        with child_span("get", self.telemetry):
            blob = self.folder.get(key)
        if blob is not None:
            self.stats.incr("bytes_read", len(blob))
        return blob

    def delete(self, key: str) -> None:
        self.folder.delete(key)

    def keys(self) -> list[str]:
        return self.folder.keys()

    def clear(self) -> None:
        self.specs.clear()
        self.decoded_bases.clear()


# --------------------------------------------------------------------------
# Codecs
# --------------------------------------------------------------------------


def _deposit_base(update: NodeUpdate, ctx: StoreContext, *, compress: str,
                  old_hash: str | None, old_chain_keys: list[str],
                  stats: PipelineStats) -> tuple[bytes, str]:
    """Rebase: deposit a full blob under base/<node>/<hash> AND latest/, then
    GC superseded bases and chain links. Shared by the delta, topk and family
    codecs."""
    node = update.node_id
    full = serialize_update(update, compress=compress)
    h = content_hash(full)
    # Base first, then latest: a reader that sees the new latest can always
    # resolve its base. Old bases and links go only after the new latest is in
    # place (readers of the old delta retry into the new blob).
    ctx.put(f"base/{node}/{h}", full)
    ctx.put(f"latest/{node}", full)
    if old_hash is not None:
        if old_hash != h:
            ctx.delete(f"base/{node}/{old_hash}")
        for key in old_chain_keys:
            ctx.delete(key)
    else:
        # first rebase in this process: sweep what an earlier incarnation of
        # this node left. Keys split from the right: node ids may contain '/',
        # so a plain startswith would cross node borders.
        for key in ctx.keys():
            prefix = key.rpartition("/")[0]
            if prefix == f"base/{node}" and key != f"base/{node}/{h}":
                ctx.delete(key)
            elif prefix == f"chain/{node}":
                ctx.delete(key)
    stats.incr("rebases")
    return full, h


class Codec:
    """One wire policy. ``encode`` owns the write side (side deposits, bases
    and chain links, and their GC included); the read side is the static
    ``decode_wire`` hooks, dispatched on the blob's own meta by
    ``TransportPipeline.decode``."""

    name = "codec"

    def __init__(self, *, compress: str = "none", stats: PipelineStats | None = None,
                 rebase_every: int = 10, density_threshold: float = 0.5,
                 topk_fraction: float = 0.01):
        self.compress = compress
        self.stats = stats if stats is not None else PipelineStats()
        self.rebase_every = rebase_every
        self.density_threshold = density_threshold
        self.topk_fraction = topk_fraction

    def encode(self, update: NodeUpdate, ctx: StoreContext) -> tuple[bytes, bool]:
        """Deposit ``update`` under latest/<node>; -> (blob, is_delta)."""
        raise NotImplementedError

    def reset(self) -> None:
        """Drop per-node writer state (store.clear)."""


class FullCodec(Codec):
    name = "full"

    def encode(self, update: NodeUpdate, ctx: StoreContext) -> tuple[bytes, bool]:
        blob = serialize_update(update, compress=self.compress)
        ctx.put(f"latest/{update.node_id}", blob)
        return blob, False

    @staticmethod
    def decode_wire(blob: bytes, meta: dict, ctx: StoreContext) -> NodeUpdate:
        try:
            spec, flat, m = decode_params_flat(blob, ctx.specs)
            return flat_update_from_meta(spec, flat, m)
        except FlatDecodeUnsupported:
            return deserialize_update(blob)


class QuantizedCodec(Codec):
    name = "quantized"

    def encode(self, update: NodeUpdate, ctx: StoreContext) -> tuple[bytes, bool]:
        blob = serialize_update_quantized(update, compress=self.compress)
        ctx.put(f"latest/{update.node_id}", blob)
        return blob, False

    @staticmethod
    def decode_wire(blob: bytes, meta: dict, ctx: StoreContext) -> NodeUpdate:
        try:
            spec, flat, m = decode_params_flat(blob, ctx.specs)
            return flat_update_from_meta(spec, flat, m)
        except FlatDecodeUnsupported:
            return deserialize_update_quantized(blob)


class _ChainState:
    """Writer-side view of one node's delta chain. ``prev_flat`` is the state
    a reader reconstructs from the current latest blob (hash ``prev_hash``);
    ``anchor_*`` is the content-hashed full base the chain re-anchors to.
    ``depth`` counts the delta applications a fresh reader needs (0: latest
    IS the anchor); ``segment_keys`` are the chain/ links deposited since the
    last re-anchor (GC'd when the next re-anchor supersedes them)."""

    __slots__ = ("anchor_hash", "spec", "anchor_flat", "prev_hash", "prev_flat",
                 "depth", "age", "segment_keys")

    def __init__(self, anchor_hash: str, spec: LeafSpec, anchor_flat: np.ndarray):
        self.anchor_hash = anchor_hash
        self.spec = spec
        self.anchor_flat = anchor_flat
        self.prev_hash = anchor_hash
        self.prev_flat = anchor_flat
        self.depth = 0
        self.age = 0
        self.segment_keys: list[str] = []


class DeltaCodec(Codec):
    """Sparse deltas against a content-hashed base, with optional
    delta-against-delta *chains* (``chain > 1``).

    chain == 1: every push diffs against the anchor base. chain == K: each
    push diffs against the *previous pushed state*, so its bytes track one
    step's sparsity, while a fresh reader rebuilds at most K links: a link
    that would reach depth K+1 re-anchors with a depth-1 delta against the
    base. Links are content-addressed under ``chain/<node>/<hash>``; a link
    that will never be referenced again is not deposited, or is deleted.

    ``q`` (int8 changed values) and trees that do not embed exactly in f32
    (int/f64 leaves) take the per-leaf tree path, which never chains. The
    diffs run on the host in numpy, as the reference's do, so both packages
    ship the same entries."""

    name = "delta"

    def __init__(self, *, chain: int = 1, quantize: bool = False, **kw):
        super().__init__(**kw)
        if chain < 1:
            raise ValueError(f"chain must be >= 1, got {chain}")
        if quantize and chain > 1:
            raise ValueError("chained deltas require lossless values (no q)")
        self.chain = chain
        self.quantize = quantize
        # flat-path chain state and tree-path base state, per node; a node
        # lives in exactly one of the two (structure changes migrate it)
        self._chains: dict[str, _ChainState] = {}
        self._tree_bases: dict[str, tuple[str, Any, int]] = {}

    def reset(self) -> None:
        self._chains.clear()
        self._tree_bases.clear()

    # -- write side ----------------------------------------------------------
    def encode(self, update: NodeUpdate, ctx: StoreContext) -> tuple[bytes, bool]:
        node = update.node_id
        if self.quantize:
            return self._encode_tree(update, ctx)
        st = self._chains.get(node)
        spec = st.spec if st is not None else None
        if spec is not None and not spec.describes(update.params):
            spec, st = None, None
        if spec is None:
            spec = LeafSpec.of(update.params)
        if not spec.f32_exact:
            return self._encode_tree(update, ctx)
        self._tree_bases.pop(node, None)
        new_flat = None
        if st is not None and st.age < self.rebase_every:
            try:
                new_flat = spec.flatten(update.params)
            except ValueError:  # shape drift under the same structure → rebase
                new_flat = None
            if new_flat is not None:
                blob, depth = self._encode_link(update, spec, new_flat, st)
                # a delta no smaller than a full deposit rebases instead (a
                # trainer that moves every weight rebases on every push)
                if len(blob) < tree_size_bytes(update.params):
                    self._deposit_link(node, blob, depth, st, new_flat, ctx)
                    return blob, True
        full, h = _deposit_base(
            update, ctx, compress=self.compress,
            old_hash=st.anchor_hash if st is not None else None,
            old_chain_keys=st.segment_keys if st is not None else [],
            stats=self.stats)
        if new_flat is None:
            new_flat = spec.flatten(update.params)
        self._chains[node] = _ChainState(h, spec, new_flat)
        self.stats.set_value("chain_depth", 0)
        return full, False

    def _encode_link(self, update, spec, new_flat, st) -> tuple[bytes, int]:
        if st.depth < self.chain:
            ref_hash, ref_flat, depth = st.prev_hash, st.prev_flat, st.depth + 1
        else:  # bound hit: re-anchor against the content-hashed base
            ref_hash, ref_flat, depth = st.anchor_hash, st.anchor_flat, 1
        extra = {"chain_depth": depth} if self.chain > 1 else None
        blob = serialize_update_delta_from_flat(
            update, spec, new_flat, ref_flat, ref_hash,
            density_threshold=self.density_threshold,
            compress=self.compress, extra_meta=extra)
        return blob, depth

    def _deposit_link(self, node, blob, depth, st, new_flat, ctx) -> None:
        bh = content_hash(blob)
        retire: list[str] = []
        if depth == 1 and st.segment_keys:
            # re-anchor: the previous segment's links are unreachable from
            # the new latest; retire them once it is in place
            retire, st.segment_keys = st.segment_keys, []
            self.stats.incr("reanchors")
        if self.chain > 1 and depth < self.chain:
            # the next link references this blob by hash: make it addressable
            # BEFORE latest/ points at it (a link at the depth bound is never
            # referenced, since its successor re-anchors)
            key = f"chain/{node}/{bh}"
            ctx.put(key, blob)
            st.segment_keys.append(key)
        ctx.put(f"latest/{node}", blob)
        for key in retire:
            ctx.delete(key)
        st.prev_hash, st.prev_flat, st.depth = bh, new_flat, depth
        st.age += 1
        self.stats.set_value("chain_depth", depth)
        self.stats.record_max("max_chain_depth", depth)

    def _encode_tree(self, update: NodeUpdate, ctx: StoreContext) -> tuple[bytes, bool]:
        """Per-leaf lossless or quantized path (no chains)."""
        node = update.node_id
        self._chains.pop(node, None)
        base = self._tree_bases.get(node)
        if base is not None and base[2] < self.rebase_every:
            h, base_params, age = base
            try:
                blob = serialize_update_delta(
                    update, base_params, h, quantize=self.quantize,
                    density_threshold=self.density_threshold,
                    compress=self.compress)
            except ValueError:  # tree structure changed vs the base → rebase
                blob = None
            if blob is not None and len(blob) < tree_size_bytes(update.params):
                ctx.put(f"latest/{node}", blob)
                self._tree_bases[node] = (h, base_params, age + 1)
                return blob, True
        full, h = _deposit_base(
            update, ctx, compress=self.compress,
            old_hash=base[0] if base is not None else None,
            old_chain_keys=[], stats=self.stats)
        self._tree_bases[node] = (h, canonicalize_params(update.params), 0)
        return full, False

    # -- read side -----------------------------------------------------------
    @staticmethod
    def resolve_state(node_id: str, base_hash: str, ctx: StoreContext):
        """Reconstruct the state a ``delta_of`` reference names: the full base
        blob, or a chain link applied on its own recursively resolved
        predecessor. -> (spec, flat) | (None, tree params) | None when a hop
        cannot be resolved (writer mid-rebase or mid-GC: the caller
        refetches). Each reconstructed state is cached by its blob hash, so a
        steady reader resolves each new link in one application."""
        pending: list[tuple[str, bytes]] = []
        cur = base_hash
        state = None
        while True:
            state = ctx.decoded_bases.get(cur)
            if state is not None:
                break
            raw = ctx.get(f"base/{node_id}/{cur}")
            # hash the RAW fetched bytes: writers hash what they deposit
            if raw is not None and content_hash(raw) == cur:
                blob = maybe_decompress(raw)
                try:
                    spec, flat, _ = decode_params_flat(blob, ctx.specs)
                    state = (spec, flat)
                except FlatDecodeUnsupported:
                    state = (None, deserialize_update(blob).params)
                ctx.decoded_bases.put(cur, state)
                break
            raw = ctx.get(f"chain/{node_id}/{cur}")
            if raw is None or content_hash(raw) != cur:
                return None
            blob = maybe_decompress(raw)
            prev = peek_meta(blob).get("delta_of")
            if not prev or len(pending) >= _MAX_RESOLVE_HOPS:
                return None
            pending.append((cur, blob))
            cur = prev
        hops = len(pending)
        if hops:
            spec, base_state = state
            resolved = None
            if spec is not None:
                # one base copy, every link applied in place: a K-hop walk
                # costs one copy plus K sparse scatters
                flat = np.array(base_state, dtype=np.float32, copy=True)
                try:
                    for _bh, blob in reversed(pending):
                        apply_update_delta_flat(blob, spec, flat)
                    resolved = (spec, flat)
                except (FlatDecodeUnsupported, ValueError):
                    resolved = None  # odd dtypes or drift: per-hop fallback
            if resolved is None:
                for _bh, blob in reversed(pending):
                    state = DeltaCodec._apply(blob, state)
                    if state is None:
                        return None
                resolved = state
            # cache only the walked-to state: writers only chain forward
            ctx.decoded_bases.put(pending[0][0], resolved)
            state = resolved
        ctx.stats.set_value("resolve_hops", hops)
        ctx.stats.record_max("max_resolve_hops", hops)
        return state

    @staticmethod
    def _apply(blob: bytes, state):
        """Apply one (decompressed) delta blob on a resolved state."""
        spec, base_state = state
        if spec is not None:
            try:
                upd = deserialize_update_delta_flat(blob, spec, base_state)
                return (spec, upd.flat)
            except ValueError:  # odd-dtype values or structure drift: tree path
                pass
            base_state = spec.unflatten(base_state)
        try:
            return (None, deserialize_update_delta(blob, base_state).params)
        except Exception:
            return None

    @staticmethod
    def decode_wire(blob: bytes, meta: dict, ctx: StoreContext,
                    node_id: str, raw_hash: str | None = None) -> NodeUpdate | None:
        state = DeltaCodec.resolve_state(node_id, meta["delta_of"], ctx)
        if state is None:
            return None
        spec, base_state = state
        if spec is not None:
            try:
                upd = deserialize_update_delta_flat(blob, spec, base_state)
                if raw_hash is not None:
                    # the writer's next link may reference this very blob
                    ctx.decoded_bases.put(raw_hash, (spec, upd.flat))
                return upd
            except ValueError:  # FlatDecodeUnsupported included: tree path
                pass
            base_state = spec.unflatten(base_state)
        return deserialize_update_delta(blob, base_state)


class TopKCodec(Codec):
    """Error-feedback top-k on host flat vectors. The writer tracks ``acc``,
    the state readers reconstruct (base + every shipped change). Each push
    ships the top-k largest entries of ``new - acc``; the rest stays in the
    residual and drains in later pushes. The wire format is an ordinary delta
    blob against the content-hashed base.

    Selection is ``np.argpartition`` on the host f32 residual, exactly as in
    the reference: ``torch.topk`` breaks ties otherwise, and a mixed fleet
    would then ship different entries.

    ``adaptive=True`` scales k to the measured residual norm: the shipped
    fraction is ``fraction * (r / ema(r))`` clipped to ``[fraction/8,
    8*fraction]``, r = ‖new − acc‖₂ / ‖new‖₂. Trees that do not embed in f32
    rebase on every push."""

    name = "topk"

    def __init__(self, *, adaptive: bool = False, **kw):
        super().__init__(**kw)
        self.adaptive = adaptive
        # node -> (base_hash, spec, base_flat, acc_flat, age)
        self._state: dict[str, tuple] = {}
        self._ema: dict[str, float] = {}  # residual-norm EMA (adaptive mode)

    def reset(self) -> None:
        self._state.clear()
        self._ema.clear()

    def _fraction_for(self, node: str, new_flat: np.ndarray, v: np.ndarray) -> float:
        rn = float(np.linalg.norm(v))
        self.stats.set_value("residual_norm", rn)
        if not self.adaptive:
            self.stats.set_value("topk_fraction_effective", self.topk_fraction)
            return self.topk_fraction
        rel = rn / (float(np.linalg.norm(new_flat)) + 1e-12)
        ema = self._ema.get(node, rel)
        frac = self.topk_fraction * rel / max(ema, 1e-12)
        frac = min(max(frac, self.topk_fraction / 8.0),
                   min(1.0, 8.0 * self.topk_fraction))
        self._ema[node] = 0.7 * ema + 0.3 * rel
        self.stats.set_value("topk_fraction_effective", frac)
        return frac

    def encode(self, update: NodeUpdate, ctx: StoreContext) -> tuple[bytes, bool]:
        node = update.node_id
        state = self._state.get(node)
        spec = None
        if state is not None:
            spec = state[1]
            if not spec.describes(update.params):
                spec, state = None, None
        if spec is None:
            spec = LeafSpec.of(update.params)
        if state is not None and state[4] < self.rebase_every and spec.f32_exact:
            h, _, base_flat, acc, age = state
            try:
                new_flat = spec.flatten(update.params)
            except ValueError:  # shape drift under the same structure → rebase
                new_flat = None
            if new_flat is not None:
                v = new_flat - acc
                frac = self._fraction_for(node, new_flat, v)
                k = max(1, int(frac * v.size))
                self.stats.set_value("topk_k", k)
                nz = int(np.count_nonzero(v))
                if nz > k:
                    keep = np.argpartition(np.abs(v), v.size - k)[v.size - k:]
                    acc[keep] = new_flat[keep]
                else:
                    # every change fits the budget: ship them all
                    np.copyto(acc, new_flat)
                changed = np.flatnonzero(acc != base_flat)
                blob = serialize_update_delta_from_flat(
                    update, spec, acc, base_flat, h,
                    changed=changed,
                    density_threshold=self.density_threshold,
                    compress=self.compress,
                )
                if len(blob) < tree_size_bytes(update.params):
                    ctx.put(f"latest/{node}", blob)
                    self._state[node] = (h, spec, base_flat, acc, age + 1)
                    return blob, True
        full, h = _deposit_base(
            update, ctx, compress=self.compress,
            old_hash=state[0] if state is not None else None,
            old_chain_keys=[], stats=self.stats)
        if spec.f32_exact:
            # acc starts at the wire view of the params: exactly what a reader
            # decodes from the base blob
            flat = spec.flatten(update.params)
            self._state[node] = (h, spec, flat, flat.copy(), 0)
        else:
            self._state[node] = (h, spec, None, None, self.rebase_every)
        return full, False


class FamilyCodec(Codec):
    """Leaf-family subset transport (LoRA-style adapter federation).

    The writer anchors a content-hashed full base; every later push ships only
    the leaves of the selected families (``tree.FAMILY_PATTERNS``) as an
    ordinary delta blob against that base. Per-family sub-policies: ``full``
    ships every member entry, ``delta`` only the members that changed since
    the anchor, ``quantized`` the members int8 per leaf segment. Reconstructed
    non-family leaves equal the anchor's values: pair this transport with
    ``PartialFedAvg(families=...)``. Trees that do not embed in f32 rebase on
    every push."""

    name = "family"

    def __init__(self, *, families: dict[str, str], **kw):
        super().__init__(**kw)
        self.families = dict(families)
        # node -> (base_hash, spec, base_flat, age)
        self._state: dict[str, tuple] = {}

    def reset(self) -> None:
        self._state.clear()

    def _changed_indices(self, view, new_flat: np.ndarray,
                         base_flat: np.ndarray) -> np.ndarray:
        segs = []
        for fam, sub in self.families.items():
            idx = view.indices_of(fam)
            if sub == "delta":
                idx = idx[new_flat[idx] != base_flat[idx]]
            segs.append(idx)
        if len(segs) == 1:
            return segs[0]
        # families are disjoint (first match wins), so a sort of the
        # concatenation is duplicate-free
        changed = np.concatenate(segs)
        changed.sort()
        return changed

    def encode(self, update: NodeUpdate, ctx: StoreContext) -> tuple[bytes, bool]:
        node = update.node_id
        state = self._state.get(node)
        spec = None
        if state is not None:
            spec = state[1]
            if not spec.describes(update.params):
                spec, state = None, None
        if spec is None:
            spec = LeafSpec.of(update.params)
        # resolve the selector up front: a family matching no leaf fails on
        # the first push instead of shipping nothing
        view = spec.family_view(tuple(self.families))
        if state is not None and state[3] < self.rebase_every and spec.f32_exact:
            h, _, base_flat, age = state
            try:
                new_flat = spec.flatten(update.params)
            except ValueError:  # shape drift under the same structure → rebase
                new_flat = None
            if new_flat is not None:
                changed = self._changed_indices(view, new_flat, base_flat)
                quantize_leaves = frozenset(
                    i for i, fam in enumerate(view.leaf_names)
                    if fam is not None and self.families[fam] == "quantized")
                blob = serialize_update_delta_from_flat(
                    update, spec, new_flat, base_flat, h,
                    changed=changed,
                    density_threshold=self.density_threshold,
                    compress=self.compress,
                    quantize_leaves=quantize_leaves,
                    extra_meta={"families": dict(sorted(self.families.items()))},
                )
                if len(blob) < tree_size_bytes(update.params):
                    ctx.put(f"latest/{node}", blob)
                    self._state[node] = (h, spec, base_flat, age + 1)
                    return blob, True
        full, h = _deposit_base(
            update, ctx, compress=self.compress,
            old_hash=state[0] if state is not None else None,
            old_chain_keys=[], stats=self.stats)
        if spec.f32_exact:
            self._state[node] = (h, spec, spec.flatten(update.params), 0)
        else:
            self._state[node] = (h, spec, None, self.rebase_every)
        return full, False


# --------------------------------------------------------------------------
# The pipeline
# --------------------------------------------------------------------------


_CODECS = {"full": FullCodec, "quantized": QuantizedCodec,
           "delta": DeltaCodec, "topk": TopKCodec, "family": FamilyCodec}


class TransportPipeline:
    """One parsed wire pipeline: a policy codec + an optional compressed
    envelope + the stats they share. Summaries and strategy-state blobs ride
    the same envelope (``encode_summary``, ``compress``)."""

    def __init__(self, spec: str, *, rebase_every: int = 10,
                 delta_density_threshold: float = 0.5,
                 topk_fraction: float = 0.01):
        policy, envelope = _validate_stages(parse_pipeline_spec(
            LEGACY_TRANSPORTS.get(spec, spec)))
        self.spec = _canonical(policy, envelope)
        self.compress = envelope
        if envelope == "zstd":
            from .serialize import _zstd_module

            if _zstd_module() is None:
                raise ImportError(
                    "compress='zstd' requires a zstd module (zstandard)")
        name, args = policy
        kw: dict[str, Any] = dict(
            compress=envelope,
            rebase_every=rebase_every,
            density_threshold=delta_density_threshold,
            topk_fraction=topk_fraction,
        )
        if name == "delta":
            kw["chain"] = args["chain"]
            kw["quantize"] = args["q"]
            if "rebase" in args:
                kw["rebase_every"] = args["rebase"]
        elif name == "topk":
            kw["adaptive"] = args["adaptive"]
            if args["fraction"] is not None:
                kw["topk_fraction"] = args["fraction"]
        elif name == "family":
            kw["families"] = args["families"]
        if not 0.0 < kw["topk_fraction"] <= 1.0:
            raise ValueError(
                f"topk_fraction must be in (0, 1], got {kw['topk_fraction']}")
        self.stats = PipelineStats()
        kw["stats"] = self.stats
        self.policy: Codec = _CODECS[name](**kw)

    @classmethod
    def from_spec(cls, transport: str | None = None, *, quantized: bool = False,
                  compress: str = "none", **kw) -> "TransportPipeline":
        return cls(normalize_transport(transport, quantized=quantized,
                                       compress=compress), **kw)

    # -- write side ----------------------------------------------------------
    def push(self, update: NodeUpdate, ctx: StoreContext) -> tuple[bytes, bool]:
        self.stats.incr("encodes")
        with child_span("encode", ctx.telemetry):
            return self.policy.encode(update, ctx)

    def encode_history(self, update: NodeUpdate) -> bytes:
        """Self-contained (and, for lossy policies, exact) history blob."""
        return serialize_update(update, compress=self.compress)

    def encode_summary(self, summary) -> bytes:
        """Gossip group summaries ride the pipeline's envelope."""
        return serialize_group_summary(summary, compress=self.compress)

    def encode_super_summary(self, summary) -> bytes:
        """Hierarchical-gossip tier folds ride the same envelope."""
        return serialize_super_summary(summary, compress=self.compress)

    # -- read side (policy-oblivious: dispatches on wire meta) ----------------
    def decode(self, blob: bytes, node_id: str, ctx: StoreContext) -> NodeUpdate | None:
        """Decode a self-describing blob; None when a delta's reference chain
        cannot be resolved yet (the caller refetches: the writer is
        mid-rebase or mid-GC)."""
        self.stats.incr("decodes")
        with child_span("decode", ctx.telemetry):
            return self._decode(blob, node_id, ctx)

    def _decode(self, blob: bytes, node_id: str, ctx: StoreContext) -> NodeUpdate | None:
        raw = blob
        blob = maybe_decompress(blob)  # once, up front
        meta = peek_meta(blob)
        if meta.get("delta_of"):
            # hash the RAW bytes: a chain link's successor names this blob by
            # the hash of what its writer deposited
            return DeltaCodec.decode_wire(blob, meta, ctx, node_id,
                                          raw_hash=content_hash(raw))
        if meta.get("quantized"):
            return QuantizedCodec.decode_wire(blob, meta, ctx)
        return FullCodec.decode_wire(blob, meta, ctx)

    def reset(self) -> None:
        self.policy.reset()


# --------------------------------------------------------------------------
# Background prefetch
# --------------------------------------------------------------------------


class Prefetcher:
    """Warms a store's decoded-update cache between federation steps.

    A daemon thread calls ``store.warm_cache()`` every ``interval`` seconds,
    decoding only the ``latest/`` blobs whose cheap ``version()`` token
    changed. Exceptions are logged and the next cycle retries. The thread
    holds only a weak reference to the store and exits once it is gone."""

    def __init__(self, store, *, interval: float = 0.1,
                 exclude: str | None = None):
        import weakref

        self._store_ref = weakref.ref(store)
        self.interval = interval
        self.exclude = exclude
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="weightstore-prefetch", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            store = self._store_ref()
            if store is None:
                return  # store collected: nothing left to warm
            try:
                store.warm_cache(exclude=self.exclude)
            except Exception:
                # routine while a writer replaces a blob; next cycle retries
                _log.debug("prefetch sweep failed", exc_info=True)
            del store  # don't pin the store across the sleep

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)

    @property
    def running(self) -> bool:
        return self._thread.is_alive()
