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

This slice carries the ``full`` and ``quantized`` policies with both
envelopes. The ``delta``, ``topk`` and ``family`` policies (ROADMAP Queue 1
item 13, slice 3) raise ``NotImplementedError`` when a pipeline using them is
built, and a reader that meets a delta blob written by a ``repro`` node raises
too: it never returns a wrong update.
"""
from __future__ import annotations

import re
import threading

import numpy as np

from .serialize import (
    FlatDecodeUnsupported,
    NodeUpdate,
    decode_params_flat,
    deserialize_update,
    deserialize_update_quantized,
    flat_update_from_meta,
    maybe_decompress,
    peek_meta,
    serialize_update,
    serialize_update_quantized,
)
from repro_torch.logs import get_logger

_log = get_logger("transport")

_SLICE_3 = "ROADMAP Queue 1 item 13, slice 3"


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
    crosses it is counted on the pipeline's stats, and the interned LeafSpecs
    live here so the write side, the read side and the prefetch thread share
    one view."""

    def __init__(self, folder, stats: PipelineStats):
        self.folder = folder
        self.stats = stats
        # attached by the owning store (``attach_telemetry``)
        self.telemetry = None
        # interned LeafSpecs: one per decoded structure
        self.specs: dict = {}

    def put(self, key: str, blob: bytes) -> None:
        tel = self.telemetry
        if tel is not None and tel.enabled:
            with tel.span("put"):
                self.folder.put(key, blob)
        else:
            self.folder.put(key, blob)
        self.stats.incr("bytes_written", len(blob))

    def get(self, key: str) -> bytes | None:
        tel = self.telemetry
        if tel is not None and tel.enabled:
            with tel.span("get"):
                blob = self.folder.get(key)
        else:
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


# --------------------------------------------------------------------------
# Codecs
# --------------------------------------------------------------------------


class Codec:
    """One wire policy. ``encode`` owns the write side; the read side is the
    static ``decode_wire`` hooks, dispatched on the blob's own meta by
    ``TransportPipeline.decode``."""

    name = "codec"

    def __init__(self, *, compress: str = "none"):
        self.compress = compress

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


# --------------------------------------------------------------------------
# The pipeline
# --------------------------------------------------------------------------


_CODECS = {"full": FullCodec, "quantized": QuantizedCodec}


class TransportPipeline:
    """One parsed wire pipeline: a policy codec + an optional compressed
    envelope + the stats they share."""

    def __init__(self, spec: str):
        policy, envelope = _validate_stages(parse_pipeline_spec(
            LEGACY_TRANSPORTS.get(spec, spec)))
        self.spec = _canonical(policy, envelope)
        if policy[0] not in _CODECS:
            raise NotImplementedError(
                f"transport policy {policy[0]!r} ({self.spec!r}) is not ported yet "
                f"({_SLICE_3}); the port writes 'full' or 'quantized' blobs")
        self.compress = envelope
        if envelope == "zstd":
            from .serialize import _zstd_module

            if _zstd_module() is None:
                raise ImportError(
                    "compress='zstd' requires a zstd module (zstandard)")
        self.stats = PipelineStats()
        self.policy: Codec = _CODECS[policy[0]](compress=envelope)

    @classmethod
    def from_spec(cls, transport: str | None = None, *, quantized: bool = False,
                  compress: str = "none") -> "TransportPipeline":
        return cls(normalize_transport(transport, quantized=quantized, compress=compress))

    # -- write side ----------------------------------------------------------
    def push(self, update: NodeUpdate, ctx: StoreContext) -> tuple[bytes, bool]:
        self.stats.incr("encodes")
        tel = ctx.telemetry
        if tel is not None and tel.enabled:
            with tel.span("encode"):
                return self.policy.encode(update, ctx)
        return self.policy.encode(update, ctx)

    def encode_history(self, update: NodeUpdate) -> bytes:
        """Self-contained (and, for lossy policies, exact) history blob."""
        return serialize_update(update, compress=self.compress)

    # -- read side (policy-oblivious: dispatches on wire meta) ----------------
    def decode(self, blob: bytes, node_id: str, ctx: StoreContext) -> NodeUpdate:
        self.stats.incr("decodes")
        tel = ctx.telemetry
        if tel is not None and tel.enabled:
            with tel.span("decode"):
                return self._decode(blob, node_id, ctx)
        return self._decode(blob, node_id, ctx)

    def _decode(self, blob: bytes, node_id: str, ctx: StoreContext) -> NodeUpdate:
        blob = maybe_decompress(blob)  # once, up front
        meta = peek_meta(blob)
        if meta.get("delta_of"):
            raise NotImplementedError(
                f"node {node_id!r} deposited a delta blob (a repro node with a "
                f"delta/topk/family transport); delta decoding is not ported "
                f"yet ({_SLICE_3})")
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
