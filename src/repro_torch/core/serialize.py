"""Wire format for the weight store — byte-compatible with ``repro``'s.

A deposited update is a tree of arrays plus scalar metadata (num_examples,
local epoch counter, node id, wall time), serialized to one npz blob: leaves
under their key-path strings, metadata under a reserved ``__meta__`` JSON
entry. Both packages write and read the same blobs: a blob written by either
decodes in the other to bit-identical arrays and an equal ``LeafSpec.key``.

Everything here is host-side numpy; tensor leaves are copied to the host on
the way out. bf16/fp8 leaves ship as f32, as the reference ships them, and
decode to CPU tensors of their own dtype: the port needs no ``ml_dtypes``.

The port carries every family of the reference: full, quantized and delta
updates (the flat decode included), group and super summaries, strategy
state, fleet-control and obs blobs, in the npz/zstd envelopes.
"""
from __future__ import annotations

import contextlib
import hashlib
import io
import json
import math
import re
import struct
import zipfile
import zlib
from dataclasses import dataclass, field
from typing import Any, NamedTuple

import numpy as np
import torch

from .telemetry import child_span
from .tree import (
    NARROW_FLOATS,
    LeafSpec,
    PyTree,
    as_numpy,
    dtype_name,
    path_str,
    torch_dtype,
    tree_flatten_with_path,
    tree_map,
)

_META_KEY = "__meta__"
_SEP = "|"  # npz keys cannot contain '/' reliably across tools; use '|'

# zstd frame magic — lets deserializers sniff a zstd-wrapped npz envelope
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"

COMPRESSIONS = ("none", "npz", "zstd")

_ZSTD_MODULE: object = None  # cached binding; False = probed and absent


def _zstd_module():
    """The first importable zstd binding, or None. Imported lazily: the
    machine with the card may have none."""
    global _ZSTD_MODULE
    if _ZSTD_MODULE is None:
        import importlib

        for name in ("zstandard", "zstd", "compression.zstd"):
            try:
                _ZSTD_MODULE = importlib.import_module(name)
                break
            except ImportError:
                continue
        else:
            _ZSTD_MODULE = False
    return _ZSTD_MODULE or None


def _zstd_compress(blob: bytes) -> bytes:
    mod = _zstd_module()
    if mod is None:
        raise ImportError("compress='zstd' requires a zstd module (zstandard)")
    if hasattr(mod, "ZstdCompressor"):  # zstandard
        return mod.ZstdCompressor().compress(blob)
    return mod.compress(blob)


def maybe_decompress(blob: bytes) -> bytes:
    """Undo the optional zstd wire wrapping; readers stay format-agnostic."""
    if blob[:4] != _ZSTD_MAGIC:
        return blob
    mod = _zstd_module()
    if mod is None:
        raise ImportError("blob is zstd-compressed but no zstd module is available")
    if hasattr(mod, "ZstdDecompressor"):  # zstandard
        return mod.ZstdDecompressor().decompress(blob)
    return mod.decompress(blob)


@dataclass
class NodeUpdate:
    """One client's deposit in the weight store."""

    params: PyTree
    num_examples: int
    node_id: str
    counter: int = 0  # client-local epoch counter (no global round exists)
    timestamp: float = 0.0  # virtual or wall time, for staleness strategies
    metrics: dict = field(default_factory=dict)
    # Fleet-lease epoch of the writer (0 on the original claim); FedAsync
    # discounts adopted peers by the epoch gap.
    lease_epoch: int = 0


class FlatUpdate(NodeUpdate):
    """A ``NodeUpdate`` whose params live as one contiguous host f32 vector
    plus a shared ``LeafSpec``. ``params`` materializes the tree lazily (numpy
    views). Treat both as read-only: they may be shared via the store's
    decode cache."""

    def __init__(self, flat: np.ndarray, spec: LeafSpec, *, num_examples: int,
                 node_id: str, counter: int = 0, timestamp: float = 0.0,
                 metrics: dict | None = None, lease_epoch: int = 0):
        self.flat = np.asarray(flat, np.float32).reshape(-1)
        self.spec = spec
        self._tree: PyTree | None = None
        NodeUpdate.__init__(
            self, params=None, num_examples=num_examples, node_id=node_id,
            counter=counter, timestamp=timestamp, metrics=metrics or {},
            lease_epoch=lease_epoch,
        )

    @property
    def params(self) -> PyTree:
        if self._tree is None:
            self._tree = self.spec.unflatten(self.flat)
        return self._tree

    @params.setter
    def params(self, value) -> None:  # dataclass __init__ assigns params=None
        self._tree = value

    def __repr__(self) -> str:
        return (f"FlatUpdate(node_id={self.node_id!r}, counter={self.counter}, "
                f"num_examples={self.num_examples}, spec={self.spec!r})")


def _wire_leaf(leaf) -> tuple[np.ndarray, str | None]:
    """A leaf's on-wire array. npz cannot round-trip bf16/fp8, so they ship
    as f32; returns (array, dtype name to restore on load or None)."""
    name = dtype_name(leaf.dtype) if hasattr(leaf, "dtype") else None
    if name in NARROW_FLOATS:
        return np.asarray(as_numpy(leaf), np.float32), name
    arr = as_numpy(leaf)
    if arr.dtype.kind == "V":
        return arr.astype(np.float32), arr.dtype.name
    return arr, None


def _restored_leaf(arr: np.ndarray, name: str) -> torch.Tensor:
    """A leaf that shipped as f32, back in its own dtype: a CPU tensor, since
    numpy has no bf16/fp8 type."""
    return torch.from_numpy(np.asarray(arr, np.float32)).to(torch_dtype(name))


def _rebuild_tree(order, dtypes, get_leaf) -> dict:
    """Rebuild the nested-dict tree from 'a|b|c' key paths; restores the
    original dtype of leaves that shipped as f32."""
    tree: dict = {}
    for key in order:
        leaf = get_leaf(key)
        if key in dtypes:
            leaf = _restored_leaf(leaf, dtypes[key])
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree


def _pack_npz(arrays: dict[str, np.ndarray], order: list[str], dtypes: dict[str, str],
              meta: dict[str, Any] | None, *, compress: str = "none") -> bytes:
    """The one wire envelope: leaf arrays + __order__/__dtypes__ under a JSON
    __meta__ entry, zipped into an npz; 'npz' deflates, 'zstd' wraps the
    whole blob in a zstd frame."""
    if compress not in COMPRESSIONS:
        raise ValueError(f"unknown compress {compress!r}; options: {COMPRESSIONS}")
    meta_blob = dict(meta or {})
    meta_blob["__order__"] = order
    meta_blob["__dtypes__"] = dtypes
    arrays[_META_KEY] = np.frombuffer(json.dumps(meta_blob).encode(), dtype=np.uint8)
    buf = io.BytesIO()
    (np.savez_compressed if compress == "npz" else np.savez)(buf, **arrays)
    blob = buf.getvalue()
    if compress == "zstd":
        blob = _zstd_compress(blob)
    return blob


def serialize_params(params: PyTree, meta: dict[str, Any] | None = None, *,
                     compress: str = "none") -> bytes:
    arrays: dict[str, np.ndarray] = {}
    order: list[str] = []
    dtypes: dict[str, str] = {}
    for path, leaf in tree_flatten_with_path(params)[0]:
        key = path_str(path).replace("/", _SEP)
        arr, original_dtype = _wire_leaf(leaf)
        if original_dtype:
            dtypes[key] = original_dtype
        arrays[key] = arr
        order.append(key)
    return _pack_npz(arrays, order, dtypes, meta, compress=compress)


def deserialize_params(blob: bytes | _Envelope) -> tuple[PyTree, dict[str, Any]]:
    """Returns (nested-dict numpy params, meta); every array owns its memory."""
    env = _open(blob)
    return _rebuild_tree(env.order, env.dtypes, lambda key: env.array(key, own=True)), env.meta


# --- flat decode: npz blob → one preallocated f32 vector ---------------------


class FlatDecodeUnsupported(ValueError):
    """Blob holds leaves a flat f32 vector cannot represent losslessly
    (int/f64 wire arrays) — callers fall back to the per-leaf tree decode."""


def _spec_table_key(order, dtypes, quantized, wire_dtypes=()) -> tuple:
    """Structure identity for spec interning (wire dtypes included: f16 and
    f32 models of one structure must not share a spec)."""
    return ("q" if quantized else "f", tuple(order),
            tuple(sorted(dtypes.items())), tuple(wire_dtypes))


def _build_wire_spec(order, dtypes, shapes_by_key, quantized) -> LeafSpec:
    """LeafSpec for a wire structure, in the canonical (sorted-key) leaf order
    a tree reader's rebuilt dict flattens to."""
    skeleton = _rebuild_tree(list(shapes_by_key), {}, lambda key: 0)
    canon_paths, treedef = tree_flatten_with_path(skeleton)
    paths, shapes, dts = [], [], []
    for path, _ in canon_paths:
        p = path_str(path)
        key = p.replace("/", _SEP)
        paths.append(p)
        shapes.append(shapes_by_key[key][0])
        if quantized:
            dts.append(np.dtype(np.float32))  # dequantized leaves are f32
        elif key in dtypes:
            dts.append(dtypes[key])
        else:
            dts.append(shapes_by_key[key][1])
    return LeafSpec(paths, shapes, dts, treedef)


def _wire_keys(spec: LeafSpec) -> tuple[str, ...]:
    """Spec paths in wire ('|'-separated) form, cached on the spec object."""
    keys = getattr(spec, "_wire_keys", None)
    if keys is None:
        keys = tuple(p.replace("/", _SEP) for p in spec.paths)
        spec._wire_keys = keys
    return keys


def _intern_spec(specs: dict, order, dtypes, quantized: bool, wire_dtypes,
                 shapes_by_key: dict) -> LeafSpec:
    """The interned spec of a wire structure (``shapes_by_key``: leaf key →
    (shape, wire dtype)); one whose shapes drifted is rebuilt and replaced."""
    skey = _spec_table_key(order, dtypes, quantized, wire_dtypes)
    spec = specs.get(skey)
    drifted = False
    if spec is not None:
        # verify shapes still match the interned layout; drift → rebuild
        wire = _wire_keys(spec)
        if len(wire) != len(shapes_by_key) or any(
            tuple(shape) != spec.shapes[spec.index[k.replace(_SEP, "/")]]
            for k, (shape, _) in shapes_by_key.items()
        ):
            spec, drifted = None, True
    if spec is None:
        spec = _build_wire_spec(order, dtypes, shapes_by_key, quantized)
        if drifted:
            specs[skey] = spec  # replace the stale layout
        else:
            # setdefault: a racing decode (prefetch thread vs pull) must
            # not intern two spec instances for one structure
            spec = specs.setdefault(skey, spec)
    return spec




# --- the one envelope reader: every read of a blob goes through it ----------
#
# A stored zip member's bytes are the .npy file itself, so an array can be
# read where it lies in the blob: the central directory gives each member's
# local header, the local header where its bytes start, and the .npy header
# the array's dtype, shape and data offset.
_ZIP_LOCAL = struct.Struct("<4s22xHH")  # signature; name and extra-field lengths
_ZIP_LOCAL_MAGIC = b"PK\x03\x04"
_NPY_MAGIC = b"\x93NUMPY"
_NPY_MAX_HEADER = 10000  # numpy's own limit on the .npy header it parses
# the header numpy writes for a C-order array; any other header is read by numpy
_NPY_HEAD = re.compile(r"\{'descr': '([^']+)', 'fortran_order': False, "
                       r"'shape': \((\d+(?:, \d+)*,?|)\), \} *\n")
_CHUNK = 1 << 18  # bytes checked and copied at a time, while they are in cache


class _StoredArray(NamedTuple):
    """Where one stored, C-order ``.npy`` member lies in a zip blob."""

    start: int  # the member's first byte (its .npy magic)
    end: int
    crc: int  # the CRC-32 the central directory holds for the member
    data: int  # the array's first byte
    dtype: np.dtype
    shape: tuple


def _check_crc(crc: int, m: _StoredArray, key: str) -> None:
    """The zip reader's integrity check on a member read in place."""
    if crc != m.crc:
        raise zipfile.BadZipFile(f"Bad CRC-32 for file {key + '.npy'!r}")


class _Envelope:
    """One wire blob, opened once: unwrapped from zstd, its central directory
    parsed and its ``__meta__`` entry read. ``header`` is that entry as
    written; ``meta`` is the same without ``order`` (the leaf keys) and
    ``dtypes`` (the dtypes of leaves that ship as f32).

    A member that is stored and C-order is read where it lies in the blob,
    its CRC-32 checked over its bytes there; any other member is read as
    numpy's npz loader reads it, through the zip reader, which checks the CRC."""

    def __init__(self, blob: bytes):
        blob = maybe_decompress(blob)
        if blob[:4] != _ZIP_LOCAL_MAGIC:
            raise ValueError("not an npz envelope")  # numpy's loader raises ValueError too
        self.blob = blob
        self.zip = zipfile.ZipFile(io.BytesIO(blob))  # parses the central directory only
        self.files = {n[:-4] for n in self.zip.namelist() if n.endswith(".npy")}
        self.header = json.loads(self.array(_META_KEY).tobytes().decode())
        self.meta = dict(self.header)
        self.order: list[str] = self.meta.pop("__order__")
        self.dtypes: dict[str, str] = self.meta.pop("__dtypes__", {})

    def stored(self, key: str) -> _StoredArray | None:
        """Member ``key``'s layout where it can be read in place: stored,
        unencrypted, a .npy header of version 1, 2 or 3 as numpy writes it
        for a C-order array of this host's byte order without objects, and
        no trailing bytes. None for anything else."""
        blob = self.blob
        try:
            info = self.zip.getinfo(key + ".npy")
        except KeyError:
            return None
        o = info.header_offset
        if (info.compress_type != zipfile.ZIP_STORED or info.flag_bits & 1
                or info.file_size < 12 or o + _ZIP_LOCAL.size > len(blob)):
            return None
        magic, n_name, n_extra = _ZIP_LOCAL.unpack_from(blob, o)
        start = o + _ZIP_LOCAL.size + n_name + n_extra
        end = start + info.file_size
        if magic != _ZIP_LOCAL_MAGIC or end > len(blob) or blob[start:start + 6] != _NPY_MAGIC:
            return None
        major = blob[start + 6]
        if major not in (1, 2, 3):
            return None
        at = start + (10 if major == 1 else 12)
        n_head = int.from_bytes(blob[start + 8:at], "little")
        if n_head > _NPY_MAX_HEADER:
            return None
        head = _NPY_HEAD.fullmatch(bytes(blob[at:at + n_head]).decode("latin1"))
        if head is None:
            return None
        try:
            dtype = np.dtype(head[1])
        except (TypeError, ValueError):
            return None
        if not dtype.isnative or dtype.hasobject:
            return None
        shape = tuple(int(d) for d in head[2].split(",") if d)
        if at + n_head + math.prod(shape) * dtype.itemsize != end:
            return None
        return _StoredArray(start, end, info.CRC, at + n_head, dtype, shape)

    def array(self, key: str, *, own: bool = False) -> np.ndarray:
        """Member ``key``, CRC-checked. An in-place member is a read-only
        view of the blob unless ``own``; a member numpy reads owns its
        memory."""
        m = self.stored(key)
        if m is None:
            with self.zip.open(key + ".npy") as f:
                return np.lib.format.read_array(f, allow_pickle=False)
        _check_crc(zlib.crc32(memoryview(self.blob)[m.start:m.end]), m, key)
        view = np.frombuffer(self.blob, m.dtype, math.prod(m.shape), m.data).reshape(m.shape)
        return view.copy() if own else view

    def copy_into(self, key: str, m: _StoredArray, dst: np.ndarray) -> None:
        """Copy in-place member ``key`` into ``dst``, checking its CRC-32 on
        the way, a chunk at a time while the bytes are in cache."""
        src = np.frombuffer(self.blob, m.dtype, dst.size, m.data)
        crc = zlib.crc32(memoryview(self.blob)[m.start:m.data])  # the .npy header
        step = _CHUNK // m.dtype.itemsize
        for a in range(0, dst.size, step):
            part = src[a:a + step]
            crc = zlib.crc32(part, crc)
            dst[a:a + step] = part
        _check_crc(crc, m, key)


def _open(blob: bytes | _Envelope) -> _Envelope:
    """The envelope of ``blob``; one a caller already opened is used as is."""
    return blob if isinstance(blob, _Envelope) else _Envelope(blob)


def decode_params_flat(blob: bytes | _Envelope,
                       specs: dict) -> tuple[LeafSpec, np.ndarray, dict]:
    """Decode a full or quantized npz blob straight into one preallocated
    host f32 vector. ``specs`` is a caller-owned interning table (structure
    key → LeafSpec) so all updates of one model share a spec instance.
    Raises ``FlatDecodeUnsupported`` for wire arrays that don't embed in f32.

    A leaf member stored in place is CRC-checked and copied once into the
    flat, a chunk at a time; a full update whose every leaf is read so
    decodes inside the span ``decode.inplace``."""
    env = _open(blob)
    if "delta_of" in env.meta:
        raise ValueError("delta blob: use deserialize_update_delta_flat")
    quantized = bool(env.meta.get("quantized"))
    if quantized:
        # order lists the packed {"q":..., "s":...} tree; the spec
        # describes the original structure (q-keys with prefix stripped)
        members = {k[2:]: env.array(k) for k in env.order if k.startswith("q" + _SEP)}
    else:
        members = {k: env.stored(k) or env.array(k) for k in env.order}
        for k, a in members.items():
            if a.dtype.kind != "f" or a.dtype.itemsize > 4:
                raise FlatDecodeUnsupported(
                    f"leaf {k!r} has wire dtype {a.dtype} (not f32-exact)")
    in_place = not quantized and all(isinstance(a, _StoredArray) for a in members.values())
    with child_span("decode.inplace") if in_place else contextlib.nullcontext():
        wire_dtypes = () if quantized else tuple(a.dtype.str for a in members.values())
        spec = _intern_spec(specs, env.order, env.dtypes, quantized, wire_dtypes,
                            {k: (tuple(a.shape), a.dtype) for k, a in members.items()})
        flat = spec.empty_flat()
        index, offsets, sizes = spec.index, spec.offsets, spec.sizes
        for k, a in members.items():
            i = index[k.replace(_SEP, "/")]
            o, n = offsets[i], sizes[i]
            if quantized:
                np.multiply(a.reshape(-1), np.float32(env.array("s" + _SEP + k)),
                            out=flat[o:o + n], dtype=np.float32, casting="unsafe")
            elif isinstance(a, _StoredArray):
                env.copy_into(k, a, flat[o:o + n])
            else:
                flat[o:o + n] = a.reshape(-1)
    return spec, flat, env.meta


def flat_update_from_meta(spec: LeafSpec, flat: np.ndarray,
                          meta: dict[str, Any]) -> FlatUpdate:
    return FlatUpdate(
        flat, spec,
        num_examples=int(meta["num_examples"]),
        node_id=str(meta["node_id"]),
        counter=int(meta["counter"]),
        timestamp=float(meta["timestamp"]),
        metrics=meta.get("metrics", {}),
        lease_epoch=int(meta.get("lease_epoch", 0)),
    )


def deserialize_update_flat(blob: bytes | _Envelope, specs: dict) -> FlatUpdate:
    """Full/quantized blob → FlatUpdate (see ``decode_params_flat``)."""
    spec, flat, meta = decode_params_flat(blob, specs)
    return flat_update_from_meta(spec, flat, meta)


def decode_update(blob: bytes | _Envelope, specs: dict) -> NodeUpdate:
    """A full or quantized blob as a ``FlatUpdate`` where its leaves embed
    exactly in f32 (a quantized blob's dequantized leaves always do), else as
    the tree ``NodeUpdate``."""
    env = _open(blob)
    try:
        return deserialize_update_flat(env, specs)
    except FlatDecodeUnsupported:
        return deserialize_update(env)


def _update_meta(update: NodeUpdate, **extra: Any) -> dict[str, Any]:
    return {
        "num_examples": int(update.num_examples),
        "node_id": update.node_id,
        "counter": int(update.counter),
        "timestamp": float(update.timestamp),
        "metrics": update.metrics,
        "lease_epoch": int(getattr(update, "lease_epoch", 0)),
        **extra,
    }


def _update_from_meta(params: PyTree, meta: dict[str, Any]) -> NodeUpdate:
    return NodeUpdate(
        params=params,
        num_examples=int(meta["num_examples"]),
        node_id=str(meta["node_id"]),
        counter=int(meta["counter"]),
        timestamp=float(meta["timestamp"]),
        metrics=meta.get("metrics", {}),
        lease_epoch=int(meta.get("lease_epoch", 0)),
    )


def serialize_update(update: NodeUpdate, *, compress: str = "none") -> bytes:
    return serialize_params(update.params, meta=_update_meta(update), compress=compress)


def deserialize_update(blob: bytes | _Envelope) -> NodeUpdate:
    params, meta = deserialize_params(blob)
    return _update_from_meta(params, meta)


def content_hash(blob: bytes) -> str:
    return hashlib.sha256(blob).hexdigest()[:16]


def peek_meta(blob: bytes) -> dict[str, Any]:
    """Read only the ``__meta__`` entry of a blob (cheap dispatch: full vs
    quantized vs delta) without materializing the weight arrays."""
    return dict(_open(blob).header)


# --- strategy-state recovery blobs (``state/<node>``) ------------------------


def serialize_strategy_state(node_id: str, strategy: str, counter: int,
                             state: dict, *, compress: str = "none") -> bytes:
    return serialize_params(
        {k: as_numpy(v) for k, v in state.items()},
        compress=compress,
        meta={"state_of": node_id, "strategy": strategy, "counter": int(counter)},
    )


def deserialize_strategy_state(blob: bytes) -> tuple[dict, dict]:
    """-> (state arrays by name, meta with state_of/strategy/counter)."""
    state, meta = deserialize_params(blob)
    if "state_of" not in meta:
        raise ValueError("not a strategy-state blob")
    return state, meta


# --- observability blobs (``obs/<node>/<seq>``) -------------------------------


def serialize_obs_blob(node_id: str, seq: int, payload: dict, *,
                       compress: str = "none") -> bytes:
    """One telemetry snapshot deposit for ``obs/<node_id>/<seq>``."""
    return serialize_params(
        {}, compress=compress,
        meta={"obs_of": str(node_id), "seq": int(seq), "payload": dict(payload)},
    )


def deserialize_obs_blob(blob: bytes) -> tuple[str, int, dict]:
    """-> (node_id, seq, payload). Raises ValueError on non-obs blobs."""
    _params, meta = deserialize_params(blob)
    if "obs_of" not in meta:
        raise ValueError("not a telemetry blob")
    return (str(meta["obs_of"]), int(meta.get("seq", 0)),
            dict(meta.get("payload") or {}))


# --- int8 compressed payloads -------------------------------------------------


def quantize_leaf(x) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-tensor int8 quantization: returns (q, scale)."""
    x = np.asarray(as_numpy(x), np.float32)
    scale = np.maximum(np.abs(x).max(), 1e-12) / 127.0
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return q, np.float32(scale)


def dequantize_leaf(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return q.astype(np.float32) * np.float32(scale)


def serialize_update_quantized(update: NodeUpdate, *, compress: str = "none") -> bytes:
    qtree = tree_map(lambda x: quantize_leaf(x)[0], update.params)
    stree = tree_map(lambda x: quantize_leaf(x)[1], update.params)
    return serialize_params(
        {"q": qtree, "s": stree}, meta=_update_meta(update, quantized=True),
        compress=compress
    )


def deserialize_update_quantized(blob: bytes) -> NodeUpdate:
    packed, meta = deserialize_params(blob)
    params = tree_map(dequantize_leaf, packed["q"], packed["s"])
    return _update_from_meta(params, meta)


# --- group summaries (sharded gossip store) ---------------------------------
#
# A group's deposit in the gossip layer: the example-weighted mean of the
# group's latest params, the total examples behind it (its weight as a
# pseudo-peer) and a version vector (its freshness). ``peek_meta`` dispatches
# on ``summary_of`` as it does on ``delta_of`` / ``quantized``.


@dataclass
class GroupSummary:
    """One group's aggregate deposit in the gossip layer."""

    params: PyTree              # example-weighted mean of the group's latest params
    num_examples: int           # total examples behind that mean
    origin: int                 # group index that produced the summary
    version: int                # monotone freshness scalar: sum of (counter + 1)
    version_vector: dict        # node_id -> latest counter folded into the mean
    timestamp: float = 0.0      # newest member timestamp (staleness strategies)


def serialize_group_summary(summary: GroupSummary, *, compress: str = "none") -> bytes:
    return serialize_params(
        summary.params,
        compress=compress,
        meta={
            "summary_of": int(summary.origin),
            "num_examples": int(summary.num_examples),
            "version": int(summary.version),
            "version_vector": {str(k): int(v) for k, v in summary.version_vector.items()},
            "timestamp": float(summary.timestamp),
        },
    )


def deserialize_group_summary(blob: bytes) -> GroupSummary:
    params, meta = deserialize_params(blob)
    if "summary_of" not in meta:
        raise ValueError("not a group-summary blob")
    return GroupSummary(
        params=params,
        num_examples=int(meta["num_examples"]),
        origin=int(meta["summary_of"]),
        version=int(meta["version"]),
        version_vector={str(k): int(v) for k, v in meta["version_vector"].items()},
        timestamp=float(meta.get("timestamp", 0.0)),
    )


# --- super-summaries (hierarchical gossip tiers) ------------------------------
#
# A level-k aggregator's fold of one ring segment: the example-weighted mean of
# the segment's child summaries, per-child freshness (``child_versions``), and
# per-child counter maxima as its version vector (O(branching) metadata at any
# depth). Dispatches on ``super_summary_of``.


@dataclass
class SuperSummary:
    """One ring segment's folded deposit at tier ``level`` of the summary tree."""

    params: PyTree              # example-weighted mean of the child summaries
    num_examples: int           # total examples behind that mean
    origin: int                 # segment index at this level
    level: int                  # tier (>= 1; level-0 deposits are GroupSummary)
    version: int                # sum of the child version scalars (monotone)
    child_versions: dict        # child origin key -> version scalar folded in
    version_vector: dict        # child pseudo-peer id -> its counter maximum
    timestamp: float = 0.0      # newest child timestamp


def serialize_super_summary(summary: SuperSummary, *, compress: str = "none") -> bytes:
    return serialize_params(
        summary.params,
        compress=compress,
        meta={
            "super_summary_of": int(summary.origin),
            "level": int(summary.level),
            "num_examples": int(summary.num_examples),
            "version": int(summary.version),
            "child_versions": {str(k): int(v) for k, v in summary.child_versions.items()},
            "version_vector": {str(k): int(v) for k, v in summary.version_vector.items()},
            "timestamp": float(summary.timestamp),
        },
    )


def deserialize_super_summary(blob: bytes) -> SuperSummary:
    params, meta = deserialize_params(blob)
    if "super_summary_of" not in meta:
        raise ValueError("not a super-summary blob")
    return SuperSummary(
        params=params,
        num_examples=int(meta["num_examples"]),
        origin=int(meta["super_summary_of"]),
        level=int(meta["level"]),
        version=int(meta["version"]),
        child_versions={str(k): int(v) for k, v in meta["child_versions"].items()},
        version_vector={str(k): int(v) for k, v in meta["version_vector"].items()},
        timestamp=float(meta.get("timestamp", 0.0)),
    )


# --- fleet-control blobs (``fleet/...``: rosters, and later leases) ----------


def serialize_fleet_blob(kind: str, payload: dict, *, compress: str = "none") -> bytes:
    """One fleet-control deposit: ``kind`` (roster, spec, claim, ...) plus a
    JSON-serializable payload, no arrays."""
    return serialize_params(
        {}, compress=compress,
        meta={"fleet_of": str(kind), "payload": dict(payload)},
    )


def deserialize_fleet_blob(blob: bytes) -> tuple[str, dict]:
    """-> (kind, payload). Raises ValueError on non-fleet blobs."""
    _params, meta = deserialize_params(blob)
    if "fleet_of" not in meta:
        raise ValueError("not a fleet-control blob")
    return str(meta["fleet_of"]), dict(meta.get("payload") or {})


# --- delta payloads against a content-hashed base ---------------------------
#
# After a full deposit, a writer ships only the entries that changed against a
# base blob it also deposited (content-addressed, so readers check they
# rebuild on the exact bytes the writer diffed against). The sparse encoding
# stores the NEW values at changed positions, not differences, so
# reconstruction is bitwise exact.

_DENSE = "d" + _SEP  # per-leaf dense fallback
_IDX = "i" + _SEP    # changed flat indices
_VAL = "v" + _SEP    # new values at those indices
_SCALE = "c" + _SEP  # int8 scale when the delta values are quantized


class DeltaBaseMismatch(RuntimeError):
    """The base blob a delta references is missing or has different content."""


def _flat_wire(params: PyTree) -> dict[str, tuple[np.ndarray, str | None]]:
    """Wire key -> (on-wire host array, dtype name to restore or None)."""
    return {path_str(path).replace("/", _SEP): _wire_leaf(leaf)
            for path, leaf in tree_flatten_with_path(params)[0]}


def _wire_dtype(name: str) -> tuple[np.dtype, str | None]:
    """On-wire numpy dtype of a spec dtype name, and the name to restore."""
    if name in NARROW_FLOATS:
        return np.dtype(np.float32), name
    return np.dtype(name), None


def canonicalize_params(params: PyTree) -> PyTree:
    """The nested-dict tree a reader reconstructs after a serialize round-trip
    (wire dtype conversion included), computed without the npz I/O. A delta
    writer diffs later updates against this, so its view of the base is
    bitwise identical to every reader's."""
    wire = _flat_wire(params)
    dtypes = {k: dt for k, (_, dt) in wire.items() if dt}
    return _rebuild_tree(list(wire), dtypes, lambda key: np.array(wire[key][0], copy=True))


def delta_density(params: PyTree, base_params: PyTree) -> float:
    """Fraction of entries that differ from the base (1.0 on any structural
    mismatch). A diagnostic: the codecs decide delta-vs-rebase by the encoded
    size against the tree's byte size."""
    new, base = _flat_wire(params), _flat_wire(base_params)
    if set(new) != set(base):
        return 1.0
    changed = total = 0
    for key, (a, _) in new.items():
        b = base[key][0]
        if a.shape != b.shape or a.dtype != b.dtype:
            return 1.0
        total += a.size
        changed += int(np.count_nonzero(a.reshape(-1) != b.reshape(-1)))
    return changed / max(total, 1)


def apply_update_delta_flat(blob: bytes | _Envelope, spec: LeafSpec,
                            flat: np.ndarray) -> dict[str, Any]:
    """Apply a delta blob's entries *in place* on ``flat`` (which must hold
    the referenced base state); returns the blob's meta. In place, a chain walk
    rebuilds K links with one base copy. On a raised exception ``flat`` may be
    partly written: callers discard it (the exceptions signal a structure or
    dtype mismatch, never a transient)."""
    env = _open(blob)
    if "delta_of" not in env.meta:
        raise ValueError("not a delta blob")
    wire = _wire_keys(spec)
    if len(env.order) != len(wire) or set(env.order) != set(wire):
        raise ValueError("delta structure does not match the base spec")
    files = env.files
    index, offsets, sizes = spec.index, spec.offsets, spec.sizes
    for key in env.order:
        i = index[key.replace(_SEP, "/")]
        o, n = offsets[i], sizes[i]
        if _DENSE + key in files:
            arr = env.array(_DENSE + key)
            if arr.size != n:
                raise ValueError(f"dense leaf {key!r}: {arr.size} vs {n}")
            if _SCALE + key in files:  # dense int8-quantized leaf
                flat[o:o + n] = dequantize_leaf(arr.reshape(-1), env.array(_SCALE + key))
                continue
            if arr.dtype.kind != "f" or arr.dtype.itemsize > 4:
                raise FlatDecodeUnsupported(
                    f"leaf {key!r} has wire dtype {arr.dtype} (not f32-exact)")
            flat[o:o + n] = arr.reshape(-1)
            continue
        idx = env.array(_IDX + key)
        vals = env.array(_VAL + key)
        if _SCALE + key in files:
            vals = dequantize_leaf(vals, env.array(_SCALE + key))
        elif vals.size and (vals.dtype.kind != "f" or vals.dtype.itemsize > 4):
            raise FlatDecodeUnsupported(
                f"leaf {key!r} delta values have wire dtype {vals.dtype}")
        flat[o + idx] = vals
    return env.meta


def deserialize_update_delta_flat(blob: bytes | _Envelope, spec: LeafSpec,
                                  base_flat: np.ndarray) -> FlatUpdate:
    """A FlatUpdate from a delta blob, applied on a copy of the flat base
    vector. Raises ValueError when the blob's structure does not match
    ``spec`` (the caller falls back to the tree path)."""
    flat = np.array(base_flat, dtype=np.float32, copy=True)
    meta = apply_update_delta_flat(blob, spec, flat)
    return flat_update_from_meta(spec, flat, meta)


def serialize_update_delta_from_flat(
    update: NodeUpdate,
    spec: LeafSpec,
    flat: np.ndarray,
    base_flat: np.ndarray,
    base_hash: str,
    *,
    changed: np.ndarray | None = None,
    density_threshold: float = 0.5,
    compress: str = "none",
    quantize_leaves: "frozenset[int] | set[int] | tuple[int, ...]" = (),
    extra_meta: dict[str, Any] | None = None,
) -> bytes:
    """Encode host ``flat`` as a sparse per-leaf diff against ``base_flat``, in
    the exact wire format of ``serialize_update_delta``, so a reader needs no
    knowledge of how the writer chose the changed set. ``changed`` (sorted
    flat indices that differ from the base) may be passed when known;
    ``quantize_leaves`` names leaf indices whose changed values ship int8
    (per-segment scale under ``c|``); ``extra_meta`` adds writer meta keys."""
    flat = np.asarray(flat, np.float32).reshape(-1)
    if flat.size != spec.num_params:
        raise ValueError(f"{flat.size} params vs spec's {spec.num_params}")
    if changed is None:
        changed = np.flatnonzero(flat != np.asarray(base_flat).reshape(-1))
    arrays: dict[str, np.ndarray] = {}
    order: list[str] = []
    dtypes: dict[str, str] = {}
    keys = _wire_keys(spec)
    # one vectorized split of the changed set into per-leaf segments
    cuts = np.searchsorted(changed, spec.bounds)
    for i, key in enumerate(keys):
        order.append(key)
        wire_dt, restored = _wire_dtype(spec.dtypes[i])
        if restored:
            dtypes[key] = restored
        o, n = spec.offsets[i], spec.sizes[i]
        seg = changed[cuts[i]:cuts[i + 1]]
        if i in quantize_leaves and seg.size:
            if seg.size > density_threshold * n:
                # dense quantized: an int8 leaf plus its scale (1 byte an
                # entry, where the sparse form pays 5)
                q, scale = quantize_leaf(flat[o:o + n])
                arrays[_DENSE + key] = q.reshape(spec.shapes[i])
                arrays[_SCALE + key] = np.asarray(scale)
                continue
            arrays[_IDX + key] = (seg - o).astype(np.int64 if n > 2**31 else np.int32)
            q, scale = quantize_leaf(flat[seg])
            arrays[_VAL + key] = q
            arrays[_SCALE + key] = np.asarray(scale)
            continue
        if seg.size > density_threshold * n:
            arrays[_DENSE + key] = np.asarray(flat[o:o + n], dtype=wire_dt).reshape(spec.shapes[i])
            continue
        arrays[_IDX + key] = (seg - o).astype(np.int64 if n > 2**31 else np.int32)
        arrays[_VAL + key] = np.asarray(flat[seg], dtype=wire_dt)
    meta = _update_meta(update, delta_of=base_hash, **(extra_meta or {}))
    return _pack_npz(arrays, order, dtypes, meta, compress=compress)


def serialize_update_delta(
    update: NodeUpdate,
    base_params: PyTree,
    base_hash: str,
    *,
    quantize: bool = False,
    density_threshold: float = 0.5,
    compress: str = "none",
) -> bytes:
    """Encode ``update`` as a sparse per-leaf diff against ``base_params``
    (whose full blob hashes to ``base_hash``). Leaves denser than
    ``density_threshold`` ship dense; ``quantize`` ships changed values int8
    (lossy)."""
    new, base = _flat_wire(update.params), _flat_wire(base_params)
    if set(new) != set(base):
        raise ValueError("delta requires identical tree structure with the base")
    arrays: dict[str, np.ndarray] = {}
    order: list[str] = []
    dtypes: dict[str, str] = {}
    for key, (a, dt) in new.items():
        order.append(key)
        if dt:
            dtypes[key] = dt
        b = base[key][0]
        if a.shape != b.shape or a.dtype != b.dtype:
            arrays[_DENSE + key] = a
            continue
        af, bf = a.reshape(-1), b.reshape(-1)
        idx = np.flatnonzero(af != bf)
        if idx.size > density_threshold * af.size:
            arrays[_DENSE + key] = a
            continue
        arrays[_IDX + key] = idx.astype(np.int64 if af.size > 2**31 else np.int32)
        vals = af[idx]
        if quantize and vals.dtype.kind == "f" and vals.size:
            q, scale = quantize_leaf(vals)
            arrays[_VAL + key] = q
            arrays[_SCALE + key] = np.asarray(scale)
        else:
            arrays[_VAL + key] = vals
    return _pack_npz(arrays, order, dtypes, _update_meta(update, delta_of=base_hash),
                     compress=compress)


def deserialize_update_delta(blob: bytes | _Envelope, base_params: PyTree) -> NodeUpdate:
    """A full NodeUpdate from a delta blob and the base params it was diffed
    against (the caller matches ``delta_of`` to the base blob's hash)."""
    base = _flat_wire(base_params)
    env = _open(blob)
    if "delta_of" not in env.meta:
        raise ValueError("not a delta blob")

    def reconstruct(key: str) -> np.ndarray:
        if _DENSE + key in env.files:
            if _SCALE + key in env.files:  # dense int8-quantized leaf
                return dequantize_leaf(env.array(_DENSE + key), env.array(_SCALE + key))
            return env.array(_DENSE + key, own=True)
        if key not in base:
            raise DeltaBaseMismatch(f"base is missing leaf {key!r}")
        b = base[key][0]
        flat = np.array(b, copy=True).reshape(-1)
        vals = env.array(_VAL + key)
        if _SCALE + key in env.files:
            vals = dequantize_leaf(vals, env.array(_SCALE + key))
        flat[env.array(_IDX + key)] = vals.astype(flat.dtype, copy=False)
        return flat.reshape(b.shape)

    return _update_from_meta(_rebuild_tree(env.order, env.dtypes, reconstruct), env.meta)
