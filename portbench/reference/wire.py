"""The store's full-update wire format, read and written without the
program: one npz archive whose entries are the leaves under their key paths
('a|b|c'), in sorted-key order, plus a ``__meta__`` entry (UTF-8 JSON as
uint8) holding ``__order__``, ``__dtypes__`` (leaves that ship as f32 but are
another type, such as bfloat16) and the update's scalars."""
from __future__ import annotations

import io
import json
import zipfile

import numpy as np

SEP = "|"


def write_leaves(leaves: dict[str, np.ndarray]) -> bytes:
    """The leaves' part of a blob: an npz of the arrays under their key
    paths, sorted, without the ``__meta__`` entry (``with_meta`` adds it)."""
    buf = io.BytesIO()
    np.savez(buf, **{p.replace("/", SEP): np.ascontiguousarray(leaves[p])
                     for p in sorted(leaves)})
    return buf.getvalue()


def with_meta(body: bytes, *, node_id: str, counter: int, num_examples: int,
              timestamp: float = 0.0, dtypes: dict[str, str] | None = None) -> bytes:
    """A whole blob: ``body`` (``write_leaves``) with the ``__meta__`` entry
    appended. One body serves many blobs that differ in their scalars."""
    with zipfile.ZipFile(io.BytesIO(body)) as z:
        order = [n[:-len(".npy")] for n in z.namelist()]
    meta = {"num_examples": int(num_examples), "node_id": node_id, "counter": int(counter),
            "timestamp": float(timestamp), "metrics": {}, "lease_epoch": 0,
            "__order__": order,
            "__dtypes__": {p.replace("/", SEP): d for p, d in (dtypes or {}).items()}}
    entry = io.BytesIO()
    np.lib.format.write_array(entry, np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8))
    buf = io.BytesIO()
    buf.write(body)
    with zipfile.ZipFile(buf, "a", allowZip64=True) as z:
        z.writestr("__meta__.npy", entry.getvalue())
    return buf.getvalue()


def write_update(leaves: dict[str, np.ndarray], *, node_id: str, counter: int,
                 num_examples: int, timestamp: float = 0.0,
                 dtypes: dict[str, str] | None = None) -> bytes:
    """``leaves`` maps 'a/b/c' paths to arrays; the blob lists them sorted."""
    return with_meta(write_leaves(leaves), node_id=node_id, counter=counter,
                     num_examples=num_examples, timestamp=timestamp, dtypes=dtypes)


def read_update(blob: bytes) -> tuple[dict[str, np.ndarray], dict]:
    """-> ({'a/b/c': array}, meta without the order and dtype tables)."""
    with np.load(io.BytesIO(blob)) as data:
        meta = json.loads(bytes(data["__meta__"].tobytes()).decode())
        order = meta.pop("__order__")
        meta.pop("__dtypes__", None)
        leaves = {k.replace(SEP, "/"): np.array(data[k]) for k in order}
    return leaves, meta
