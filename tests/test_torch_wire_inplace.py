"""The port's wire reader reads a blob's stored npz members in place.

Every reader of a blob opens it once: the zip's central directory locates
each stored, C-order member, whose CRC-32 is checked over its bytes in the
blob; any other member is read as ``np.load`` reads it. ``decode_params_flat``
copies a full update's in-place leaves once into the flat (span
``decode.inplace``). These tests hold the flat decode, bit for bit, to a flat
built from ``np.load``'s arrays and to the reference package, on every blob
shape the wire carries; check that deflated, quantized, Fortran-order and
big-endian blobs, and headers numpy does not write, decode outside that span;
that a flipped byte fails the CRC as ``np.load`` does; and that the tree
readers, on the stored, deflated and zstd envelopes, equal ``np.load`` and
the reference and hand out arrays that own their memory.
"""
from __future__ import annotations

import io
import json
import struct
import zipfile

import numpy as np
import pytest
import torch

from portbench.reference import wire
from repro.core import serialize as jser
from repro.core.serialize import NodeUpdate as JNodeUpdate
from repro_torch.core import serialize as tser
from repro_torch.core.serialize import NodeUpdate
from repro_torch.core.telemetry import Telemetry

META = {"num_examples": 7, "node_id": "peer", "counter": 3, "timestamp": 1.5,
        "metrics": {"loss": 0.25}, "lease_epoch": 0}


def _leaves(rng) -> dict:
    """A small tree with one leaf larger than a copy chunk."""
    return {"conv": {"w": rng.normal(size=(3, 3, 2, 4)).astype(np.float32),
                     "b": rng.normal(size=(4,)).astype(np.float32)},
            "dense": {"w": rng.normal(size=(300, 300)).astype(np.float32)}}


def _npy(arr: np.ndarray, version=None) -> bytes:
    buf = io.BytesIO()
    np.lib.format.write_array(buf, arr, version=version)
    return buf.getvalue()


def _zip_blob(members: dict[str, bytes], meta: dict, order: list[str], dtypes=None) -> bytes:
    """A stored zip of ``.npy`` members written by hand, ``__meta__`` last."""
    meta = dict(meta, __order__=order, __dtypes__=dtypes or {})
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        for key, data in members.items():
            z.writestr(key + ".npy", data)
        z.writestr("__meta__.npy", _npy(np.frombuffer(json.dumps(meta).encode(), np.uint8)))
    return buf.getvalue()


def _packed(arrays: dict[str, np.ndarray], compress: str = "none") -> bytes:
    return tser._pack_npz(dict(arrays), list(arrays), {}, dict(META), compress=compress)


def _blob_f32(rng):
    return tser.serialize_update(NodeUpdate(_leaves(rng), **META))


def _blob_narrow(rng):
    tree = _leaves(rng)
    tree["conv"]["w"] = torch.from_numpy(tree["conv"]["w"]).to(torch.bfloat16)
    tree["conv"]["b"] = torch.from_numpy(tree["conv"]["b"]).to(torch.float8_e4m3fn)
    blob = tser.serialize_update(NodeUpdate(tree, **META))
    assert set(tser.peek_meta(blob)["__dtypes__"].values()) == {"bfloat16", "float8_e4m3fn"}
    return blob


def _blob_f16(rng):
    tree = _leaves(rng)
    tree["conv"]["w"] = tree["conv"]["w"].astype(np.float16)
    return tser.serialize_update(NodeUpdate(tree, **META))


def _blob_scalar_and_empty(rng):
    tree = _leaves(rng)
    tree["scale"] = np.float32(rng.normal())
    tree["none"] = np.zeros((0, 5), np.float32)
    return tser.serialize_update(NodeUpdate(tree, **META))


def _blob_meta_appended(rng):
    leaves = {"conv/w": rng.normal(size=(64, 3, 3, 3)).astype(np.float32),
              "conv/gn/scale": np.ones(64, np.float32),
              "fc/w": rng.normal(size=(512, 10)).astype(np.float32)}
    return wire.write_update(leaves, node_id="peer", counter=3, num_examples=7,
                             dtypes={"conv/w": "bfloat16"})


def _blob_zstd(rng):
    return tser.serialize_update(NodeUpdate(_leaves(rng), **META), compress="zstd")


def _blob_jax_writer(rng):
    return jser.serialize_update(JNodeUpdate(_leaves(rng), num_examples=7, node_id="jax",
                                             counter=3, timestamp=1.5))


def _blob_npy_version(version):
    def make(rng):
        arrays = {"a": rng.normal(size=(5, 6)).astype(np.float32),
                  "b": rng.normal(size=(70000,)).astype(np.float32)}
        return _zip_blob({k: _npy(a, version) for k, a in arrays.items()}, META, list(arrays))
    return make


def _blob_header_reordered(rng):
    """A header np.load reads but numpy does not write (keys in another
    order, no padding): read through np.load."""
    arr = rng.normal(size=(4, 3)).astype(np.float32)
    head = b"{'shape': (4, 3), 'descr': '<f4', 'fortran_order': False}\n"
    npy = b"\x93NUMPY\x01\x00" + len(head).to_bytes(2, "little") + head + arr.tobytes()
    return _zip_blob({"w": npy}, META, ["w"])


IN_PLACE = {
    "f32": _blob_f32,
    "bf16_fp8_as_f32": _blob_narrow,
    "f16": _blob_f16,
    "scalar_and_empty": _blob_scalar_and_empty,
    "meta_appended": _blob_meta_appended,
    "zstd": _blob_zstd,
    "jax_writer": _blob_jax_writer,
    "npy_v1": _blob_npy_version((1, 0)),
    "npy_v2": _blob_npy_version((2, 0)),
    "npy_v3": _blob_npy_version((3, 0)),
}


def _fortran(rng):
    w = np.asfortranarray(rng.normal(size=(6, 5)).astype(np.float32))
    return _packed({"w": w, "b": rng.normal(size=(5,)).astype(np.float32)})


def _big_endian(rng):
    return _packed({"w": rng.normal(size=(6, 5)).astype(">f4"),
                    "b": rng.normal(size=(5,)).astype(np.float32)})


FALLBACK = {
    "npz": lambda rng: tser.serialize_update(NodeUpdate(_leaves(rng), **META), compress="npz"),
    "quantized": lambda rng: tser.serialize_update_quantized(NodeUpdate(_leaves(rng), **META)),
    "fortran_order": _fortran,
    "big_endian": _big_endian,
    "header_reordered": _blob_header_reordered,
}


def _decode_traced(blob: bytes, specs: dict):
    """decode_params_flat inside a ``decode`` span, as the pipeline calls it;
    -> (spec, flat, meta, names of the spans recorded under it)."""
    tel = Telemetry("n", enabled=True)
    with tel.span("decode"):
        out = tser.decode_params_flat(blob, specs)
    return (*out, [name for name, *_ in tel.recorder.drain()])


def _np_load(blob: bytes) -> tuple[dict, dict[str, np.ndarray]]:
    """(the ``__meta__`` entry as written, every other member) read by np.load."""
    with np.load(io.BytesIO(jser.maybe_decompress(blob))) as data:
        return (json.loads(data["__meta__"].tobytes()),
                {k: data[k] for k in data.files if k != "__meta__"})


def _assert_flat_as_np_load(decoded, blob: bytes):
    """``decoded`` (spec, flat, meta) against the reference package's flat
    decode and a flat built here from np.load's arrays in that spec's leaf
    order, dequantized where the blob is quantized."""
    spec, flat, meta = decoded
    j_spec, j_flat, j_meta = jser.decode_params_flat(blob, {})
    assert spec.key == j_spec.key and spec.paths == j_spec.paths
    header, arrays = _np_load(blob)
    order = header.pop("__order__")
    header.pop("__dtypes__", None)
    leaves = []
    for path, shape in zip(j_spec.paths, j_spec.shapes):
        k = path.replace("/", "|")
        assert k in order or "q|" + k in order
        a = (arrays["q|" + k].astype(np.float32) * np.float32(arrays["s|" + k])
             if header.get("quantized") else arrays[k].astype(np.float32))
        assert a.shape == tuple(shape)
        leaves.append(a.reshape(-1))
    expected = np.concatenate(leaves) if leaves else np.zeros(0, np.float32)
    assert flat.dtype == np.float32
    for other in (expected, j_flat):
        np.testing.assert_array_equal(flat.view(np.uint32), other.view(np.uint32))
    assert meta == header == j_meta


@pytest.mark.parametrize("case", sorted(IN_PLACE))
def test_in_place_read_equals_np_load_bit_for_bit(case):
    blob = IN_PLACE[case](np.random.default_rng(len(case)))
    specs: dict = {}
    spec, flat, meta, names = _decode_traced(blob, specs)
    assert names.count("decode.inplace") == 1
    _assert_flat_as_np_load((spec, flat, meta), blob)
    # the interned spec is reused
    again, flat2, _ = tser.decode_params_flat(blob, specs)
    assert again is spec and flat2 is not flat
    assert tser.peek_meta(blob) == jser.peek_meta(jser.maybe_decompress(blob))


@pytest.mark.parametrize("case", sorted(FALLBACK))
def test_fallbacks_decode_as_before_through_np_load(case):
    blob = FALLBACK[case](np.random.default_rng(len(case)))
    spec, flat, meta, names = _decode_traced(blob, {})
    assert "decode.inplace" not in names
    _assert_flat_as_np_load((spec, flat, meta), blob)


def _member_data(blob: bytes, key: str) -> tuple[int, int]:
    """(first, last + 1) byte of stored member ``key``'s array data in the blob."""
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        info = z.getinfo(key + ".npy")
    n_name, n_extra = struct.unpack_from("<26xHH", blob, info.header_offset)
    start = info.header_offset + 30 + n_name + n_extra
    npy = io.BytesIO(blob[start:start + info.file_size])
    np.lib.format.read_array_header_1_0(npy) if np.lib.format.read_magic(npy) == (1, 0) \
        else np.lib.format.read_array_header_2_0(npy)
    return start + npy.tell(), start + info.file_size


@pytest.mark.parametrize("key,where", [("conv|b", "first"), ("dense|w", "middle"),
                                       ("dense|w", "last"), ("__meta__", "middle")])
def test_a_flipped_byte_fails_the_crc(key, where):
    blob = bytearray(_blob_f32(np.random.default_rng(9)))
    a, b = _member_data(bytes(blob), key)
    at = {"first": a, "middle": (a + b) // 2, "last": b - 1}[where]
    blob[at] ^= 0x10
    blob = bytes(blob)
    for read in (lambda: tser.decode_params_flat(blob, {}), lambda: tser.deserialize_params(blob),
                 lambda: np.load(io.BytesIO(blob))[key]):
        with pytest.raises(zipfile.BadZipFile, match="CRC"):
            read()
    if key == "__meta__":
        with pytest.raises(zipfile.BadZipFile, match="CRC"):
            tser.peek_meta(blob)


# --- the tree readers, on each envelope ---------------------------------------


def _by_key(tree, prefix="") -> dict:
    """A nested-dict tree's leaves under their wire keys ('a|b')."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_by_key(v, prefix + k + "|"))
        else:
            out[prefix + k] = v
    return out


def _owns_memory(a: np.ndarray) -> bool:
    """Writable, and its memory is an array's own (never a view of a blob)."""
    writable = a.flags.writeable
    while isinstance(a.base, np.ndarray):
        a = a.base
    return writable and a.flags.owndata


def _assert_tree(tree: dict, *expected: dict):
    got = _by_key(tree)
    for exp in expected:
        assert set(got) == set(exp)
        for k, a in got.items():
            assert isinstance(a, np.ndarray) and _owns_memory(a), k
            assert a.dtype == exp[k].dtype and a.shape == exp[k].shape, k
            assert a.tobytes() == exp[k].tobytes(), k


def _tree(rng) -> dict:
    """Leaves of every width a flat decode refuses or accepts."""
    return {"conv": {"w": rng.normal(size=(3, 3, 2, 4)).astype(np.float32),
                     "b": rng.normal(size=(4,)).astype(np.float16)},
            "dense": {"w": rng.normal(size=(300, 300)).astype(np.float32)},
            "steps": np.arange(6, dtype=np.int32).reshape(2, 3),
            "scale": np.float64(rng.normal())}


def _float_tree(rng) -> dict:
    tree = _tree(rng)
    del tree["steps"], tree["scale"]
    return tree


def _next(tree: dict, rng) -> dict:
    """``tree`` with a sparse change in one leaf and every entry of another changed."""
    new = {"conv": {"w": tree["conv"]["w"] + 1, "b": tree["conv"]["b"].copy()},
           "dense": {"w": tree["dense"]["w"].copy()}}
    new["dense"]["w"][rng.integers(0, 300, 5), rng.integers(0, 300, 5)] = 7.0
    return new


def _delta(rng, compress):
    base = _float_tree(rng)
    base_blob = tser.serialize_update(NodeUpdate(base, **META), compress=compress)
    blob = tser.serialize_update_delta(NodeUpdate(_next(base, rng), **META), base,
                                       tser.content_hash(base_blob), compress=compress)
    return base, base_blob, blob


def _np_load_delta(blob: bytes, base: dict) -> dict:
    """The delta applied on ``base``, leaf by leaf, from np.load's arrays."""
    header, arrays = _np_load(blob)
    out = {}
    for k, b in _by_key(base).items():
        if "d|" + k in arrays:
            out[k] = arrays["d|" + k]
            continue
        flat = np.array(b).reshape(-1)
        flat[arrays["i|" + k]] = arrays["v|" + k]
        out[k] = flat.reshape(b.shape)
    return out


def _read_peek_meta(rng, compress):
    blob = tser.serialize_update(NodeUpdate(_tree(rng), **META), compress=compress)
    meta = tser.peek_meta(blob)
    assert meta == _np_load(blob)[0] == jser.peek_meta(jser.maybe_decompress(blob))
    assert meta["__order__"] and meta["node_id"] == "peer"


def _read_params(rng, compress):
    blob = tser.serialize_update(NodeUpdate(_tree(rng), **META), compress=compress)
    tree, meta = tser.deserialize_params(blob)
    j_tree, j_meta = jser.deserialize_params(blob)
    assert meta == j_meta and "__order__" not in meta
    _assert_tree(tree, _np_load(blob)[1], _by_key(j_tree))


def _read_quantized(rng, compress):
    blob = tser.serialize_update_quantized(NodeUpdate(_float_tree(rng), **META),
                                           compress=compress)
    upd, j_upd = tser.deserialize_update_quantized(blob), jser.deserialize_update_quantized(blob)
    assert (upd.node_id, upd.counter, upd.num_examples) == (j_upd.node_id, j_upd.counter, 7)
    arrays = _np_load(blob)[1]
    expected = {k[2:]: a.astype(np.float32) * np.float32(arrays["s|" + k[2:]])
                for k, a in arrays.items() if k.startswith("q|")}
    _assert_tree(upd.params, expected, _by_key(j_upd.params))


def _read_delta_flat(rng, compress):
    base, base_blob, blob = _delta(rng, compress)
    spec, base_flat, _ = tser.decode_params_flat(base_blob, {})
    flat = base_flat.copy()
    meta = tser.apply_update_delta_flat(blob, spec, flat)
    j_spec, j_flat, _ = jser.decode_params_flat(base_blob, {})
    j_meta = jser.apply_update_delta_flat(blob, j_spec, j_flat)
    assert meta == j_meta and meta["delta_of"] == tser.content_hash(base_blob)
    expected = _np_load_delta(blob, base)
    expected = np.concatenate([expected[p.replace("/", "|")].astype(np.float32).reshape(-1)
                               for p in spec.paths])
    for other in (expected, j_flat):
        np.testing.assert_array_equal(flat.view(np.uint32), other.view(np.uint32))


def _read_delta_tree(rng, compress):
    base, _, blob = _delta(rng, compress)
    header, arrays = _np_load(blob)
    assert any(k.startswith("d|") for k in arrays) and any(k.startswith("i|") for k in arrays)
    upd, j_upd = tser.deserialize_update_delta(blob, base), jser.deserialize_update_delta(blob, base)
    assert upd.metrics == j_upd.metrics and upd.counter == j_upd.counter
    _assert_tree(upd.params, _np_load_delta(blob, base), _by_key(j_upd.params))


TREE_READERS = {
    "peek_meta": _read_peek_meta,
    "deserialize_params": _read_params,
    "deserialize_update_quantized": _read_quantized,
    "apply_update_delta_flat": _read_delta_flat,
    "deserialize_update_delta": _read_delta_tree,
}


@pytest.mark.parametrize("compress", tser.COMPRESSIONS)
@pytest.mark.parametrize("reader", sorted(TREE_READERS))
def test_readers_equal_np_load_and_the_reference_on_every_envelope(reader, compress):
    TREE_READERS[reader](np.random.default_rng(len(reader)), compress)
