"""The port's flat decode reads a full update's stored npz members in place.

``decode_params_flat`` locates each stored, C-order leaf member from the zip's
central directory and its local header, checks the member's CRC-32 over its
bytes in the blob and copies the leaf once into the flat (span
``decode.inplace``). These tests hold that path to the ``np.load`` path it
replaces, bit for bit, on every blob shape the wire carries; check that
deflated, quantized, Fortran-order and big-endian blobs, and headers numpy
does not write, still take ``np.load``; and that a flipped byte fails the
CRC as ``np.load`` does.
"""
from __future__ import annotations

import io
import json
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


def _assert_same(a, b):
    (spec_a, flat_a, meta_a), (spec_b, flat_b, meta_b) = a, b
    assert spec_a.key == spec_b.key and spec_a.paths == spec_b.paths
    assert flat_a.dtype == flat_b.dtype == np.float32
    np.testing.assert_array_equal(flat_a.view(np.uint32), flat_b.view(np.uint32))
    assert meta_a == meta_b


@pytest.mark.parametrize("case", sorted(IN_PLACE))
def test_in_place_read_equals_np_load_bit_for_bit(case):
    blob = IN_PLACE[case](np.random.default_rng(len(case)))
    specs: dict = {}
    spec, flat, meta, names = _decode_traced(blob, specs)
    assert names.count("decode.inplace") == 1
    _assert_same((spec, flat, meta), tser._decode_params_flat_npz(tser.maybe_decompress(blob), {}))
    # the reference package's decode agrees, and the interned spec is reused
    j_spec, j_flat, j_meta = jser.decode_params_flat(blob, {})
    assert j_spec.key == spec.key and j_meta == meta
    np.testing.assert_array_equal(j_flat, flat)
    again, flat2, _ = tser.decode_params_flat(blob, specs)
    assert again is spec and flat2 is not flat
    assert tser.peek_meta(blob) == jser.peek_meta(jser.maybe_decompress(blob))


@pytest.mark.parametrize("case", sorted(FALLBACK))
def test_fallbacks_decode_as_before_through_np_load(case):
    blob = FALLBACK[case](np.random.default_rng(len(case)))
    assert tser._stored_leaves(tser.maybe_decompress(blob)) is None
    spec, flat, meta, names = _decode_traced(blob, {})
    assert "decode.inplace" not in names
    _assert_same((spec, flat, meta), tser._decode_params_flat_npz(blob, {}))
    j_spec, j_flat, _ = jser.decode_params_flat(blob, {})
    assert j_spec.key == spec.key
    np.testing.assert_array_equal(j_flat, flat)


def _member_data(blob: bytes, key: str) -> tuple[int, int]:
    """(first, last + 1) byte of member ``key``'s array data in the blob."""
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        m = tser._stored_array(blob, z, key)
    return m.data, m.end


@pytest.mark.parametrize("key,where", [("conv|b", "first"), ("dense|w", "middle"),
                                       ("dense|w", "last"), ("__meta__", "middle")])
def test_a_flipped_byte_fails_the_crc(key, where):
    blob = bytearray(_blob_f32(np.random.default_rng(9)))
    a, b = _member_data(bytes(blob), key)
    at = {"first": a, "middle": (a + b) // 2, "last": b - 1}[where]
    blob[at] ^= 0x10
    blob = bytes(blob)
    with pytest.raises(zipfile.BadZipFile, match="CRC"):
        tser.decode_params_flat(blob, {})
    with pytest.raises(zipfile.BadZipFile, match="CRC"):
        tser._decode_params_flat_npz(blob, {})
    if key == "__meta__":
        with pytest.raises(zipfile.BadZipFile, match="CRC"):
            tser.peek_meta(blob)
