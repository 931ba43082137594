"""Minimal writer of TensorFlow TensorBundle checkpoints (numpy only).

Writes the layout that ``io/tf_checkpoint.py`` reads (in both packages):
a ``.data-00000-of-00001`` shard holding the tensors' bytes back to back,
and an ``.index`` table of one data block (keys in order, no prefix
sharing, one restart), one index block, an empty meta-index block (each
block followed by a compression byte of 0 and four bytes where a CRC would
go) and the 48-byte footer ending in the magic 0xdb4775248b80fb57. The
data block maps "" to a BundleHeaderProto (one shard) and each tensor's
name to a BundleEntryProto: dtype, shape, shard 0, offset and size.

``keras_conv1_bigru3_tensors`` names a flax-shaped conv1_bigru3 parameter
tree as the reference's Keras Sequential checkpoint does
(``layer_with_weights-N/...``), the inverse of
``load_keras_conv1_bigru3``. Usage from Python::

    from tools.tf_bundle import keras_conv1_bigru3_tensors, write_bundle
    write_bundle("ckpt/checkpoint-0", keras_conv1_bigru3_tensors(tree))
"""
from __future__ import annotations

import os
import struct

import numpy as np

TABLE_MAGIC = 0xDB4775248B80FB57
SUFFIX = "/.ATTRIBUTES/VARIABLE_VALUE"
_DTYPE_CODES = {np.dtype(np.float32): 1, np.dtype(np.float64): 2,
                np.dtype(np.int32): 3, np.dtype(np.int64): 9}


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint(num << 3 | wire)


def _entry_proto(dtype_code: int, shape, offset: int, size: int) -> bytes:
    dims = b"".join(
        _field(2, 2) + _varint(len(d)) + d
        for d in (_field(1, 0) + _varint(int(s)) for s in shape))
    return (_field(1, 0) + _varint(dtype_code)
            + _field(2, 2) + _varint(len(dims)) + dims
            + _field(3, 0) + _varint(0)
            + _field(4, 0) + _varint(offset)
            + _field(5, 0) + _varint(size))


def _block(items) -> bytes:
    """A table block: every key whole (shared prefix 0), one restart at 0,
    then the 5-byte trailer (no compression, CRC not written)."""
    body = b"".join(_varint(0) + _varint(len(k)) + _varint(len(v)) + k + v
                    for k, v in items)
    return body + struct.pack("<II", 0, 1)


def write_bundle(prefix: str, tensors: dict) -> None:
    """Write ``tensors`` (name -> numpy array) as the bundle ``prefix``."""
    os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
    data, items = bytearray(), []
    for name in sorted(tensors):
        a = np.ascontiguousarray(tensors[name])
        if a.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name}: dtype {a.dtype} not written")
        items.append((name.encode(), _entry_proto(
            _DTYPE_CODES[a.dtype], a.shape, len(data), a.nbytes)))
        data += a.tobytes()
    with open(prefix + ".data-00000-of-00001", "wb") as f:
        f.write(bytes(data))
    header = _field(1, 0) + _varint(1)  # BundleHeaderProto.num_shards
    trailer = b"\x00" + b"\x00" * 4
    data_block = _block([(b"", header)] + items)
    index = bytearray(data_block + trailer)
    last_key = items[-1][0] if items else b""
    index_off = len(index)
    index_block = _block([(last_key, _varint(0) + _varint(len(data_block)))])
    index += index_block + trailer
    meta_off = len(index)
    meta_block = _block([])
    index += meta_block + trailer
    handles = (_varint(meta_off) + _varint(len(meta_block))
               + _varint(index_off) + _varint(len(index_block)))
    index += handles + b"\x00" * (40 - len(handles))
    index += struct.pack("<Q", TABLE_MAGIC)
    with open(prefix + ".index", "wb") as f:
        f.write(bytes(index))


def keras_conv1_bigru3_tensors(tree: dict) -> dict:
    """The Keras checkpoint names of a conv1_bigru3 parameter tree (flax
    layout, numpy arrays): conv0, three BiGRUs (each direction's GRU bias
    as Keras' [2, 3H] of input and recurrent biases) and the dense layer."""
    out = {
        "layer_with_weights-0/kernel": tree["conv0"]["kernel"],
        "layer_with_weights-0/bias": tree["conv0"]["bias"],
        "layer_with_weights-4/kernel": tree["dense"]["kernel"],
        "layer_with_weights-4/bias": tree["dense"]["bias"],
    }
    for i in range(3):
        for direction in ("forward", "backward"):
            cell = tree[f"bigru{i}"][direction]["cell"]
            base = f"layer_with_weights-{i + 1}/{direction}_layer/cell"
            out[base + "/kernel"] = cell["kernel"]
            out[base + "/recurrent_kernel"] = cell["recurrent_kernel"]
            out[base + "/bias"] = np.stack([cell["input_bias"],
                                            cell["recurrent_bias"]])
    return {k + SUFFIX: np.asarray(v, np.float32) for k, v in out.items()}
