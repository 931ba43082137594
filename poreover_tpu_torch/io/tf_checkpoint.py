"""Pure-Python reader for TensorFlow TensorBundle checkpoints.

The port's copy of ``poreover_tpu/io/tf_checkpoint.py`` (numpy only).
Lets ``call`` load the reference's bundled Keras weights
(reference data/model/checkpoint-124.{index,data-*}; loaded by the
reference at network.py:196-202 via model.load_weights) without TensorFlow.

Format notes (implemented from the public TF/LevelDB on-disk layouts):
- ``.index`` is a LevelDB-style table: blocks of prefix-compressed
  key/value records with a restart array, a top-level index block, and a
  48-byte footer ending in the magic 0xdb4775248b80fb57. Values are
  serialized BundleEntryProto messages.
- BundleEntryProto fields: 1 dtype (enum, 1=float32), 2 shape
  (TensorShapeProto: repeated Dim{ size=1 }), 3 shard_id, 4 offset,
  5 size, 6 crc.
- Tensor bytes live in ``.data-xxxxx-of-yyyyy`` shards at (offset, size).
"""
from __future__ import annotations

import glob
import os
import struct

import numpy as np

_TABLE_MAGIC = 0xDB4775248B80FB57

_DTYPES = {
    1: np.float32,
    2: np.float64,
    3: np.int32,
    4: np.uint8,
    5: np.int16,
    6: np.int8,
    7: object,  # string
    9: np.int64,
    10: np.bool_,
}


def _read_varint(buf: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


class _Block:
    """Prefix-compressed key/value block."""

    def __init__(self, data: bytes):
        (num_restarts,) = struct.unpack("<I", data[-4:])
        self.data = data[: len(data) - 4 - 4 * num_restarts]

    def items(self):
        pos = 0
        key = b""
        data = self.data
        while pos < len(data):
            shared, pos = _read_varint(data, pos)
            unshared, pos = _read_varint(data, pos)
            value_len, pos = _read_varint(data, pos)
            key = key[:shared] + data[pos : pos + unshared]
            pos += unshared
            value = data[pos : pos + value_len]
            pos += value_len
            yield key, value


def _read_block(buf: bytes, offset: int, size: int) -> bytes:
    # block contents followed by 1-byte compression type + 4-byte crc
    ctype = buf[offset + size]
    data = buf[offset : offset + size]
    if ctype == 0:
        return data
    if ctype == 1:  # snappy
        try:
            import snappy  # pragma: no cover

            return snappy.uncompress(data)
        except ImportError as e:  # pragma: no cover
            raise RuntimeError("snappy-compressed checkpoint block") from e
    raise RuntimeError(f"unknown block compression {ctype}")


def _parse_entry_proto(buf: bytes) -> dict:
    """Minimal protobuf parse of BundleEntryProto."""
    out = {"dtype": 0, "shape": [], "shard_id": 0, "offset": 0, "size": 0}
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
            if field == 1:
                out["dtype"] = val
            elif field == 3:
                out["shard_id"] = val
            elif field == 4:
                out["offset"] = val
            elif field == 5:
                out["size"] = val
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            sub = buf[pos : pos + ln]
            pos += ln
            if field == 2:  # TensorShapeProto
                spos = 0
                dims = []
                while spos < len(sub):
                    stag, spos = _read_varint(sub, spos)
                    sfield, swire = stag >> 3, stag & 7
                    if swire == 2 and sfield == 2:  # Dim message
                        dln, spos = _read_varint(sub, spos)
                        dim = sub[spos : spos + dln]
                        spos += dln
                        dpos = 0
                        while dpos < len(dim):
                            dtag, dpos = _read_varint(dim, dpos)
                            if dtag >> 3 == 1 and dtag & 7 == 0:
                                sz, dpos = _read_varint(dim, dpos)
                                dims.append(sz)
                            else:
                                break
                    elif swire == 0:
                        _, spos = _read_varint(sub, spos)
                    else:
                        break
                out["shape"] = dims
        elif wire == 5:
            pos += 4
        elif wire == 1:
            pos += 8
    return out


def _decode_handle(value: bytes):
    offset, pos = _read_varint(value, 0)
    size, _ = _read_varint(value, pos)
    return offset, size


class TFCheckpoint:
    """Read tensors from a TensorFlow bundle checkpoint prefix."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        with open(prefix + ".index", "rb") as f:
            buf = f.read()
        footer = buf[-48:]
        assert struct.unpack("<Q", footer[-8:])[0] == _TABLE_MAGIC, (
            "not a TensorBundle index file"
        )
        # footer: metaindex handle varints, then index handle varints
        moff, pos = _read_varint(footer, 0)
        msz, pos = _read_varint(footer, pos)
        ioff, pos = _read_varint(footer, pos)
        isz, pos = _read_varint(footer, pos)

        index_block = _Block(_read_block(buf, ioff, isz))
        self.entries: dict[str, dict] = {}
        for _key, handle in index_block.items():
            boff, bsz = _decode_handle(handle)
            for k, v in _Block(_read_block(buf, boff, bsz)).items():
                if k == b"":
                    continue  # BundleHeaderProto
                self.entries[k.decode()] = _parse_entry_proto(v)

        self.shards = {}
        for path in glob.glob(prefix + ".data-*"):
            shard_id = int(os.path.basename(path).split("-")[-3])
            self.shards[shard_id] = path

    def keys(self):
        return sorted(self.entries)

    def get(self, name: str) -> np.ndarray:
        e = self.entries[name]
        dtype = _DTYPES[e["dtype"]]
        with open(self.shards[e["shard_id"]], "rb") as f:
            f.seek(e["offset"])
            raw = f.read(e["size"])
        arr = np.frombuffer(raw, dtype=dtype)
        return arr.reshape(e["shape"])


_SUFFIX = "/.ATTRIBUTES/VARIABLE_VALUE"


def load_keras_conv1_bigru3(prefix: str) -> dict:
    """Map a Keras Sequential [Conv1D, 3x Bidirectional(GRU), Dense]
    object-based checkpoint into the flax-shaped parameter tree of
    PoreOverNet('conv1_bigru3') (numpy arrays;
    ``network/model.py:params_from_flax`` carries it onto the module)."""
    ckpt = TFCheckpoint(prefix)

    def g(name):
        return ckpt.get(name + _SUFFIX)

    def gru_params(base):
        kernel = g(base + "/kernel")          # [D, 3H], gate order z,r,n
        recurrent = g(base + "/recurrent_kernel")  # [H, 3H]
        bias = g(base + "/bias")              # [2, 3H] (input, recurrent)
        return dict(
            kernel=kernel,
            recurrent_kernel=recurrent,
            input_bias=bias[0],
            recurrent_bias=bias[1],
        )

    params = {
        "conv0": {
            "kernel": g("layer_with_weights-0/kernel"),
            "bias": g("layer_with_weights-0/bias"),
        },
        "dense": {
            "kernel": g("layer_with_weights-4/kernel"),
            "bias": g("layer_with_weights-4/bias"),
        },
    }
    for i in range(3):
        lw = f"layer_with_weights-{i + 1}"
        params[f"bigru{i}"] = {
            "forward": {"cell": gru_params(lw + "/forward_layer/cell")},
            "backward": {"cell": gru_params(lw + "/backward_layer/cell")},
        }
    return params
