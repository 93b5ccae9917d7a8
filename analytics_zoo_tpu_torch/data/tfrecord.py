"""TFRecord IO + tf.Example parsing — no TensorFlow dependency (the JAX
package's module, copied: files written by either package are the same
bytes and read in both).

Reference capability: ``TFDataset.from_tfrecord_file``
(pyzoo/zoo/tfpark/tf_dataset.py:458) read TFRecords through a TF graph
per partition.  Here the record framing (length + masked crc32c headers)
is read/written directly — checksums via the native crc32c when built
(native/zoo_native.cpp), python table fallback otherwise — and
``tf.Example`` protos are decoded with the same minimal wire-format
machinery as the ONNX importer (onnx/proto.py).
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Sequence, Union

import numpy as np

from analytics_zoo_tpu_torch.native import masked_crc32c
from analytics_zoo_tpu_torch.onnx.proto import (_fields, _key, _ld,
                                                _read_varint, _signed,
                                                _write_varint)

__all__ = ["write_tfrecords", "read_tfrecords", "parse_example",
           "make_example", "read_example_file"]


# ---------------------------------------------------------------------------
# record framing:  [len u64][masked_crc(len) u32][data][masked_crc(data) u32]
# ---------------------------------------------------------------------------

def write_tfrecords(path: str, records: Sequence[bytes]) -> None:
    with open(path, "wb") as f:
        for rec in records:
            header = struct.pack("<Q", len(rec))
            f.write(header)
            f.write(struct.pack("<I", masked_crc32c(header)))
            f.write(rec)
            f.write(struct.pack("<I", masked_crc32c(rec)))


def read_tfrecords(path: str, verify: bool = True) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if not header:
                return
            if len(header) < 8:
                raise ValueError("truncated TFRecord: partial length header")
            (length,) = struct.unpack("<Q", header)
            hbuf = f.read(4)
            data = f.read(length)
            dbuf = f.read(4)
            if len(hbuf) < 4 or len(data) < length or len(dbuf) < 4:
                raise ValueError("truncated TFRecord: partial record")
            if verify:
                if masked_crc32c(header) != struct.unpack("<I", hbuf)[0]:
                    raise ValueError("corrupt TFRecord length header")
                if masked_crc32c(data) != struct.unpack("<I", dbuf)[0]:
                    raise ValueError("corrupt TFRecord payload")
            yield data


# ---------------------------------------------------------------------------
# tf.Example encode/decode (proto wire format; field numbers from the
# public example.proto/feature.proto spec)
#   Example{ features: 1 = Features{ feature: 1 = map<string, Feature> } }
#   Feature{ bytes_list: 1, float_list: 2, int64_list: 3 }
#   *List{ value: 1 (repeated / packed) }
# ---------------------------------------------------------------------------

FeatureValue = Union[np.ndarray, List[bytes]]


def _decode_list(buf: bytes, kind: str) -> FeatureValue:
    vals: List = []
    for fnum, wtype, val in _fields(buf):
        if fnum != 1:
            continue
        if kind == "bytes":
            vals.append(val)
        elif kind == "float":
            if wtype == 2:      # packed
                vals.extend(struct.unpack(f"<{len(val) // 4}f", val))
            else:
                vals.append(struct.unpack("<f", val)[0])
        else:                   # int64
            if wtype == 2:      # packed varints
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    vals.append(_signed(v))
            else:
                vals.append(_signed(val))
    if kind == "bytes":
        return vals
    return np.asarray(vals,
                      np.float32 if kind == "float" else np.int64)


def _decode_feature(buf: bytes) -> FeatureValue:
    for fnum, _, val in _fields(buf):
        if fnum == 1:
            return _decode_list(val, "bytes")
        if fnum == 2:
            return _decode_list(val, "float")
        if fnum == 3:
            return _decode_list(val, "int64")
    return np.asarray([], np.float32)


def parse_example(buf: bytes) -> Dict[str, FeatureValue]:
    """tf.Example bytes -> {name: ndarray | [bytes]}."""
    out: Dict[str, FeatureValue] = {}
    for fnum, _, val in _fields(buf):               # Example
        if fnum != 1:
            continue
        for f2, _, fmap in _fields(val):            # Features
            if f2 != 1:
                continue
            name, feat = None, None
            for f3, _, v3 in _fields(fmap):         # map entry
                if f3 == 1:
                    name = v3.decode()
                elif f3 == 2:
                    feat = v3
            if name is not None and feat is not None:
                out[name] = _decode_feature(feat)
    return out


def make_example(features: Dict[str, FeatureValue]) -> bytes:
    """{name: array | [bytes]} -> tf.Example bytes (for tests/export)."""
    entries = b""
    for name, value in features.items():
        if isinstance(value, (list, tuple)) and value \
                and isinstance(value[0], (bytes, str)):
            payload = b"".join(
                _ld(1, v.encode() if isinstance(v, str) else v)
                for v in value)
            feat = _ld(1, payload)                  # bytes_list
        else:
            arr = np.asarray(value)
            if np.issubdtype(arr.dtype, np.floating):
                packed = struct.pack(f"<{arr.size}f",
                                     *arr.astype(np.float32).ravel())
                feat = _ld(2, _ld(1, packed))       # float_list packed
            else:
                payload = b"".join(
                    _key(1, 0) + _write_varint(int(v))
                    for v in arr.ravel())
                feat = _ld(3, payload)              # int64_list
        entries += _ld(1, _ld(1, name.encode()) + _ld(2, feat))
    return _ld(1, entries)                          # Example.features


def read_example_file(path: str) -> List[Dict[str, FeatureValue]]:
    """Parse every tf.Example in a TFRecord file
    (the from_tfrecord_file capability, tf_dataset.py:458)."""
    return [parse_example(rec) for rec in read_tfrecords(path)]
