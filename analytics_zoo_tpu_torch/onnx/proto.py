"""Minimal pure-python ONNX protobuf codec (wire format), the JAX
package's ``onnx/proto.py`` copied (numpy only).

The loader decodes the protobuf wire format directly for the message
subset an importer needs — ModelProto / GraphProto / NodeProto /
AttributeProto / TensorProto / ValueInfoProto — so no ``onnx`` package is
needed.  Field numbers follow the public onnx.proto spec.  The encoder for
the same subset writes the JAX package's bytes; it joins the parts once
instead of growing one ``bytes`` object, so a model of several hundred MB
encodes in linear time.  ``raw_data`` is read with ``np.frombuffer``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# -- wire-format primitives --------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(v: int) -> bytes:
    out = bytearray()
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a message's bytes."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        fnum, wtype = key >> 3, key & 7
        if wtype == 0:                       # varint
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:                     # 64-bit
            val = buf[pos:pos + 8]
            pos += 8
        elif wtype == 2:                     # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wtype == 5:                     # 32-bit
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def _key(fnum: int, wtype: int) -> bytes:
    return _write_varint((fnum << 3) | wtype)


def _ld(fnum: int, payload: bytes) -> bytes:
    return _key(fnum, 2) + _write_varint(len(payload)) + payload


def _signed(v: int) -> int:
    """Two's-complement interpretation of a 64-bit varint."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _varints(wtype: int, val) -> List[int]:
    """Repeated-varint field values: proto3 serializers PACK repeated
    ints (wire type 2, the default for onnx files produced by protoc /
    the onnx package), while proto2-era writers emit one varint per
    element — accept both."""
    if wtype == 2:
        out, pos = [], 0
        while pos < len(val):
            v, pos = _read_varint(val, pos)
            out.append(_signed(v))
        return out
    return [_signed(val)]


# -- message dataclasses -----------------------------------------------------

_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 5: np.int16,
           6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16,
           11: np.float64, 12: np.uint32, 13: np.uint64}
_DTYPE_IDS = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclass
class Tensor:
    name: str = ""
    dims: Tuple[int, ...] = ()
    data_type: int = 1
    array: Optional[np.ndarray] = None


@dataclass
class Attribute:
    name: str = ""
    type: int = 0      # 1 f, 2 i, 3 s, 4 t, 6 floats, 7 ints, 8 strings
    value: Any = None


@dataclass
class Node:
    op_type: str = ""
    name: str = ""
    inputs: List[str] = field(default_factory=list)
    outputs: List[str] = field(default_factory=list)
    attrs: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ValueInfo:
    name: str = ""
    elem_type: int = 1
    shape: Tuple[Optional[int], ...] = ()


@dataclass
class Graph:
    name: str = ""
    nodes: List[Node] = field(default_factory=list)
    initializers: List[Tensor] = field(default_factory=list)
    inputs: List[ValueInfo] = field(default_factory=list)
    outputs: List[ValueInfo] = field(default_factory=list)


@dataclass
class Model:
    ir_version: int = 8
    producer: str = ""
    opset: int = 13
    graph: Graph = field(default_factory=Graph)


# -- decoding ----------------------------------------------------------------

def _decode_tensor(buf: bytes) -> Tensor:
    t = Tensor()
    dims: List[int] = []
    floats: List[float] = []
    ints: List[int] = []
    raw = b""
    for fnum, wtype, val in _fields(buf):
        if fnum == 1:            # dims (packed by proto3 serializers)
            dims.extend(_varints(wtype, val))
        elif fnum == 2:
            t.data_type = val
        elif fnum == 4:          # packed float_data
            floats.extend(struct.unpack(f"<{len(val) // 4}f", val)) \
                if wtype == 2 else floats.append(
                    struct.unpack("<f", val)[0])
        elif fnum in (5, 7):     # int32_data / int64_data (packed varints)
            ints.extend(_varints(wtype, val))
        elif fnum == 8:
            t.name = val.decode()
        elif fnum == 9:
            raw = val
        elif fnum == 10:         # packed double_data
            floats.extend(struct.unpack(f"<{len(val) // 8}d", val)) \
                if wtype == 2 else floats.append(
                    struct.unpack("<d", val)[0])
    t.dims = tuple(dims)
    dtype = _DTYPES.get(t.data_type, np.float32)
    if raw:
        t.array = np.frombuffer(raw, dtype=dtype).reshape(t.dims).copy()
    elif floats:
        t.array = np.asarray(floats, dtype=dtype).reshape(t.dims)
    elif ints:
        t.array = np.asarray(ints, dtype=dtype).reshape(t.dims)
    else:
        t.array = np.zeros(t.dims, dtype=dtype)
    return t


def _decode_attr(buf: bytes) -> Attribute:
    a = Attribute()
    floats: List[float] = []
    ints: List[int] = []
    strings: List[bytes] = []
    for fnum, wtype, val in _fields(buf):
        if fnum == 1:
            a.name = val.decode()
        elif fnum == 2:
            a.value = struct.unpack("<f", val)[0]
            a.type = a.type or 1
        elif fnum == 3:
            a.value = _signed(val)
            a.type = a.type or 2
        elif fnum == 4:
            a.value = val
            a.type = a.type or 3
        elif fnum == 5:
            a.value = _decode_tensor(val)
            a.type = a.type or 4
        elif fnum == 7:
            if wtype == 2:
                floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
            else:
                floats.append(struct.unpack("<f", val)[0])
        elif fnum == 8:
            ints.extend(_varints(wtype, val))
        elif fnum == 9:
            strings.append(val)
        elif fnum == 20:
            a.type = val
    if floats:
        a.value, a.type = floats, 6
    elif ints:
        a.value, a.type = ints, 7
    elif strings:
        a.value, a.type = strings, 8
    return a


def _decode_node(buf: bytes) -> Node:
    n = Node()
    for fnum, _, val in _fields(buf):
        if fnum == 1:
            n.inputs.append(val.decode())
        elif fnum == 2:
            n.outputs.append(val.decode())
        elif fnum == 3:
            n.name = val.decode()
        elif fnum == 4:
            n.op_type = val.decode()
        elif fnum == 5:
            a = _decode_attr(val)
            n.attrs[a.name] = a.value
    return n


def _decode_value_info(buf: bytes) -> ValueInfo:
    vi = ValueInfo()
    for fnum, _, val in _fields(buf):
        if fnum == 1:
            vi.name = val.decode()
        elif fnum == 2:          # TypeProto
            for f2, _, v2 in _fields(val):
                if f2 == 1:      # tensor_type
                    for f3, _, v3 in _fields(v2):
                        if f3 == 1:
                            vi.elem_type = v3
                        elif f3 == 2:    # TensorShapeProto
                            dims: List[Optional[int]] = []
                            for f4, _, v4 in _fields(v3):
                                if f4 == 1:      # dim
                                    dim_val: Optional[int] = None
                                    for f5, _, v5 in _fields(v4):
                                        if f5 == 1:
                                            dim_val = _signed(v5)
                                    dims.append(dim_val)
                            vi.shape = tuple(dims)
    return vi


def _decode_graph(buf: bytes) -> Graph:
    g = Graph()
    for fnum, _, val in _fields(buf):
        if fnum == 1:
            g.nodes.append(_decode_node(val))
        elif fnum == 2:
            g.name = val.decode()
        elif fnum == 5:
            g.initializers.append(_decode_tensor(val))
        elif fnum == 11:
            g.inputs.append(_decode_value_info(val))
        elif fnum == 12:
            g.outputs.append(_decode_value_info(val))
    return g


def decode_model(buf: bytes) -> Model:
    m = Model()
    for fnum, _, val in _fields(buf):
        if fnum == 1:
            m.ir_version = val
        elif fnum == 2:
            m.producer = val.decode()
        elif fnum == 7:
            m.graph = _decode_graph(val)
        elif fnum == 8:          # opset_import
            for f2, _, v2 in _fields(val):
                if f2 == 2:
                    m.opset = _signed(v2)
    return m


# -- encoding (tests / export) ----------------------------------------------

def _encode_tensor(t: Tensor) -> bytes:
    out = [_key(1, 0) + _write_varint(d) for d in t.dims]
    out.append(_key(2, 0) + _write_varint(t.data_type))
    if t.array is not None:
        out.append(_ld(9, np.ascontiguousarray(t.array).tobytes()))
    if t.name:
        out.append(_ld(8, t.name.encode()))
    return b"".join(out)


def _encode_attr(name: str, value: Any) -> bytes:
    out = [_ld(1, name.encode())]
    if isinstance(value, (float, np.floating)):
        out += [_key(2, 5) + struct.pack("<f", float(value)),
                _key(20, 0) + _write_varint(1)]
    elif isinstance(value, (bool, int, np.integer)):
        out += [_key(3, 0) + _write_varint(int(value)),
                _key(20, 0) + _write_varint(2)]
    elif isinstance(value, (bytes, str)):
        out += [_ld(4, value.encode() if isinstance(value, str) else value),
                _key(20, 0) + _write_varint(3)]
    elif isinstance(value, Tensor):
        out += [_ld(5, _encode_tensor(value)),
                _key(20, 0) + _write_varint(4)]
    elif isinstance(value, (list, tuple, np.ndarray)) and len(value) \
            and any(isinstance(v, (float, np.floating)) for v in value) \
            and all(isinstance(v, (int, float, np.integer, np.floating))
                    for v in value):
        # any float promotes the whole list to FLOATS (lossless); pure
        # ints stay INTS below
        out += [_key(7, 5) + struct.pack("<f", float(v)) for v in value]
        out.append(_key(20, 0) + _write_varint(6))
    elif isinstance(value, (list, tuple, np.ndarray)):
        out += [_key(8, 0) + _write_varint(int(v)) for v in value]
        out.append(_key(20, 0) + _write_varint(7))
    else:
        raise ValueError(f"unsupported attribute value {value!r}")
    return b"".join(out)


def _encode_node(n: Node) -> bytes:
    out = [_ld(1, i.encode()) for i in n.inputs]
    out += [_ld(2, o.encode()) for o in n.outputs]
    if n.name:
        out.append(_ld(3, n.name.encode()))
    out.append(_ld(4, n.op_type.encode()))
    out += [_ld(5, _encode_attr(k, v)) for k, v in n.attrs.items()]
    return b"".join(out)


def _encode_value_info(vi: ValueInfo) -> bytes:
    dims = b"".join(
        _ld(1, b"" if d is None else _key(1, 0) + _write_varint(d))
        for d in vi.shape)
    tensor_type = (_key(1, 0) + _write_varint(vi.elem_type)
                   + _ld(2, dims))
    return _ld(1, vi.name.encode()) + _ld(2, _ld(1, tensor_type))


def _encode_graph(g: Graph) -> bytes:
    out = [_ld(1, _encode_node(n)) for n in g.nodes]
    if g.name:
        out.append(_ld(2, g.name.encode()))
    out += [_ld(5, _encode_tensor(t)) for t in g.initializers]
    out += [_ld(11, _encode_value_info(vi)) for vi in g.inputs]
    out += [_ld(12, _encode_value_info(vi)) for vi in g.outputs]
    return b"".join(out)


def encode_model(m: Model) -> bytes:
    out = [_key(1, 0) + _write_varint(m.ir_version)]
    if m.producer:
        out.append(_ld(2, m.producer.encode()))
    out.append(_ld(7, _encode_graph(m.graph)))
    opset = _ld(1, b"") + _key(2, 0) + _write_varint(m.opset)
    out.append(_ld(8, opset))
    return b"".join(out)


def tensor_from_array(name: str, arr: np.ndarray) -> Tensor:
    arr = np.asarray(arr)
    return Tensor(name=name, dims=arr.shape,
                  data_type=_DTYPE_IDS[arr.dtype], array=arr)
