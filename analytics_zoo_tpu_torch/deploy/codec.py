"""Binary tensor wire codec: framed ``dtype/shape/bytes`` records.

The legacy serving wire ships every tensor as
``ndarray → tobytes → base64 → JSON string`` and decodes it with the
mirror-image chain — ~2.7x the bytes on the wire and two full passes
over the payload in pure Python (the r05 bench measured the full queue
path at 27 imgs/s while the device side of the same model did
thousands).  This module replaces it with a length-prefixed binary
frame that moves raw bytes:

    AZB1 | u32 meta_len | meta-JSON | u32 n_tensors |
      [ u16 name_len | name | u16 dtype_len | dtype | u8 ndim |
        u64*ndim shape | u64 nbytes | pad→64 | raw bytes ] * n

``meta`` is the record minus its tensor fields (uri/ts/ttl_ms/fmt plus
any legacy JSON-safe payloads — backward-compat base64 dicts ride
through untouched).  Tensor payloads are 64-byte aligned so
:func:`unpack_record` can hand back ``np.frombuffer`` *views* into the
source buffer — decode is zero-copy: off a shared-memory slot the view
is copied once, into the serving bucket's pinned staging buffer, on its
way to the card.  Views are read-only by design (copy-on-write is explicit via
``copy=True`` / ``decode_tensor(writable=True)``); the
``serving/codec_tensor_copies`` counter makes every materialized copy
visible, which is how the zero-copy claim is test-verified rather than
asserted.

dtype fidelity: the dtype crosses the wire as its numpy name, so
``uint8`` records stay ``uint8`` end to end.  numpy cannot spell
``bfloat16`` (the JAX package borrows ``ml_dtypes``' type for it, which
this package does not use): a ``bfloat16`` payload unpacks to an array
of the structured dtype ``BFLOAT16`` — one 2-byte field holding the raw
bits, so no numpy op can mistake it for integers — that packs back under
the name ``bfloat16``, byte for byte the JAX frame.  ``bf16_to_torch``
and ``torch_to_bf16`` cross to and from ``torch.bfloat16``.  The format
is byte for byte the JAX package's.

Every pack/unpack reports ``serving_wire_bytes_total{codec=...}`` and
``serving_codec_seconds{codec,op}`` into the observe CATALOG so the
bench breakdown can attribute the wire share per codec.
"""

from __future__ import annotations

import json
import struct
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from analytics_zoo_tpu_torch.core.profiling import TIMERS
from analytics_zoo_tpu_torch.observe import metrics as obs

__all__ = ["MAGIC", "BFLOAT16", "pack_record", "pack_record_into",
           "packed_nbytes", "prepare_record", "unpack_record", "is_packed",
           "pack_result", "unpack_result", "wire_dtype", "wire_name",
           "bf16_to_torch", "torch_to_bf16"]

MAGIC = b"AZB1"
_ALIGN = 64
_HDR = struct.Struct("<4sI")       # magic, meta_len
_NT = struct.Struct("<I")          # n_tensors
_U16 = struct.Struct("<H")
_U64 = struct.Struct("<Q")


# bfloat16 as numpy sees it here: the raw bits in one named 2-byte field
BFLOAT16 = np.dtype([("bfloat16", "<u2")])


def wire_dtype(name: str) -> np.dtype:
    """Resolve a wire dtype name; ``bfloat16``, which numpy cannot spell,
    resolves to ``BFLOAT16``."""
    if name == "bfloat16":
        return BFLOAT16
    return np.dtype(name)


def wire_name(dt: np.dtype) -> str:
    """The wire name of a numpy dtype (``BFLOAT16`` → ``bfloat16``)."""
    return "bfloat16" if dt == BFLOAT16 else str(dt)


def bf16_to_torch(a: np.ndarray):
    """A ``BFLOAT16`` array as a ``torch.bfloat16`` tensor over the same
    bits (a view when ``a`` is contiguous)."""
    import torch

    bits = np.ascontiguousarray(a).view(np.int16)
    if not bits.flags.writeable:
        bits = bits.copy()
    return torch.from_numpy(bits).view(torch.bfloat16)


def torch_to_bf16(t) -> np.ndarray:
    """A ``torch.bfloat16`` tensor as a ``BFLOAT16`` numpy array of the
    same bits."""
    import torch

    bits = t.detach().cpu().contiguous().view(torch.int16).numpy()
    return bits.view(np.uint16).view(BFLOAT16).reshape(tuple(t.shape))


def _align(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


def _split(rec: Dict[str, Any]) -> Tuple[Dict[str, Any],
                                         List[Tuple[str, np.ndarray]]]:
    """Record → (JSON-safe meta, [(name, ndarray)]).  Only genuine
    ndarray values ride the binary frames; legacy ``{"b64": ...}``
    payloads and plain scalars stay in the meta JSON."""
    meta: Dict[str, Any] = {}
    tensors: List[Tuple[str, np.ndarray]] = []
    for k, v in rec.items():
        if k.startswith("_"):       # worker-side handles (spans etc.)
            continue
        if isinstance(v, np.ndarray):
            if v.dtype.hasobject:
                raise ValueError(f"field {k!r}: object dtype is not "
                                 "wire-encodable")
            tensors.append((k, v))
        else:
            meta[k] = v
    return meta, tensors


def _frame_sizes(meta_blob: bytes,
                 tensors: List[Tuple[str, np.ndarray]]) -> int:
    n = _HDR.size + len(meta_blob) + _NT.size
    for name, a in tensors:
        nb = name.encode("utf-8")
        n += _U16.size + len(nb) + _U16.size + len(wire_name(a.dtype))
        n += 1 + 8 * a.ndim + 8
        n = _align(n)
        n += a.nbytes
    return n


def prepare_record(rec: Dict[str, Any]
                   ) -> Tuple[bytes, List[Tuple[str, np.ndarray]], int]:
    """Split + size a record once: ``(meta_blob, tensors, nbytes)``.
    Callers that need the size before packing (slot-fit prechecks) hand
    the triple back to :func:`pack_record_into` so the split and the
    meta JSON dump are not paid twice on the hot path."""
    meta, tensors = _split(rec)
    blob = json.dumps(meta).encode("utf-8")
    return blob, tensors, _frame_sizes(blob, tensors)


def packed_nbytes(rec: Dict[str, Any]) -> int:
    """Exact wire size of ``pack_record(rec)`` (slot-fit precheck)."""
    return prepare_record(rec)[2]


def pack_record_into(rec: Dict[str, Any], buf, offset: int = 0,
                     codec: str = "binary",
                     prepared: Optional[Tuple] = None) -> int:
    """Serialize ``rec`` directly into a writable buffer (a shm slot, a
    bytearray) at ``offset``.  Returns bytes written.  Tensor bytes are
    memcpy'd exactly once — array memory → wire — with no base64 and no
    intermediate ``tobytes()`` allocation.  Pass a
    :func:`prepare_record` triple as ``prepared`` to reuse the
    split/size work already done for the slot-fit check."""
    t0 = time.perf_counter()
    blob, tensors, _ = prepared or prepare_record(rec)
    dst = np.frombuffer(buf, dtype=np.uint8)
    o = offset
    dst[o:o + _HDR.size] = np.frombuffer(
        _HDR.pack(MAGIC, len(blob)), np.uint8)
    o += _HDR.size
    dst[o:o + len(blob)] = np.frombuffer(blob, np.uint8)
    o += len(blob)
    dst[o:o + _NT.size] = np.frombuffer(_NT.pack(len(tensors)), np.uint8)
    o += _NT.size
    for name, a in tensors:
        a = np.ascontiguousarray(a)
        hdr = bytearray()
        nb = name.encode("utf-8")
        dt = wire_name(a.dtype).encode("ascii")
        hdr += _U16.pack(len(nb)) + nb
        hdr += _U16.pack(len(dt)) + dt
        hdr += bytes([a.ndim])
        for s in a.shape:
            hdr += _U64.pack(s)
        hdr += _U64.pack(a.nbytes)
        dst[o:o + len(hdr)] = np.frombuffer(bytes(hdr), np.uint8)
        o += len(hdr)
        o = offset + _align(o - offset)
        if a.nbytes:
            dst[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
        o += a.nbytes
    total = o - offset
    obs.count("serving_wire_bytes_total", total, codec=codec,
              flat=f"serving/wire_bytes_{codec}")
    obs.observe("serving_codec_seconds", time.perf_counter() - t0,
                codec=codec, op="encode")
    return total


def pack_record(rec: Dict[str, Any], codec: str = "binary") -> bytearray:
    """Serialize ``rec`` to a fresh buffer (File/network backends)."""
    prepared = prepare_record(rec)
    out = bytearray(prepared[2])
    pack_record_into(rec, out, 0, codec=codec, prepared=prepared)
    return out


def is_packed(buf) -> bool:
    mv = memoryview(buf)
    return len(mv) >= 4 and bytes(mv[:4]) == MAGIC


def unpack_record(buf, offset: int = 0, copy: bool = False,
                  codec: str = "binary") -> Dict[str, Any]:
    """Deserialize one packed record.  Tensor fields come back as
    ``np.frombuffer`` views into ``buf`` — zero-copy, read-only, and
    holding a reference to ``buf`` (so a shm slot stays leased exactly
    as long as any view of it is alive).  ``copy=True`` materializes
    writable copies instead (counted: ``serving/codec_tensor_copies``)."""
    t0 = time.perf_counter()
    mv = memoryview(buf).cast("B")
    magic, meta_len = _HDR.unpack_from(mv, offset)
    if magic != MAGIC:
        raise ValueError("not a packed record (bad magic)")
    o = offset + _HDR.size
    rec: Dict[str, Any] = json.loads(bytes(mv[o:o + meta_len]))
    o += meta_len
    (n_tensors,) = _NT.unpack_from(mv, o)
    o += _NT.size
    for _ in range(n_tensors):
        (nlen,) = _U16.unpack_from(mv, o)
        o += _U16.size
        name = bytes(mv[o:o + nlen]).decode("utf-8")
        o += nlen
        (dlen,) = _U16.unpack_from(mv, o)
        o += _U16.size
        dt = wire_dtype(bytes(mv[o:o + dlen]).decode("ascii"))
        o += dlen
        ndim = mv[o]
        o += 1
        shape = tuple(_U64.unpack_from(mv, o + 8 * i)[0]
                      for i in range(ndim))
        o += 8 * ndim
        (nbytes,) = _U64.unpack_from(mv, o)
        o += 8
        o = offset + _align(o - offset)
        count = nbytes // dt.itemsize if dt.itemsize else 0
        # frombuffer on `buf` itself (not the memoryview) so the view's
        # .base chain pins the original buffer object — the shm slot
        # lease rides that refcount
        a = np.frombuffer(buf, dtype=dt, count=count,
                          offset=o).reshape(shape)
        if copy:
            TIMERS.incr("serving/codec_tensor_copies")
            a = a.copy()
        else:
            a.setflags(write=False)
        rec[name] = a
        o += nbytes
    obs.observe("serving_codec_seconds", time.perf_counter() - t0,
                codec=codec, op="decode")
    return rec


# -- result direction -------------------------------------------------------

def pack_result(value: Any, codec: str = "binary") -> bytes:
    """Result value → wire bytes.  Dicts carrying ndarrays (the native
    ``{"tensor": row}`` envelope) take the binary frame; everything else
    (error payloads, top-N pairs, reference-wire lists) is plain JSON
    utf-8 — the magic prefix discriminates on the way back."""
    if isinstance(value, dict) and any(
            isinstance(v, np.ndarray) for v in value.values()):
        return bytes(pack_record(value, codec=codec))
    return json.dumps(value).encode("utf-8")


def unpack_result(buf, copy: bool = True, codec: str = "binary") -> Any:
    if is_packed(buf):
        return unpack_record(buf, copy=copy, codec=codec)
    return json.loads(bytes(memoryview(buf)))
