"""TensorBoard event-file writer and scalar reader, with no TensorFlow.

The JAX package's ``core/summary.py``, copied (it never touches JAX):
the two small protobuf messages involved (Event{wall_time, step,
summary{value{tag, simple_value}}}) are encoded by hand, framed as
TFRecords with a masked CRC-32C, so TensorBoard reads the files
directly, and files written by either package read in either.
"""

from __future__ import annotations

import glob
import os
import socket
import struct
import time
from typing import List, Tuple

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven — required by the TFRecord framing.
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _build_table() -> None:
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_build_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# native.masked_crc32c takes the C++ library when it builds and this
# table otherwise (the table stays its fallback and golden reference)
from analytics_zoo_tpu_torch.native import masked_crc32c as _masked_crc  # noqa: E402


# ---------------------------------------------------------------------------
# Minimal protobuf wire-format encoding (just what Event/Summary need).
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            out += bytes([b])
            return out


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _pb_double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _pb_int64(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _pb_bytes(field: int, v: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(v)) + v


def encode_scalar_event(tag: str, value: float, step: int,
                        wall_time: float) -> bytes:
    # Summary.Value{ tag=1: string, simple_value=2: float }
    val = _pb_bytes(1, tag.encode()) + _pb_float(2, float(value))
    # Summary{ value=1: repeated Value }
    summary = _pb_bytes(1, val)
    # Event{ wall_time=1: double, step=2: int64, summary=5: Summary }
    return (_pb_double(1, wall_time) + _pb_int64(2, step)
            + _pb_bytes(5, summary))


def encode_file_version_event(wall_time: float) -> bytes:
    # Event{ wall_time=1, file_version=3: string }
    return _pb_double(1, wall_time) + _pb_bytes(3, b"brain.Event:2")


def write_record(f, data: bytes) -> None:
    """TFRecord framing: len(8) + masked_crc(len)(4) + data + masked_crc(data)."""
    header = struct.pack("<Q", len(data))
    f.write(header)
    f.write(struct.pack("<I", _masked_crc(header)))
    f.write(data)
    f.write(struct.pack("<I", _masked_crc(data)))


class SummaryWriter:
    """Append-only scalar summary writer (reference FileWriter.scala:32)."""

    def __init__(self, log_dir: str, flush_secs: float = 10.0):
        os.makedirs(log_dir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}")
        self.path = os.path.join(log_dir, fname)
        self._f = open(self.path, "ab")
        self._last_flush = time.time()
        self.flush_secs = flush_secs
        write_record(self._f, encode_file_version_event(time.time()))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        write_record(self._f,
                     encode_scalar_event(tag, value, step, time.time()))
        if time.time() - self._last_flush > self.flush_secs:
            self.flush()

    def flush(self) -> None:
        self._f.flush()
        self._last_flush = time.time()

    def close(self) -> None:
        self.flush()
        self._f.close()


# ---------------------------------------------------------------------------
# Reader (reference FileReader.scala:80 readScalar)
# ---------------------------------------------------------------------------

def _decode_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = 0
    out = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _iter_fields(buf: bytes):
    i = 0
    while i < len(buf):
        key, i = _decode_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _decode_varint(buf, i)
        elif wire == 1:
            val = buf[i:i + 8]
            i += 8
        elif wire == 2:
            ln, i = _decode_varint(buf, i)
            val = buf[i:i + ln]
            i += ln
        elif wire == 5:
            val = buf[i:i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def read_scalars(log_dir: str, tag: str) -> List[Tuple[int, float]]:
    """Read (step, value) pairs for ``tag`` from all event files in a dir."""
    out: List[Tuple[int, float]] = []
    for path in sorted(glob.glob(os.path.join(log_dir, "events.out.tfevents.*"))):
        with open(path, "rb") as f:
            data = f.read()
        i = 0
        while i + 12 <= len(data):
            (length,) = struct.unpack("<Q", data[i:i + 8])
            if i + 12 + length + 4 > len(data):
                break  # truncated tail record (torn write); keep the rest
            i += 12  # len + len_crc
            rec = data[i:i + length]
            i += length + 4  # data + data_crc
            step = 0
            summary = None
            for field, wire, val in _iter_fields(rec):
                if field == 2 and wire == 0:
                    step = val
                elif field == 5 and wire == 2:
                    summary = val
            if summary is None:
                continue
            for field, wire, val in _iter_fields(summary):
                if field == 1 and wire == 2:  # Summary.Value
                    vtag, simple = None, None
                    for f2, w2, v2 in _iter_fields(val):
                        if f2 == 1 and w2 == 2:
                            vtag = v2.decode()
                        elif f2 == 2 and w2 == 5:
                            (simple,) = struct.unpack("<f", v2)
                    if vtag == tag and simple is not None:
                        out.append((step, simple))
    return out
