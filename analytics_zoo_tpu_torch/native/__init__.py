"""Native host-side primitives (C++ via ctypes): the JAX package's
``native``, with its own copy of ``zoo_native.cpp``.

The library is compiled with g++ on first use into a cache directory
(``ZOO_NATIVE_CACHE``, else one under the temporary directory) under a
name of its own (``zoo_native_torch_<digest>.so``), so this package and
the JAX one never load each other's build.  Every entry point has a
Python / numpy fallback, so importing this package never fails because a
compiler is missing; the fallbacks compute the same values.

Exports:
- ``crc32c(data) -> int``        (Castagnoli; slice-by-8 native)
- ``masked_crc32c(data) -> int`` (TFRecord / TensorBoard event framing)
- ``gather_rows(src, idx) -> np.ndarray``  (parallel batch assembly)
- ``available() -> bool``
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

logger = logging.getLogger("analytics_zoo_tpu_torch.native")

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "zoo_native.cpp")
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _cache_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    cache = os.environ.get("ZOO_NATIVE_CACHE") or os.path.join(
        tempfile.gettempdir(), f"zoo_native_torch_{os.getuid()}")
    os.makedirs(cache, exist_ok=True)
    return os.path.join(cache, f"zoo_native_torch_{digest}.so")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        so = _cache_path()
        if not os.path.exists(so):
            tmp = so + f".build{os.getpid()}"
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-pthread", "-std=c++17",
                 _SRC, "-o", tmp],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        lib.zoo_crc32c.restype = ctypes.c_uint32
        lib.zoo_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.zoo_gather_rows.restype = None
        lib.zoo_gather_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32]
        _LIB = lib
        logger.debug("zoo_native loaded from %s", so)
    except Exception as e:          # no compiler, a read-only cache, ...
        logger.info("zoo_native unavailable (%s); using python fallbacks",
                    e)
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------
# crc32c
# ---------------------------------------------------------------------------

def _py_crc32c(data: bytes) -> int:
    from analytics_zoo_tpu_torch.core.summary import crc32c as py

    return py(data)


def crc32c(data: bytes) -> int:
    lib = _load()
    if lib is None:
        return _py_crc32c(data)
    return int(lib.zoo_crc32c(data, len(data)))


def masked_crc32c(data: bytes) -> int:
    """TFRecord / TensorBoard-event masked checksum."""
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# gather_rows
# ---------------------------------------------------------------------------

# output bytes per gather thread when the caller names no thread count:
# below it, starting a thread costs more than the copy it takes over
GATHER_BYTES_PER_THREAD = 4 << 20


def gather_rows(src: np.ndarray, idx: np.ndarray,
                n_threads: int = 0) -> np.ndarray:
    """``src[idx]`` for row-major arrays; a parallel native memcpy when
    the library is available, numpy fancy indexing otherwise.
    ``n_threads`` 0 takes one thread per ``GATHER_BYTES_PER_THREAD`` of
    output, at most 8."""
    src = np.ascontiguousarray(src)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    lib = _load()
    if lib is None or src.ndim == 0:
        return src[idx]
    # numpy semantics: negatives wrap, out-of-range raises — the memcpy
    # must never read outside the buffer
    n = src.shape[0]
    if idx.size:
        lo, hi = int(idx.min()), int(idx.max())
        if lo < 0:              # wrapped ids stay below n
            idx = np.where(idx < 0, idx + n, idx)
            lo = int(idx.min())
        if lo < 0 or hi >= n:
            raise IndexError(
                f"index out of range for axis 0 with size {n}")
    row_bytes = int(src.dtype.itemsize * np.prod(src.shape[1:], dtype=int))
    out = np.empty((len(idx),) + src.shape[1:], src.dtype)
    if n_threads <= 0:
        n_threads = max(1, min(8, os.cpu_count() or 1,
                               out.nbytes // GATHER_BYTES_PER_THREAD))
    lib.zoo_gather_rows(
        src.ctypes.data_as(ctypes.c_void_p),
        idx.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p),
        len(idx), row_bytes, n_threads)
    return out
