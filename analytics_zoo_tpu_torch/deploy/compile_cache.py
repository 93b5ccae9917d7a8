"""Persistent program-signature cache: what a serving process captures.

The JAX package's ``deploy/compile_cache.py`` persists serialized XLA
executables, one per (model, bucket shape, dtype, device) program
signature, so a restarted server loads every program in ``warm()``
instead of compiling it live.  The port's program is a CUDA graph of the
bucket's forward (``deploy/inference.py``, ``core/graphs.py``), and a CUDA
graph cannot be serialized: it holds device addresses of one process.  So
an entry's payload is the program *signature* — input shapes and dtypes,
device, fused top-N, weight dtype — and ``warm()`` captures every cached
signature before the first request, which is what keeps a restarted
server's ``compile_count`` at 0.

Entry layout (one file per program, content-addressed), the JAX
package's::

    <digest>.xc := MAGIC("AZXC") | u32 header_len | header_json
                   | u32 crc32(payload) | u64 payload_len | payload

``digest = sha256(fingerprint, sig, devices)``: the devices (the card's
name and the visible device count) join the digest, so a cache filled
on one card type never warms another.  The torch and CUDA versions live
in the HEADER: a mismatch is *detected* at load (``version_skew``) and the
caller's recapture overwrites the same file in place.

A torn, truncated or unparseable entry is quarantined to
``<file>.corrupt`` and the caller captures afresh; writes are atomic (tmp
+ ``os.replace``).  Every outcome is counted in
``serving_compile_cache_events_total{event=hit|miss|corrupt|version_skew}``
with the owning model as a ``model`` label.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import struct
import tempfile
import threading
import time
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

__all__ = ["CompileCache", "CompileCacheCorrupt", "cache_env"]

logger = logging.getLogger("analytics_zoo_tpu_torch.deploy")

_MAGIC = b"AZXC"
_HDR = struct.Struct("<I")      # header_len
_PAY = struct.Struct("<IQ")     # crc32(payload), payload_len


class CompileCacheCorrupt(Exception):
    """A cache entry failed structural validation (magic/CRC/length)."""


def cache_env() -> Dict[str, str]:
    """The toolchain a program signature was captured under: ``torch``
    and ``cuda`` versions gate reuse (``version_skew``); ``devices`` (the
    card's name x the visible device count, ``cpu`` without a card) joins
    the digest."""
    if torch.cuda.is_available():
        devices = (f"{torch.cuda.get_device_name(0)}"
                   f"x{torch.cuda.device_count()}")
    else:
        devices = "cpu"
    return {"torch": torch.__version__,
            "cuda": str(torch.version.cuda),
            "devices": devices}


class CompileCache:
    """Content-addressed on-disk store of program signatures.

    One instance may be shared by every model of a worker; the in-memory
    ledger (``_index``) and event counts are guarded by ``_lock``."""

    SUFFIX = ".xc"

    def __init__(self, root: str, max_entries: int = 512):
        self.root = str(root)
        self.max_entries = max(1, int(max_entries))
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()
        # digest -> header of entries this process has seen intact
        self._index: Dict[str, Dict[str, Any]] = {}
        self._events: Dict[str, int] = {}

    # -- keying ------------------------------------------------------------

    @staticmethod
    def digest(fingerprint: str, sig: Dict[str, Any]) -> str:
        """Content address for one program: model fingerprint + program
        signature + devices (not the versions: see the module
        docstring)."""
        blob = json.dumps({"fp": fingerprint, "sig": sig,
                           "devices": cache_env()["devices"]},
                          sort_keys=True)
        return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:40]

    def path_for(self, fingerprint: str, sig: Dict[str, Any]) -> str:
        return os.path.join(self.root,
                            self.digest(fingerprint, sig) + self.SUFFIX)

    def _key(self, path: str) -> str:
        return os.path.basename(path)[:-len(self.SUFFIX)]

    # -- events ------------------------------------------------------------

    def _event(self, event: str, model: str) -> None:
        from analytics_zoo_tpu_torch.observe import metrics as obs

        with self._lock:
            self._events[event] = self._events.get(event, 0) + 1
        obs.count("serving_compile_cache_events_total", event=event,
                  model=model, flat=f"serving/compile_cache_{event}")

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            events = dict(self._events)
            indexed = len(self._index)
        return {"root": self.root, "events": events, "indexed": indexed,
                "entries": len(self._entry_files())}

    # -- store -------------------------------------------------------------

    def store(self, fingerprint: str, sig: Dict[str, Any],
              model: str = "default") -> str:
        """Persist one program signature; atomic overwrite in place (a
        version-skewed entry at the same digest is replaced).  Returns the
        entry path."""
        payload = json.dumps(sig, sort_keys=True).encode("utf-8")
        header = dict(fingerprint=fingerprint, sig=sig, model=model,
                      created=time.time(), **cache_env())
        hdr = json.dumps(header, sort_keys=True).encode("utf-8")
        crc = zlib.crc32(payload) & 0xFFFFFFFF
        path = self.path_for(fingerprint, sig)
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(_MAGIC)
                f.write(_HDR.pack(len(hdr)))
                f.write(hdr)
                f.write(_PAY.pack(crc, len(payload)))
                f.write(payload)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        with self._lock:
            self._index[self._key(path)] = header
        self.gc()
        return path

    # -- load --------------------------------------------------------------

    def _read_entry(self, path: str) -> Tuple[Dict[str, Any], bytes]:
        """Parse + CRC-check one entry; raises CompileCacheCorrupt on any
        structural damage (torn write, truncation, bit rot)."""
        with open(path, "rb") as f:
            data = f.read()
        if len(data) < len(_MAGIC) + _HDR.size or \
                data[:len(_MAGIC)] != _MAGIC:
            raise CompileCacheCorrupt(f"{path}: bad magic")
        off = len(_MAGIC)
        (hlen,) = _HDR.unpack_from(data, off)
        off += _HDR.size
        if off + hlen + _PAY.size > len(data):
            raise CompileCacheCorrupt(f"{path}: truncated header")
        try:
            header = json.loads(data[off:off + hlen].decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise CompileCacheCorrupt(f"{path}: unparseable header: {e}")
        off += hlen
        crc, plen = _PAY.unpack_from(data, off)
        off += _PAY.size
        payload = data[off:off + plen]
        if len(payload) != plen:
            raise CompileCacheCorrupt(
                f"{path}: truncated payload ({len(payload)}/{plen} bytes)")
        if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            raise CompileCacheCorrupt(f"{path}: payload CRC mismatch")
        return header, payload

    def _quarantine(self, path: str, model: str, why: str) -> None:
        self._event("corrupt", model)
        logger.warning("compile cache: quarantining %s (%s)", path, why)
        try:
            os.replace(path, path + ".corrupt")
        except OSError:
            pass
        with self._lock:
            self._index.pop(self._key(path), None)

    @staticmethod
    def _version_ok(header: Dict[str, Any]) -> bool:
        env = cache_env()
        return (header.get("torch") == env["torch"]
                and header.get("cuda") == env["cuda"])

    @staticmethod
    def _program(header: Dict[str, Any], payload: bytes) -> Dict[str, Any]:
        """The payload's signature; it must be the header's."""
        try:
            sig = json.loads(payload.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise CompileCacheCorrupt(f"unparseable payload: {e}")
        if sig != header.get("sig"):
            raise CompileCacheCorrupt("payload and header signatures differ")
        return sig

    def _entry(self, path: str, model: str, fingerprint: Optional[str]):
        """The signature of the intact, version-compatible entry at
        ``path`` (of ``fingerprint``, when given), or None; counts what
        it found, except another fingerprint's entry."""
        try:
            header, payload = self._read_entry(path)
            if fingerprint is not None and \
                    header.get("fingerprint") != fingerprint:
                return None
            sig = self._program(header, payload)
        except CompileCacheCorrupt as e:
            self._quarantine(path, model, str(e))
            return None
        if not self._version_ok(header):
            self._event("version_skew", model)
            logger.warning(
                "compile cache: %s captured under torch %s / CUDA %s; "
                "current is %s / %s — recapturing and overwriting", path,
                header.get("torch"), header.get("cuda"),
                cache_env()["torch"], cache_env()["cuda"])
            return None
        with self._lock:
            self._index[self._key(path)] = header
        self._event("hit", model)
        return sig

    def load(self, fingerprint: str, sig: Dict[str, Any],
             model: str = "default") -> Optional[Dict[str, Any]]:
        """The cached signature, or None (the caller captures and
        ``store``\\ s).  Counts exactly one of ``hit`` / ``miss`` /
        ``corrupt`` / ``version_skew``; a skewed entry stays on disk for
        the recapture to overwrite."""
        path = self.path_for(fingerprint, sig)
        if not os.path.exists(path):
            self._event("miss", model)
            return None
        return self._entry(path, model, None)

    def load_all(self, fingerprint: str, model: str = "default"
                 ) -> Iterator[Tuple[Dict[str, Any], Dict[str, Any]]]:
        """Every intact, version-compatible entry of one model
        fingerprint — the warm() path: a restarted worker captures full
        bucket coverage before its first request.  Yields ``(sig,
        program)``, the header's signature and the payload's (the same);
        each counts ``hit``."""
        for path in self._entry_files():
            sig = self._entry(path, model, fingerprint)
            if sig is not None:
                yield sig, sig

    # -- housekeeping ------------------------------------------------------

    def _entry_files(self) -> List[str]:
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        return sorted(os.path.join(self.root, fn) for fn in names
                      if fn.endswith(self.SUFFIX))

    def entries(self) -> List[Dict[str, Any]]:
        """Headers of every intact entry (corrupt ones skipped, not
        quarantined — this is a read-only listing)."""
        out = []
        for path in self._entry_files():
            try:
                header, _ = self._read_entry(path)
            except CompileCacheCorrupt:
                continue
            out.append(header)
        return out

    def gc(self, max_entries: Optional[int] = None) -> int:
        """Evict the oldest-mtime entries beyond the cap (a recapture
        rewrites its entry and so renews it).  Returns the number
        evicted."""
        cap = max_entries if max_entries is not None else self.max_entries
        files = self._entry_files()
        if len(files) <= cap:
            return 0

        def _mtime(p):
            try:
                return os.path.getmtime(p)
            except OSError:
                return 0.0

        files.sort(key=_mtime)
        evicted = 0
        for path in files[:len(files) - cap]:
            try:
                os.unlink(path)
                evicted += 1
            except OSError:
                continue
            with self._lock:
                self._index.pop(self._key(path), None)
        return evicted
