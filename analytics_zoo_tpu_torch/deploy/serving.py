"""Cluster Serving: the streaming inference worker and its client queues.

The JAX package's ``deploy/serving.py`` (reference
serving/ClusterServing.scala:46 and the Python client
pyzoo/zoo/serving/client.py:58-150), ported to the card: the worker is a
multi-stage pipeline around the models' bucket programs (CUDA graphs,
``deploy/inference.py``)::

    poller → decode pool → DynamicBatcher → DeviceExecutor → respond pool

Decode runs beside the device's work, the batcher groups requests by
shape and flushes on batch-full or a deadline, and the executor keeps
``max_inflight`` asynchronous dispatches in flight over per-device
model replicas: a dispatch enqueues the copy-in, the replay and the
copy-out on the device's serving stream and returns; the harvest
thread waits on the flight's event.  Every stage reports into
``core.profiling.TIMERS`` (``serving/queue_wait`` / ``decode`` /
``batch_wait`` / ``device`` / ``respond`` / ``e2e``) with p50/p99 rollups
surfaced by :meth:`ClusterServing.health`.  The transport is pluggable:

- ``MemoryQueue`` — in-process (tests, single-process apps);
- ``FileQueue``   — spool directory with atomic renames (cross-process
                    on one host or a shared file system);
- ``ShmQueue``    — shared-memory ring buffer + binary tensor codec, the
                    zero-copy single-host path (``deploy/shmqueue.py``),
                    which clients in other processes attach to by name;
- ``RedisQueue``  — Redis streams with a consumer group, wire-shaped like
                    the reference client (needs the ``redis`` package and
                    a server; the import is gated, and nothing stands in
                    when it fails).

``tensorboard_dir`` writes the JAX package's serving scalars (records/s,
total records, each stage's p99, healthy replicas) as TensorBoard events
(``core/summary.py``).  The JAX package's pod-scale mesh replicas and
``PodCoordinator`` are not ported yet (ROADMAP A9).

Image records (``InputQueue.enqueue_image``) carry raw pixels (``codec``
"raw": an ndarray on binary backends, a base64 tensor on JSON ones) or
a compressed file's bytes (``codec`` "file": jpg/png, as the reference
client sends them).  Decoding the latter needs ``cv2``, as in the JAX
package; where it is missing the record is answered with the code the
JAX worker gives when its ``import cv2`` fails, ``decode_error``, its
message naming ``cv2`` (``data.image.Cv2Unavailable``).

Wire format is a per-backend property (``queue.wire``): ``"binary"``
backends move framed raw tensor bytes (:mod:`deploy.codec`, the JAX
package's format byte for byte), ``"json"`` backends keep the legacy
base64-in-JSON codec.  The worker decodes both on every backend, so a
record pushed by either package's ``InputQueue`` is served by either
package's worker.

Robustness contract shared by the backends: ``get_result`` raises
:class:`TimeoutError` with a uniform message once the deadline passes,
``health()`` returns a ``{"ok": bool, ...}`` probe, and FileQueue I/O
runs under a :class:`~analytics_zoo_tpu_torch.robust.RetryPolicy`.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import queue as pyqueue
import tempfile
import threading
import time
import uuid
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from analytics_zoo_tpu_torch.core.profiling import TIMERS
from analytics_zoo_tpu_torch.deploy import codec as wire_codec
from analytics_zoo_tpu_torch.deploy.inference import (
    DEFAULT_MODEL, DynamicBatcher, plan_buckets, scatter_batch_results)
from analytics_zoo_tpu_torch.observe import metrics as obs
from analytics_zoo_tpu_torch.observe.export import JsonlEventLog, to_prometheus
from analytics_zoo_tpu_torch.observe.recorder import SLO, FlightRecorder
from analytics_zoo_tpu_torch.observe.trace import TRACER
from analytics_zoo_tpu_torch.robust import (CircuitBreaker, Heartbeat,
                                            RetryPolicy, Supervisor, faults)
from analytics_zoo_tpu_torch.robust.errors import (DeadlineExpired,
                                                   MalformedRecordError,
                                                   ServingError)

__all__ = ["MemoryQueue", "FileQueue", "RedisQueue", "make_queue",
           "make_queue_from_zoo", "InputQueue", "OutputQueue",
           "ServingConfig", "ClusterServing", "DeviceExecutor", "encode_tensor", "decode_tensor",
           "encode_image", "decode_image", "error_payload",
           "MalformedRecordError"]


def error_payload(code: str, message: Any, uri: Optional[str] = None
                  ) -> Dict[str, Any]:
    """The structured error result (docs/SERVING.md "Failure semantics").

    Every record the pipeline cannot serve terminates with one of these
    on the OutputQueue — never a silent drop: ``error`` is the human
    message, ``code`` the stable machine class (``expired`` /
    ``overloaded`` / ``malformed`` / ``decode_error`` / ``model_error``
    / ``internal``), ``uri`` echoes the record id, ``ts`` stamps when
    the error was written."""
    return {"error": str(message), "code": str(code), "uri": uri,
            "ts": time.time()}


# ---------------------------------------------------------------------------
# the legacy tensor payload codec
# ---------------------------------------------------------------------------

def encode_tensor(a) -> Dict[str, Any]:
    """ndarray → JSON-safe payload (the LEGACY base64 wire codec).

    Binary-wire backends (``queue.wire == "binary"``) skip this entirely
    and ship raw ndarrays through :mod:`deploy.codec`; this stays the
    reference-compatible fallback for Memory/Redis and old producers.
    Instrumented so the bench can attribute the base64 tax:
    ``serving/codec_b64_encode`` counts calls,
    ``serving_wire_bytes_total{codec="json_b64"}`` the on-wire bytes."""
    t0 = time.perf_counter()
    a = np.asarray(a)
    payload = {"b64": base64.b64encode(a.tobytes()).decode("ascii"),
               "shape": list(a.shape), "dtype": str(a.dtype)}
    TIMERS.incr("serving/codec_b64_encode")
    obs.count("serving_wire_bytes_total", len(payload["b64"]),
              codec="json_b64", flat="serving/wire_bytes_json_b64")
    obs.observe("serving_codec_seconds", time.perf_counter() - t0,
                codec="json_b64", op="encode")
    return payload


def decode_tensor(payload, writable: bool = False) -> np.ndarray:
    """Wire payload → ndarray.

    Accepts the legacy ``{"b64", "shape", "dtype"}`` dict AND a raw
    ndarray (the binary wire hands tensors through already decoded —
    possibly as a read-only view into a shared-memory slot).

    Writability is explicit: the default is a zero-copy READ-ONLY array
    (``np.frombuffer`` views are non-writable by nature; hiding that
    behind an implicit copy is exactly the hot-path tax this module
    removes).  Pass ``writable=True`` to get a private mutable copy —
    counted in ``serving/codec_tensor_copies`` so the zero-copy claim
    stays test-verifiable."""
    if isinstance(payload, np.ndarray):
        if writable and not payload.flags.writeable:
            TIMERS.incr("serving/codec_tensor_copies")
            return payload.copy()
        return payload
    t0 = time.perf_counter()
    TIMERS.incr("serving/codec_b64_decode")
    a = np.frombuffer(
        base64.b64decode(payload["b64"]),
        dtype=wire_codec.wire_dtype(payload["dtype"])
    ).reshape(payload["shape"])
    if writable:
        TIMERS.incr("serving/codec_tensor_copies")
        a = a.copy()
    obs.observe("serving_codec_seconds", time.perf_counter() - t0,
                codec="json_b64", op="decode")
    return a


def encode_image(image, wire: str = "json") -> Dict[str, Any]:
    """ndarray (H, W, C) float/uint8, or a file's path -> wire payload:
    raw pixels (``codec`` "raw"), or the file's bytes in base64
    (``codec`` "file")."""
    if isinstance(image, str):
        with open(image, "rb") as f:
            return {"image": base64.b64encode(f.read()).decode("ascii"),
                    "codec": "file"}
    if wire == "binary":
        return {"codec": "raw", "image": np.asarray(image)}
    return {"codec": "raw", "image": encode_tensor(image)}


def decode_image(payload: Dict[str, Any]) -> np.ndarray:
    """An image record's pixels: raw pixels as they rode, compressed
    file bytes (jpg/png) decoded by ``cv2`` into BGR (raising
    ``Cv2Unavailable`` where it is not installed)."""
    img = payload.get("image")
    if isinstance(img, np.ndarray):  # binary wire: already decoded
        return img
    if payload.get("codec") == "raw":
        return decode_tensor(payload["image"])
    raw = base64.b64decode(img)
    from analytics_zoo_tpu_torch.data.image import require_cv2

    cv2 = require_cv2("decoding a compressed (jpg/png) image record")
    img = cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError("undecodable image payload")
    return img


# ---------------------------------------------------------------------------
# queue backends
# ---------------------------------------------------------------------------

def _timeout_msg(q, rid: str, timeout: float) -> str:
    """One TimeoutError message shape across every backend, so callers
    (and tests) never have to care which transport is underneath."""
    return (f"{type(q).__name__}[{q.name}]: no result for {rid!r} "
            f"within {timeout:.1f}s")


def _io_retry(name: str, retry_on) -> RetryPolicy:
    """Default retry for persistent-backend I/O: 3 quick attempts —
    enough to absorb a transient fs/connection blip without turning a
    dead backend into a multi-second client hang."""
    return RetryPolicy(max_attempts=3, base_delay_s=0.02, max_delay_s=0.5,
                       retry_on=retry_on, name=name)


class MemoryQueue:
    """In-process stream + result store (single-process serving/tests)."""

    def __init__(self, name: str = "serving_stream"):
        self.name = name
        self._items: List[Tuple[str, Dict]] = []
        self._results: Dict[str, Any] = {}
        self._cv = threading.Condition()

    def push(self, record: Dict) -> str:
        rid = record.get("uri") or uuid.uuid4().hex
        with self._cv:
            self._items.append((rid, record))
            self._cv.notify_all()
        return rid

    def pop_batch(self, n: int, timeout: float = 0.1
                  ) -> List[Tuple[str, Dict]]:
        deadline = time.monotonic() + timeout
        with self._cv:
            while not self._items and time.monotonic() < deadline:
                self._cv.wait(timeout=deadline - time.monotonic())
            out, self._items = self._items[:n], self._items[n:]
            return out

    def __len__(self) -> int:
        with self._cv:
            return len(self._items)

    def trim(self, maxlen: int) -> int:
        """Drop oldest items beyond maxlen (reference XTRIM backpressure,
        ClusterServing.scala:132-138).  Returns number dropped."""
        with self._cv:
            drop = max(0, len(self._items) - maxlen)
            if drop:
                self._items = self._items[drop:]
            return drop

    def set_result(self, rid: str, value: Any) -> None:
        with self._cv:
            self._results[rid] = value
            self._cv.notify_all()

    def get_result(self, rid: str, timeout: float = 10.0) -> Any:
        deadline = time.monotonic() + timeout
        with self._cv:
            while rid not in self._results:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(_timeout_msg(self, rid, timeout))
                self._cv.wait(timeout=left)
            return self._results.pop(rid)

    def pending_results(self) -> List[str]:
        with self._cv:
            return list(self._results)

    def health(self) -> Dict[str, Any]:
        with self._cv:
            return {"ok": True, "backend": "memory",
                    "depth": len(self._items),
                    "pending_results": len(self._results)}


class FileQueue:
    """Spool-directory stream: cross-process on one host or a shared FS.

    Records are one file each; atomic rename makes push/claim race-free
    without locks (rename(2) is atomic on POSIX).  Plays the role the
    Redis server plays for the reference when no Redis is available.

    ``codec="binary"`` (the default) spools records as ``.bin`` framed
    tensor files (:mod:`deploy.codec` — raw bytes, no base64);
    ``codec="json"`` keeps the legacy one-JSON-per-record format.
    ``pop_batch`` reads BOTH extensions, so mixed producers coexist.

    Depth bookkeeping is cached: ``__len__``/``trim`` answer from a
    counter maintained under ``_lock`` (push +1, pop refreshes it from
    the directory scan it does anyway) and only fall back to a full
    ``os.listdir`` on a cache miss — the poller calls ``trim`` every
    loop, so an O(queue) scan per loop was a measurable tax.
    """

    def __init__(self, root: str, name: str = "serving_stream",
                 retry: Optional[RetryPolicy] = None,
                 codec: str = "binary"):
        self.name = name
        self.codec = codec
        self.wire = "binary" if codec == "binary" else "json"
        self.root = os.path.join(root, name)
        self.in_dir = os.path.join(self.root, "in")
        self.out_dir = os.path.join(self.root, "out")
        for d in (self.in_dir, self.out_dir):
            os.makedirs(d, exist_ok=True)
        self._seq = 0
        self._retry = retry or _io_retry("filequeue_io", (OSError,))
        self._lock = threading.Lock()
        self._n: Optional[int] = None  # None = miss → rescan

    _EXTS = (".json", ".bin")

    def push(self, record: Dict) -> str:
        rid = record.get("uri") or uuid.uuid4().hex
        self._seq += 1
        ext = ".bin" if self.codec == "binary" else ".json"
        fn = f"{time.time_ns():020d}_{self._seq:06d}_{rid}{ext}"

        def _write():
            faults.inject("queue.io")
            fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
            if ext == ".bin":
                with os.fdopen(fd, "wb") as f:
                    f.write(wire_codec.pack_record(record, codec="file"))
            else:
                with os.fdopen(fd, "w") as f:
                    json.dump({"rid": rid, "record": record}, f)
            os.replace(tmp, os.path.join(self.in_dir, fn))

        self._retry.call(_write)
        with self._lock:
            if self._n is not None:
                self._n += 1
        return rid

    # claims older than this are from a crashed worker and get requeued
    STALE_CLAIM_S = 60.0

    @classmethod
    def _is_record(cls, fn: str) -> bool:
        return fn.endswith(cls._EXTS)

    @staticmethod
    def _rid_of(fn: str) -> str:
        # {time_ns}_{seq}_{rid}.{ext}: rid may itself contain "_"
        return fn.rsplit(".", 1)[0].split("_", 2)[2]

    def _read_record(self, path: str) -> Tuple[str, Dict]:
        if path.endswith(".bin.claimed") or path.endswith(".bin"):
            with open(path, "rb") as f:
                data = f.read()
            fn = os.path.basename(path)
            if fn.endswith(".claimed"):
                fn = fn[: -len(".claimed")]
            # copy=True: the backing file is deleted after the claim, so
            # views must not outlive this function
            return (self._rid_of(fn),
                    wire_codec.unpack_record(data, copy=True,
                                             codec="file"))
        with open(path) as f:
            blob = json.load(f)
        return blob["rid"], blob["record"]

    def pop_batch(self, n: int, timeout: float = 0.1
                  ) -> List[Tuple[str, Dict]]:
        deadline = time.monotonic() + timeout
        while True:
            out = []
            seen = 0
            for fn in sorted(os.listdir(self.in_dir)):
                path = os.path.join(self.in_dir, fn)
                if fn.endswith(".claimed"):
                    # recover claims orphaned by a crashed worker
                    try:
                        if (time.time() - os.path.getmtime(path)
                                > self.STALE_CLAIM_S):
                            os.rename(path, path[: -len(".claimed")])
                            seen += 1
                    except OSError:
                        pass
                    continue
                if not self._is_record(fn):
                    continue
                if len(out) >= n:
                    seen += 1  # stays queued; count for the cache
                    continue
                claimed = path + ".claimed"
                try:
                    os.rename(path, claimed)  # atomic claim
                except OSError:
                    continue  # another worker won
                blob = self._read_record(claimed)
                os.unlink(claimed)
                out.append(blob)
            with self._lock:
                # the scan just walked the whole directory — refresh the
                # cached depth for free (also heals cross-process drift)
                self._n = seen
            if out or time.monotonic() >= deadline:
                return out
            time.sleep(0.005)

    def __len__(self) -> int:
        with self._lock:
            if self._n is None:  # cache miss: rescan once
                self._n = sum(1 for fn in os.listdir(self.in_dir)
                              if self._is_record(fn))
            return self._n

    def trim(self, maxlen: int) -> int:
        with self._lock:
            if self._n is not None and self._n <= maxlen:
                return 0  # fast path: no listdir under the limit
        files = sorted(fn for fn in os.listdir(self.in_dir)
                       if self._is_record(fn))
        drop = max(0, len(files) - maxlen)
        for fn in files[:drop]:
            try:
                os.unlink(os.path.join(self.in_dir, fn))
            except OSError:
                pass
        with self._lock:
            self._n = len(files) - drop
        return drop

    def set_result(self, rid: str, value: Any) -> None:
        binary = self.codec == "binary"

        def _write():
            faults.inject("queue.io")
            fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
            if binary:
                with os.fdopen(fd, "wb") as f:
                    f.write(wire_codec.pack_result(value, codec="file"))
                os.replace(tmp, os.path.join(self.out_dir, rid + ".bin"))
            else:
                with os.fdopen(fd, "w") as f:
                    json.dump(value, f)
                os.replace(tmp, os.path.join(self.out_dir, rid + ".json"))

        self._retry.call(_write)

    def get_result(self, rid: str, timeout: float = 10.0) -> Any:
        paths = [os.path.join(self.out_dir, rid + ext)
                 for ext in (".bin", ".json")]
        deadline = time.monotonic() + timeout

        def _read(path):
            faults.inject("queue.io")
            if path.endswith(".bin"):
                with open(path, "rb") as f:
                    val = wire_codec.unpack_result(f.read(), copy=True,
                                                   codec="file")
            else:
                with open(path) as f:
                    val = json.load(f)
            os.unlink(path)
            return val

        while True:
            for path in paths:
                if os.path.exists(path):
                    return self._retry.call(lambda p=path: _read(p))
            if time.monotonic() >= deadline:
                raise TimeoutError(_timeout_msg(self, rid, timeout))
            time.sleep(0.005)

    def pending_results(self) -> List[str]:
        return [fn.rsplit(".", 1)[0] for fn in os.listdir(self.out_dir)
                if fn.endswith(self._EXTS)]

    def health(self) -> Dict[str, Any]:
        """Probe: the spool directories must exist and be writable."""
        try:
            fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".probe")
            os.close(fd)
            os.unlink(tmp)
            return {"ok": True, "backend": "file", "root": self.root,
                    "depth": len(self)}
        except OSError as e:
            return {"ok": False, "backend": "file", "root": self.root,
                    "error": str(e)}


class RedisQueue:
    """Redis-stream backend, wire-shaped like the reference
    (xadd to the stream, results to hashes ``result:{uri}``) —
    client.py:83-150 / ClusterServing.scala:107-138.  Requires the
    ``redis`` package and a live server; without the package the
    constructor raises ``ImportError``.

    Reads go through a consumer group (XREADGROUP + XACK), so N workers
    on one queue each claim disjoint records — the same exactly-one-
    claimer contract as FileQueue.  The JAX package's class, with its
    wire: a record either package's ``InputQueue`` pushes is served by
    either package's worker."""

    GROUP = "serving_workers"

    def __init__(self, host: str = "localhost", port: int = 6379,
                 name: str = "serving_stream",
                 retry: Optional[RetryPolicy] = None):
        import redis  # gated import

        self.name = name
        self._r = redis.Redis(host=host, port=port, decode_responses=True)
        self._consumer = uuid.uuid4().hex
        self._retry = retry or _io_retry(
            "redisqueue_io",
            (getattr(redis, "ConnectionError", OSError),
             getattr(redis, "TimeoutError", OSError), OSError))
        try:
            self._r.xgroup_create(self.name, self.GROUP, id="0",
                                  mkstream=True)
        except redis.ResponseError as e:  # BUSYGROUP = already exists
            if "BUSYGROUP" not in str(e):
                raise

    def push(self, record: Dict) -> str:
        rid = record.get("uri") or uuid.uuid4().hex

        def _write():
            faults.inject("queue.io")
            self._r.xadd(self.name, {"blob": json.dumps(
                {"rid": rid, "record": record})})

        self._retry.call(_write)
        return rid

    def pop_batch(self, n: int, timeout: float = 0.1
                  ) -> List[Tuple[str, Dict]]:
        resp = self._r.xreadgroup(self.GROUP, self._consumer,
                                  {self.name: ">"}, count=n,
                                  block=int(timeout * 1000))
        out = []
        for _, entries in resp or []:
            for eid, fields in entries:
                if "blob" in fields:
                    # native client envelope (json)
                    blob = json.loads(fields["blob"])
                    out.append((blob["rid"], blob["record"]))
                else:
                    # reference-client wire shape: flat fields
                    # {uri, image: b64(jpg bytes)} (client.py:102-110),
                    # lifted into the worker's record schema (the b64
                    # file codec is decode_image's "file" path)
                    rec = dict(fields)
                    rid = rec.get("uri") or eid
                    if "image" in rec and not isinstance(rec["image"],
                                                         dict):
                        rec = {"uri": rid, "codec": "file",
                               "image": rec["image"]}
                    out.append((rid, rec))
                self._r.xack(self.name, self.GROUP, eid)
        return out

    def __len__(self) -> int:
        return self._r.xlen(self.name)

    def trim(self, maxlen: int) -> int:
        before = self._r.xlen(self.name)
        self._r.xtrim(self.name, maxlen=maxlen)
        return max(0, before - self._r.xlen(self.name))

    def set_result(self, rid: str, value: Any) -> None:
        def _write():
            faults.inject("queue.io")
            self._r.hset(f"result:{rid}", "value", json.dumps(value))

        self._retry.call(_write)

    def get_result(self, rid: str, timeout: float = 10.0) -> Any:
        deadline = time.monotonic() + timeout

        def _read():
            faults.inject("queue.io")
            return self._r.hget(f"result:{rid}", "value")

        while True:
            v = self._retry.call(_read)
            if v is not None:
                self._r.delete(f"result:{rid}")
                return json.loads(v)
            if time.monotonic() >= deadline:
                raise TimeoutError(_timeout_msg(self, rid, timeout))
            time.sleep(0.01)

    def pending_results(self) -> List[str]:
        return [k.split(":", 1)[1] for k in self._r.keys("result:*")]

    def health(self) -> Dict[str, Any]:
        """Probe: PING the server (the reference serving stack's startup
        does the same liveness check before starting the stream)."""
        try:
            self._r.ping()
            return {"ok": True, "backend": "redis", "depth": len(self)}
        except Exception as e:
            return {"ok": False, "backend": "redis", "error": str(e)}


def make_queue(backend: str = "memory", **kw):
    """String lowering for queue backends."""
    b = backend.lower()
    if b in ("memory", "mem"):
        return MemoryQueue(**kw)
    if b in ("file", "spool"):
        return FileQueue(**kw)
    if b in ("redis",):
        return RedisQueue(**kw)
    if b in ("shm", "shared_memory"):
        from analytics_zoo_tpu_torch.deploy.shmqueue import ShmQueue

        return ShmQueue(**kw)
    raise ValueError(f"unknown queue backend {backend!r}; "
                     "known: memory, file, redis, shm")


def make_queue_from_zoo(zoo_cfg, **kw):
    """Queue from the global config: ``serving_queue_backend`` picks the
    transport (``ZOO_SERVING_QUEUE_BACKEND=shm`` env-selects the
    zero-copy path) and the ``serving_shm_*`` knobs size the arena."""
    backend = kw.pop("backend", None) or zoo_cfg.serving_queue_backend
    if backend.lower() in ("shm", "shared_memory"):
        kw.setdefault("slots", zoo_cfg.serving_shm_slots)
        kw.setdefault("slot_bytes", zoo_cfg.serving_shm_slot_bytes)
        kw.setdefault("result_slot_bytes",
                      zoo_cfg.serving_shm_result_slot_bytes)
    return make_queue(backend, **kw)


# ---------------------------------------------------------------------------
# client (reference pyzoo/zoo/serving/client.py:58-150)
# ---------------------------------------------------------------------------

class InputQueue:
    """Producer side: enqueue records for the serving worker.

    The tensor wire format follows the queue: binary backends
    (``queue.wire == "binary"``) get raw ndarrays (framed by the backend,
    zero base64), JSON backends get the legacy ``encode_tensor``
    payloads."""

    def __init__(self, queue):
        self.queue = queue
        self.wire = getattr(queue, "wire", "json")

    @staticmethod
    def _validated_ttl(ttl_ms) -> Optional[float]:
        if ttl_ms is None:
            return None
        if (not isinstance(ttl_ms, (int, float))
                or isinstance(ttl_ms, bool)
                or not np.isfinite(ttl_ms) or ttl_ms <= 0):
            raise MalformedRecordError(
                f"ttl_ms must be a positive finite number, got {ttl_ms!r}")
        return float(ttl_ms)

    def enqueue(self, uri: Optional[str] = None,
                ttl_ms: Optional[float] = None,
                model: Optional[str] = None, **data) -> str:
        """Enqueue arbitrary named arrays (reference enqueue:58).

        Native-client records carry ``ts`` (enqueue wall-clock, feeding
        the ``serving/queue_wait`` / ``serving/e2e`` stage timers) and
        ``fmt: "tensor"`` — the worker answers them with the lossless
        tensor codec instead of ``tolist()`` (OutputQueue decodes
        transparently; reference-wire records keep plain JSON lists).

        ``ttl_ms`` is the client deadline: the worker sheds the record
        with a structured ``expired``/``overloaded`` error instead of
        serving it after the client has given up (docs/SERVING.md).

        Malformed input (no tensors, non-encodable dtype, bad TTL)
        raises :class:`MalformedRecordError` BEFORE anything is pushed —
        a typed client-side rejection, never a poisoned queue."""
        rec: Dict[str, Any] = {"uri": uri or uuid.uuid4().hex,
                               "ts": time.time(), "fmt": "tensor"}
        ttl = self._validated_ttl(ttl_ms)
        if ttl is not None:
            rec["ttl_ms"] = ttl
        if model is not None:
            # routes the record to one named model in a multi-model
            # worker; rides the record meta (str, not a tensor field)
            rec["model"] = str(model)
        if not data:
            raise MalformedRecordError("record carries no tensor fields")
        for k, v in data.items():
            try:
                a = np.asarray(v)
                if a.dtype.hasobject:
                    raise ValueError(
                        f"dtype {a.dtype} is not wire-encodable")
                rec[k] = a if self.wire == "binary" else encode_tensor(a)
            except MalformedRecordError:
                raise
            except Exception as e:
                raise MalformedRecordError(
                    f"field {k!r} is not tensor-encodable: {e}") from e
        return self.queue.push(rec)

    def enqueue_image(self, uri: Optional[str] = None, image=None,
                      ttl_ms: Optional[float] = None) -> str:
        """Enqueue one image (a path, or an ndarray of pixels)."""
        rec = {"uri": uri or uuid.uuid4().hex, "ts": time.time(),
               "fmt": "tensor", **encode_image(image, wire=self.wire)}
        ttl = self._validated_ttl(ttl_ms)
        if ttl is not None:
            rec["ttl_ms"] = ttl
        return self.queue.push(rec)


class OutputQueue:
    """Consumer side: fetch prediction results."""

    def __init__(self, queue):
        self.queue = queue

    @staticmethod
    def _decode_result(val: Any) -> Any:
        # native-client results ride the tensor codec (lossless, typed);
        # everything else (top-N pairs, errors, reference-wire lists)
        # passes through as-is.  Clients get a WRITABLE array either
        # way — results left the slot/spool already, so this copy (if
        # any) is off the serving hot path.
        if isinstance(val, dict) and "tensor" in val:
            return decode_tensor(val["tensor"], writable=True)
        return val

    def query(self, uri: str, timeout: float = 10.0) -> Any:
        """Result for one uri (reference query:140)."""
        return self._decode_result(self.queue.get_result(uri,
                                                         timeout=timeout))

    def dequeue(self, timeout: float = 10.0) -> Dict[str, Any]:
        """Drain all currently-available results (reference dequeue:127)."""
        deadline = time.monotonic() + timeout
        while True:
            pend = self.queue.pending_results()
            if pend:
                return {rid: self._decode_result(
                    self.queue.get_result(rid, timeout=1.0))
                    for rid in pend}
            if time.monotonic() >= deadline:
                return {}
            time.sleep(0.01)


# ---------------------------------------------------------------------------
# the serving worker (reference ClusterServing.scala main loop)
# ---------------------------------------------------------------------------

class ServingConfig:
    """YAML/dict config (reference ClusterServingHelper.scala:104-170).

    Pipeline knobs (docs/SERVING.md): ``max_batch_delay_ms`` is the
    DynamicBatcher's deadline (oldest queued request never waits longer
    for peers), ``decode_workers`` sizes the decode pool, ``replicas``
    the per-device model copies the executor round-robins over, and
    ``max_inflight`` bounds concurrently-dispatched device batches
    (2 = double buffering).  ``pipeline=False`` falls back to the
    synchronous one-thread worker (the bench's ``serving_sync_baseline``
    leg measures exactly that).

    Self-healing knobs (docs/SERVING.md "Failure semantics"):
    ``breaker_threshold`` consecutive failures quarantine a replica,
    ``breaker_cooldown_s`` gates the half-open probe and the
    supervisor's rebuild, ``supervisor_interval_s`` paces the repair
    checks, ``stage_stall_s`` is the stage-heartbeat watchdog deadline,
    ``harvest_deadline_s`` bounds one device readback before the
    replica counts as hung, ``default_ttl_ms`` applies to records with
    no client TTL of their own, and ``supervise=False`` turns the whole
    supervision layer off (bare pipeline, PR-4 behaviour)."""

    def __init__(self, model_path: Optional[str] = None, batch_size: int = 32,
                 backpressure_maxlen: int = 10_000, poll_timeout_s: float = 0.1,
                 postprocess_top_n: Optional[int] = None, int8: bool = False,
                 tensorboard_dir: Optional[str] = None,
                 max_batch_delay_ms: float = 5.0, decode_workers: int = 4,
                 replicas: int = 1, max_inflight: int = 2,
                 pipeline: bool = True, breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 2.0,
                 supervisor_interval_s: float = 0.25,
                 stage_stall_s: float = 10.0,
                 harvest_deadline_s: float = 30.0,
                 default_ttl_ms: Optional[float] = None,
                 supervise: bool = True,
                 slo_p99_ms=0.0,
                 slo_window_s: float = 5.0,
                 flight_dir: Optional[str] = None,
                 jsonl_path: Optional[str] = None,
                 profile_on_breach: bool = False,
                 span_ring: Optional[int] = None,
                 compile_cache_dir: Optional[str] = None,
                 compile_cache_entries: int = 512,
                 hbm_budget_bytes: int = 0,
                 autoscale: bool = False,
                 autoscale_cooldown_s: float = 5.0,
                 autoscale_interval_s: float = 1.0,
                 autoscale_policy=None,
                 mesh_replicas: int = 0):
        self.model_path = model_path
        self.batch_size = batch_size
        self.backpressure_maxlen = backpressure_maxlen
        self.poll_timeout_s = poll_timeout_s
        self.postprocess_top_n = postprocess_top_n
        self.int8 = int8
        self.tensorboard_dir = tensorboard_dir
        self.max_batch_delay_ms = max_batch_delay_ms
        self.decode_workers = max(1, int(decode_workers))
        self.replicas = max(1, int(replicas))
        self.max_inflight = max(1, int(max_inflight))
        self.pipeline = pipeline
        self.breaker_threshold = max(1, int(breaker_threshold))
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.supervisor_interval_s = float(supervisor_interval_s)
        self.stage_stall_s = float(stage_stall_s)
        self.harvest_deadline_s = float(harvest_deadline_s)
        self.default_ttl_ms = default_ttl_ms
        self.supervise = supervise
        # observability (docs/OBSERVABILITY.md): slo_p99_ms > 0 arms the
        # flight recorder's e2e-p99 SLO; breaker trips are watched
        # regardless whenever supervision is on.  Multi-model workers
        # pass a dict {model: p99_ms} — each model gets its own SLO
        # series and admission weight (docs/SERVING.md).
        if isinstance(slo_p99_ms, dict):
            self.slo_p99_ms = {str(k): float(v)
                               for k, v in slo_p99_ms.items()}
        else:
            self.slo_p99_ms = float(slo_p99_ms)
        self.slo_window_s = float(slo_window_s)
        self.flight_dir = flight_dir
        self.jsonl_path = jsonl_path
        self.profile_on_breach = bool(profile_on_breach)
        self.span_ring = span_ring
        # warm start + capacity control (docs/SERVING.md "Warm start &
        # multi-model")
        self.compile_cache_dir = compile_cache_dir or None
        self.compile_cache_entries = max(1, int(compile_cache_entries))
        self.hbm_budget_bytes = max(0, int(hbm_budget_bytes or 0))
        self.autoscale = bool(autoscale)
        self.autoscale_cooldown_s = float(autoscale_cooldown_s)
        self.autoscale_interval_s = float(autoscale_interval_s)
        self.autoscale_policy = autoscale_policy
        # pod-scale mesh replicas are not ported yet (ROADMAP A9)
        if int(mesh_replicas) > 0:
            raise NotImplementedError(
                "mesh replicas are not ported yet (ROADMAP A9); "
                "set mesh_replicas=0")

    def slo_for(self, model: str) -> float:
        """The e2e-p99 SLO (ms) for one model: its dict entry, or the
        scalar applied to every model; 0.0 = unbounded."""
        if isinstance(self.slo_p99_ms, dict):
            return float(self.slo_p99_ms.get(model, 0.0))
        return float(self.slo_p99_ms)

    def slo_models(self) -> Dict[str, float]:
        """Every model with a nonzero SLO (empty for scalar configs —
        the scalar arms the legacy unlabeled watcher instead)."""
        if isinstance(self.slo_p99_ms, dict):
            return {m: v for m, v in self.slo_p99_ms.items() if v > 0}
        return {}

    @classmethod
    def from_yaml(cls, path: str) -> "ServingConfig":
        import yaml

        with open(path) as f:
            blob = yaml.safe_load(f) or {}
        return cls(**blob)

    @classmethod
    def from_zoo(cls, zoo_cfg, **overrides: Any) -> "ServingConfig":
        """Lift the global ``ZooConfig.serving_*`` knobs (ZOO_SERVING_*
        env vars included) into a ServingConfig."""
        kw: Dict[str, Any] = dict(
            batch_size=zoo_cfg.serving_batch_size,
            max_batch_delay_ms=zoo_cfg.serving_max_batch_delay_ms,
            decode_workers=zoo_cfg.serving_decode_workers,
            replicas=zoo_cfg.serving_replicas,
            max_inflight=zoo_cfg.serving_max_inflight,
            breaker_threshold=zoo_cfg.serving_breaker_threshold,
            breaker_cooldown_s=zoo_cfg.serving_breaker_cooldown_s,
            supervisor_interval_s=zoo_cfg.serving_supervisor_interval_s,
            stage_stall_s=zoo_cfg.serving_stage_stall_s,
            harvest_deadline_s=zoo_cfg.serving_harvest_deadline_s,
            default_ttl_ms=zoo_cfg.serving_default_ttl_ms,
            slo_p99_ms=zoo_cfg.serving_slo_p99_ms,
            slo_window_s=zoo_cfg.serving_slo_window_s,
            flight_dir=zoo_cfg.observe_flight_dir or None,
            jsonl_path=zoo_cfg.observe_jsonl_path or None,
            profile_on_breach=zoo_cfg.observe_profile_on_breach,
            span_ring=zoo_cfg.observe_span_ring,
            tensorboard_dir=zoo_cfg.tensorboard_dir,
            compile_cache_dir=zoo_cfg.serving_compile_cache_dir or None,
            hbm_budget_bytes=zoo_cfg.serving_hbm_budget_bytes,
            autoscale=zoo_cfg.serving_autoscale,
            autoscale_cooldown_s=zoo_cfg.serving_autoscale_cooldown_s,
            autoscale_interval_s=zoo_cfg.serving_autoscale_interval_s)
        kw.update(overrides)
        return cls(**kw)


def _decode_record(rec: Dict) -> Dict[str, np.ndarray]:
    """Tensor fields of a claimed record, whatever wire they rode:
    binary-backend ndarrays pass through untouched (zero-copy views on
    shm), legacy ``{"b64": ...}`` payloads decode read-only, and an
    image record's pixels come first, under ``image``."""
    out = {}
    if "image" in rec:
        out["image"] = decode_image(rec)
    for k, v in rec.items():
        if k == "image" or k.startswith("_"):
            continue
        if isinstance(v, np.ndarray):
            out[k] = v
        elif isinstance(v, dict) and "b64" in v:
            out[k] = decode_tensor(v)
    return out


class _ReplicaSlot:
    """One supervised replica position: the replica object, its circuit
    breaker, the owning model's name, and the rebuild bookkeeping."""

    __slots__ = ("replica", "breaker", "index", "rebuilt", "model")

    def __init__(self, replica, breaker, index, model=DEFAULT_MODEL):
        self.replica = replica
        self.breaker = breaker
        self.index = index
        self.model = model
        self.rebuilt = False    # set by rebuild_slot; cleared (and
        #                         counted as restored) on first success


class _Batch:
    """One fused batch moving through the executor.  ``claimed`` is the
    single-ownership flag between the harvest thread and the watchdog:
    whoever sets it (under the executor lock) answers/requeues the
    requests; the other side discards.  A requeue always builds a FRESH
    _Batch so a late readback from an abandoned harvest can never
    double-answer."""

    __slots__ = ("key", "fused", "reqs", "attempt", "slot", "handles",
                 "t_dispatch", "t_harvest", "claimed", "first_blocked_t",
                 "span", "model")

    def __init__(self, key, fused, reqs, attempt=0, model=DEFAULT_MODEL):
        self.key = key
        self.fused = fused
        self.reqs = reqs
        self.attempt = attempt
        self.model = model
        self.slot = None
        self.handles = None
        self.t_dispatch = None
        self.t_harvest = None
        self.claimed = False
        self.first_blocked_t = None
        self.span = None  # device-batch span linking member traces


class _ModelGroup:
    """One named model's executor state: its replica slots, round-robin
    cursor, shape buckets and (optional) sync fallback.  The executor
    multiplexes every group over the same dispatch/harvest threads and
    inflight budget; only the slots and ledgers are per model."""

    __slots__ = ("name", "slots", "rr", "buckets", "fallback")

    def __init__(self, name, slots, buckets, fallback=None):
        self.name = name
        self.slots = slots
        self.rr = 0
        self.buckets = tuple(sorted(buckets))
        self.fallback = fallback


class DeviceExecutor:
    """Stage 3: keeps the card busy with double-buffered async dispatch.

    Multi-model (docs/SERVING.md "Warm start & multi-model"): the
    ``replicas`` / ``buckets`` / ``fallback`` ctor arguments accept
    either the legacy single-model shapes (a list / a tuple / one
    callable — they become the ``"default"`` model) or dicts keyed by
    model name.  One executor then multiplexes N models over the same
    dispatch+harvest threads and ``max_inflight`` budget, with
    *per-model* replica slots, breaker quarantine, round-robin cursors
    and bucket sets; every batch carries its model name into the
    ``{model}`` label of the serving metrics.

    A dispatch thread pulls full batches off a bounded inbox, pads them
    to the model's shape buckets, round-robins them over per-device
    :class:`~analytics_zoo_tpu_torch.deploy.inference.ModelReplica`
    objects, and enqueues the *handle* (the flights: copies in, replays
    and copies out enqueued on the card, with an event after each) onto
    a pending queue whose ``maxsize=max_inflight`` IS the
    double-buffering bound: with 2 in flight, batch N+1 is transferring
    and queueing while N computes.  A separate harvest thread performs
    the only blocking wait, on the flight's event.

    Overlap is counter-verified, not eyeballed: ``serving/device_idle_events``
    counts dispatches that found the device quiet for more than
    ``IDLE_EPS_S`` since the previous harvest (saturated load must keep
    it ~flat), and ``busy()`` lets the decode pool prove it decodes
    while the device computes (``serving/decode_overlap``).

    Self-healing (docs/SERVING.md "Failure semantics"): every replica
    sits in a :class:`_ReplicaSlot` behind a
    :class:`~analytics_zoo_tpu_torch.robust.CircuitBreaker`.  The round-robin
    skips quarantined slots; a failed dispatch/harvest requeues the
    batch (fresh :class:`_Batch`, ``max_retries`` bound) onto healthy
    replicas before any request sees an error.  With every slot
    quarantined the executor degrades to the synchronous ``fallback``
    forward (the ``serve_once`` predict path) instead of hanging, and
    ``check_harvest`` — driven by the supervisor — abandons a readback
    stuck past its deadline: quarantine the replica, requeue the
    in-flight records, respawn the harvest stage.
    """

    IDLE_EPS_S = 0.005  # harvest→dispatch gaps above this count as idle

    def __init__(self, replicas, buckets=(1, 32),
                 max_inflight: int = 2, name: str = "serving",
                 breaker_threshold: int = 3, breaker_cooldown_s: float = 2.0,
                 fallback=None, max_retries: int = 2):
        rep_map = (dict(replicas) if isinstance(replicas, dict)
                   else {DEFAULT_MODEL: list(replicas or [])})
        if not rep_map or not all(rep_map.values()):
            raise ValueError("DeviceExecutor needs at least one replica "
                             "per model")
        self.max_inflight = max(1, int(max_inflight))
        self.name = name
        self.breaker_threshold = max(1, int(breaker_threshold))
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.max_retries = max(0, int(max_retries))
        self._heartbeat: Optional[Callable[[], None]] = None
        self._inbox: "pyqueue.Queue" = pyqueue.Queue(
            maxsize=max(2, self.max_inflight * 4))
        self._pending: "pyqueue.Queue" = pyqueue.Queue(
            maxsize=self.max_inflight)
        self._retryq: "deque[_Batch]" = deque()
        self._lock = threading.Lock()
        bucket_map = buckets if isinstance(buckets, dict) else {}
        fb_map = fallback if isinstance(fallback, dict) else {}
        self._groups: Dict[str, _ModelGroup] = {}
        for mname, reps in rep_map.items():
            self._groups[mname] = _ModelGroup(
                mname, self._make_slots(reps, mname),
                bucket_map.get(mname, buckets if not isinstance(
                    buckets, dict) else (1, 32)),
                fb_map.get(mname) if isinstance(fallback, dict)
                else fallback)
        self._default_model = next(iter(self._groups))
        self._inflight = 0
        self._last_harvest_t: Optional[float] = None
        self._harvesting: Optional[_Batch] = None
        self._harvest_epoch = 0
        self._swap: Optional[Dict[str, List]] = None
        self._stop = threading.Event()
        self._log = logging.getLogger("analytics_zoo_tpu_torch.deploy")
        self._dispatch_thread = threading.Thread(
            target=self._dispatch_loop, daemon=True, name="srv-dispatch")
        self._harvest_thread = threading.Thread(
            target=self._harvest_loop, args=(0,), daemon=True,
            name="srv-harvest")
        self._dispatch_thread.start()
        self._harvest_thread.start()

    def _make_slots(self, replicas: List, model: str = DEFAULT_MODEL
                    ) -> List["_ReplicaSlot"]:
        prefix = (f"{self.name}_replica" if model == DEFAULT_MODEL
                  else f"{self.name}_{model}_replica")
        return [_ReplicaSlot(
            rep, CircuitBreaker(failure_threshold=self.breaker_threshold,
                                cooldown_s=self.breaker_cooldown_s,
                                name=f"{prefix}{i}"), i, model=model)
            for i, rep in enumerate(replicas)]

    # -- legacy single-model views (tests/callers from before multi-model
    # address the default group through these) -----------------------------
    @property
    def _slots(self) -> List["_ReplicaSlot"]:
        return self._groups[self._default_model].slots

    @property
    def buckets(self) -> tuple:
        return self._groups[self._default_model].buckets

    @property
    def _fallback(self):
        return self._groups[self._default_model].fallback

    def models(self) -> List[str]:
        return list(self._groups)

    def group_size(self, model: str) -> int:
        with self._lock:
            g = self._groups.get(model)
            return len(g.slots) if g is not None else 0

    @property
    def replicas(self) -> List:
        """The live replica objects (compat view over the slots; every
        group's slots flattened in insertion order)."""
        with self._lock:
            return [s.replica for g in self._groups.values()
                    for s in g.slots]

    # -- producer side -----------------------------------------------------
    def submit(self, key, fused: List[np.ndarray], reqs: List) -> None:
        """DynamicBatcher ``dispatch_fn``: hand over one fused batch.
        Blocks when ``max_inflight`` batches are already queued — the
        pipeline's backpressure toward the batcher/decoders."""
        if self._stop.is_set():
            raise RuntimeError("DeviceExecutor is stopped")
        model = (getattr(reqs[0], "model", None) if reqs else None) \
            or self._default_model
        self._inbox.put(_Batch(key, fused, reqs, model=model))

    def busy(self) -> bool:
        """True while any batch is dispatched-but-not-harvested."""
        with self._lock:
            return self._inflight > 0

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def swap_replicas(self, replicas, model: Optional[str] = None) -> None:
        """Hot reload: the new replica set takes over at the next
        dispatch (in-flight batches finish on the old weights).  The new
        slots start with fresh (closed) breakers.  ``replicas`` may be a
        list (the default — or the named — model) or a dict of per-model
        lists; partial swaps merge into one pending swap."""
        if isinstance(replicas, dict):
            swap = {str(k): list(v) for k, v in replicas.items()}
        else:
            swap = {model or self._default_model: list(replicas)}
        with self._lock:
            if self._swap is None:
                self._swap = swap
            else:
                self._swap.update(swap)

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._dispatch_thread.join(timeout=timeout)
        self._harvest_thread.join(timeout=timeout)

    def is_alive(self) -> bool:
        return (self._dispatch_thread.is_alive()
                or self._harvest_thread.is_alive())

    # -- supervision surface ----------------------------------------------
    def replica_states(self) -> List[Dict[str, Any]]:
        """Per-slot health for ``health()``: breaker state machine plus
        device identity and owning model."""
        with self._lock:
            slots = [s for g in self._groups.values()
                     for s in g.slots]
        return [dict(slot=s.index, model=s.model,
                     device=str(getattr(s.replica, "device", "host")),
                     rebuilt_pending_probe=s.rebuilt,
                     **s.breaker.snapshot())
                for s in slots]

    def healthy_replicas(self, model: Optional[str] = None) -> int:
        with self._lock:
            if model is not None:
                g = self._groups.get(model)
                slots = g.slots if g is not None else []
            else:
                slots = [s for g in self._groups.values()
                         for s in g.slots]
        return sum(1 for s in slots if s.breaker.health != "quarantined")

    def quarantined_slots(self, min_open_s: float = 0.0
                          ) -> List["_ReplicaSlot"]:
        """Slots whose breaker is open and (open long enough OR already
        failed a probe) — the supervisor's rebuild candidates.  The
        ``opens >= 2`` clause matters under load: the hot dispatch loop
        flips open → half-open at exactly the cooldown, so a
        persistently-bad replica cycles probes without ever *aging* in
        the open state."""
        with self._lock:
            slots = [s for g in self._groups.values()
                     for s in g.slots]
        out = []
        for s in slots:
            snap = s.breaker.snapshot()
            if snap["state"] == "open" and (
                    snap["open_age_s"] >= min_open_s or snap["opens"] >= 2):
                out.append(s)
        return out

    def rebuild_slot(self, index: int, replica,
                     model: Optional[str] = None) -> None:
        """Supervisor repair: swap a fresh replica into one slot.  The
        breaker resets to closed; the first successful harvest through
        the slot counts ``<name>/replica_restored``."""
        model = model or self._default_model
        with self._lock:
            group = self._groups.get(model)
            if group is None:
                return
            for s in group.slots:
                if s.index == index:
                    s.replica = replica
                    s.breaker.reset()
                    s.rebuilt = True
                    break
            else:
                return
        obs.count("serving_replica_events_total", event="rebuilt",
                  replica=index, model=model,
                  flat=f"{self.name}/replica_rebuilt")
        self._log.warning("%s: replica %d (%s) rebuilt and swapped in",
                          self.name, index, model)

    def ensure_threads(self) -> None:
        """Supervisor repair: respawn a dead executor thread (the loops
        are exception-proof, so death is unexpected — but the healer
        assumes nothing)."""
        if self._stop.is_set():
            return
        if not self._dispatch_thread.is_alive():
            obs.count("serving_stage_restarts_total", stage="dispatch",
                      flat=f"{self.name}/stage_restarted")
            self._log.warning("%s: dispatch thread died; restarting",
                              self.name)
            self._dispatch_thread = threading.Thread(
                target=self._dispatch_loop, daemon=True, name="srv-dispatch")
            self._dispatch_thread.start()
        if not self._harvest_thread.is_alive():
            with self._lock:
                self._harvest_epoch += 1
                epoch = self._harvest_epoch
            obs.count("serving_stage_restarts_total", stage="harvest",
                      flat=f"{self.name}/stage_restarted")
            self._log.warning("%s: harvest thread died; restarting",
                              self.name)
            self._harvest_thread = threading.Thread(
                target=self._harvest_loop, args=(epoch,), daemon=True,
                name=f"srv-harvest-{epoch}")
            self._harvest_thread.start()

    def check_harvest(self, deadline_s: float) -> bool:
        """Supervisor watchdog: a readback blocked past ``deadline_s``
        means the replica (or its device stream) is hung.  Claim the
        batch away from the stuck thread, quarantine the replica,
        requeue the records, and respawn the harvest stage.  The stuck
        thread eventually unblocks, sees its batch claimed and its epoch
        superseded, and exits without answering anything."""
        with self._lock:
            batch = self._harvesting
            now = time.monotonic()
            if (batch is None or batch.claimed or batch.t_harvest is None
                    or now - batch.t_harvest <= deadline_s):
                return False
            batch.claimed = True
            self._harvesting = None
            self._inflight -= 1
            self._last_harvest_t = now
            slot = batch.slot
            self._harvest_epoch += 1
            epoch = self._harvest_epoch
        TIMERS.incr(f"{self.name}/harvest_abandoned")
        if batch.span is not None:
            batch.span.end(status="abandoned",
                           error=f"harvest exceeded {deadline_s:.1f}s")
        self._log.warning(
            "%s: harvest readback exceeded %.1fs deadline on replica %s — "
            "abandoning, quarantining, requeueing %d request(s)",
            self.name, deadline_s,
            slot.index if slot is not None else "?", len(batch.reqs))
        if slot is not None and slot.breaker.force_open():
            obs.count("serving_replica_events_total", event="quarantined",
                      replica=slot.index, model=slot.model,
                      flat=f"{self.name}/replica_quarantined")
        self._requeue_or_fail(
            batch, ServingError("device harvest exceeded "
                                f"{deadline_s:.1f}s deadline",
                                code="model_error"))
        self._harvest_thread = threading.Thread(
            target=self._harvest_loop, args=(epoch,), daemon=True,
            name=f"srv-harvest-{epoch}")
        self._harvest_thread.start()
        return True

    # -- failure plumbing --------------------------------------------------
    def _fail_batch(self, batch: "_Batch", exc: BaseException) -> None:
        if not isinstance(exc, ServingError):
            try:
                exc.code = getattr(exc, "code", "model_error")
            except Exception:
                pass
        if batch.span is not None:  # no-op if already terminal
            batch.span.end(status=getattr(exc, "code", None) or "error",
                           error=str(exc))
        for r in batch.reqs:
            r.callback(None, exc)

    def _requeue_or_fail(self, batch: "_Batch", exc: BaseException) -> None:
        """Retry the batch on another replica (fresh _Batch — the old
        object stays claimed so a late abandoned readback is inert), or
        answer typed errors once retries are spent."""
        if batch.attempt < self.max_retries:
            obs.count("serving_batch_retries_total", model=batch.model,
                      flat=f"{self.name}/batch_retries")
            if batch.span is not None:
                batch.span.end(status="retry", error=str(exc))
            fresh = _Batch(batch.key, batch.fused, batch.reqs,
                           attempt=batch.attempt + 1, model=batch.model)
            self._retryq.append(fresh)
        else:
            self._fail_batch(batch, exc)

    def _replica_failed(self, slot: "_ReplicaSlot", batch: "_Batch",
                        exc: BaseException) -> None:
        if slot.breaker.record_failure():
            obs.count("serving_replica_events_total", event="quarantined",
                      replica=slot.index, model=slot.model,
                      flat=f"{self.name}/replica_quarantined")
            self._log.warning(
                "%s: replica %d quarantined after %d consecutive "
                "failure(s); last error: %s", self.name, slot.index,
                slot.breaker.failure_threshold, exc)
        self._requeue_or_fail(batch, exc)

    # -- dispatch ----------------------------------------------------------
    def _next_batch(self) -> Optional["_Batch"]:
        try:
            return self._retryq.popleft()
        except IndexError:
            pass
        try:
            return self._inbox.get(timeout=0.05)
        except pyqueue.Empty:
            return None

    def _pick_slot_locked(self, group: "_ModelGroup"
                          ) -> Optional["_ReplicaSlot"]:
        slots = group.slots
        n = len(slots)
        for k in range(n):
            s = slots[(group.rr + k) % n]
            if s.breaker.allow():
                group.rr = (group.rr + k + 1) % n
                return s
        return None

    def _dispatch_loop(self) -> None:
        while True:
            if self._heartbeat is not None:
                self._heartbeat()
            batch = self._next_batch()
            if batch is None:
                if self._stop.is_set():
                    return  # inbox drained after stop
                continue
            try:
                self._dispatch_one(batch)
            except Exception:
                # the loop must outlive any single batch: answer it and
                # keep dispatching
                self._log.exception("%s: dispatch loop error", self.name)
                self._fail_batch(batch, ServingError(
                    "internal dispatch error", code="internal"))

    def _dispatch_one(self, batch: "_Batch") -> None:
        with self._lock:
            if self._swap is not None:
                for mname, reps in self._swap.items():
                    g = self._groups.get(mname)
                    if g is None:
                        self._groups[mname] = _ModelGroup(
                            mname, self._make_slots(reps, mname),
                            self._groups[self._default_model].buckets)
                    else:
                        g.slots = self._make_slots(reps, mname)
                        g.rr = 0
                self._swap = None
            group = self._groups.get(batch.model)
            # the token axis (dim 1) of the fused input selects the
            # bucket class (plan_buckets)
            x0 = batch.fused[0]
            tokens = (int(x0.shape[1])
                      if getattr(x0, "ndim", 0) >= 2 else None)
            slot = (self._pick_slot_locked(group)
                    if group is not None else None)
            if group is None:
                pass
            elif slot is not None:
                now = time.monotonic()
                if (self._inflight == 0 and self._last_harvest_t is not None
                        and now - self._last_harvest_t > self.IDLE_EPS_S):
                    # the device drained before new work arrived — under
                    # saturated load this must stay ~0 (warmup/drain gaps
                    # are excluded: no previous harvest / no next dispatch)
                    TIMERS.incr(f"{self.name}/device_idle_events")
                    TIMERS.observe(f"{self.name}/device_idle",
                                   now - self._last_harvest_t)
                # count the batch in-flight BEFORE dispatching so even a
                # synchronous fallback forward reads busy() == True while
                # it computes
                self._inflight += 1
        if group is None:
            # a record named a model this executor doesn't host —
            # answer typed, don't poison the dispatch loop
            self._fail_batch(batch, ServingError(
                f"unknown model {batch.model!r}", code="malformed"))
            return
        if slot is None:
            self._no_healthy_replica(batch, group)
            return
        # the batch span links its member record spans: each request's
        # batch_wait span carries the record's trace id
        if batch.span is None:
            batch.span = TRACER.start(
                "serving/device_batch", replica=slot.index,
                model=batch.model,
                rows=batch.fused[0].shape[0], attempt=batch.attempt,
                members=[r.span.trace for r in batch.reqs
                         if getattr(r, "span", None) is not None])
        try:
            plan = faults.fire(f"{self.name}.replica_crash")
            if plan is not None and plan.exc is not None:
                raise plan.exc
            batch.handles = self._dispatch(slot.replica, batch.fused,
                                           group.buckets, tokens=tokens)
        except Exception as e:
            with self._lock:
                self._inflight -= 1
            self._replica_failed(slot, batch, e)
            return
        batch.slot = slot
        batch.t_dispatch = time.monotonic()
        obs.count("serving_batches_total", replica=slot.index,
                  model=batch.model, flat=f"{self.name}/device_batches")
        obs.count("serving_batch_rows_total", batch.fused[0].shape[0],
                  replica=slot.index, model=batch.model,
                  flat=f"{self.name}/device_rows")
        self._pending.put(batch)

    def _no_healthy_replica(self, batch: "_Batch",
                            group: "_ModelGroup") -> None:
        """Every replica is quarantined.  With a ``fallback`` (the
        owning worker's sync predict — the ``serve_once`` path) the
        batch still serves, synchronously, while the supervisor rebuilds
        replicas; without one, the batch waits for a half-open probe
        window and eventually fails typed rather than hanging."""
        if group.fallback is not None:
            with self._lock:
                self._inflight += 1
            try:
                out = group.fallback(batch.fused)
                obs.count("serving_batches_total", replica="fallback",
                          model=batch.model,
                          flat=f"{self.name}/sync_fallback_batches")
                TIMERS.incr(f"{self.name}/device_batches")
                obs.count("serving_batch_rows_total",
                          batch.fused[0].shape[0], replica="fallback",
                          model=batch.model,
                          flat=f"{self.name}/device_rows")
                if batch.span is not None:
                    batch.span.end(fallback=True)
                scatter_batch_results(out, batch.reqs)
            except Exception as e:
                self._requeue_or_fail(batch, e)
            finally:
                with self._lock:
                    self._inflight -= 1
                    self._last_harvest_t = time.monotonic()
            return
        now = time.monotonic()
        if batch.first_blocked_t is None:
            batch.first_blocked_t = now
        if (now - batch.first_blocked_t
                > max(1.0, 4.0 * self.breaker_cooldown_s)):
            self._fail_batch(batch, ServingError(
                "no healthy replica available", code="model_error"))
            return
        time.sleep(0.01)  # wait for a probe window / supervisor rebuild
        self._retryq.append(batch)

    def _dispatch(self, rep, fused: List[np.ndarray], buckets,
                  tokens: Optional[int] = None):
        """Pad to the bucket set and dispatch; a batch larger than the
        biggest bucket splits into full-bucket programs (never compiles
        a one-off shape).  The split/pad plan comes from the SAME
        ``plan_buckets`` the predict path uses, so the executor and the
        compile-shape ledger can never disagree.  ``tokens`` carries the
        batch's sequence length into the bucket-class decision: the
        long-document class plans at the smallest row bucket.
        Returns [(handle, rows), ...]."""
        n = fused[0].shape[0]
        if not rep.pads_input:  # fallback replica: predict() pads itself
            return [(rep.dispatch(fused), n)]
        out, s = [], 0
        for m, bucket in plan_buckets(n, buckets, tokens=tokens):
            chunk = [x[s:s + m] for x in fused]
            if bucket > m:
                chunk = [np.concatenate(
                    [c, np.repeat(c[-1:], bucket - m, axis=0)], axis=0)
                    for c in chunk]
            out.append((rep.dispatch(chunk), m))
            s += m
        return out

    # -- harvest -----------------------------------------------------------
    def _harvest_loop(self, my_epoch: int) -> None:
        while True:
            with self._lock:
                if self._harvest_epoch != my_epoch:
                    return  # superseded by the watchdog's respawn
            try:
                batch = self._pending.get(timeout=0.05)
            except pyqueue.Empty:
                if (self._stop.is_set()
                        and not self._dispatch_thread.is_alive()
                        and self._pending.empty()):
                    return
                continue
            self._harvest_one(batch)

    def _harvest_one(self, batch: "_Batch") -> None:
        slot = batch.slot
        with self._lock:
            self._harvesting = batch
            batch.t_harvest = time.monotonic()
        err: Optional[BaseException] = None
        out = None
        try:
            plan = faults.fire(f"{self.name}.replica_hang")
            if plan is not None:  # simulated wedged readback
                time.sleep(float(plan.payload or 0.5))
                if plan.exc is not None:
                    raise plan.exc
            parts = []
            for h, m in batch.handles:
                outs = slot.replica.harvest(h)  # the one blocking readback
                parts.append([np.asarray(o)[:m] for o in outs])
            outs = (parts[0] if len(parts) == 1 else
                    [np.concatenate([p[i] for p in parts], axis=0)
                     for i in range(len(parts[0]))])
            out = outs if len(outs) > 1 else outs[0]
        except Exception as e:
            err = e
        # claim the batch: exactly one of {this thread, the watchdog}
        # answers it
        with self._lock:
            if self._harvesting is batch:
                self._harvesting = None
            if batch.claimed:
                return  # the watchdog took it while we were stuck
            batch.claimed = True
            self._inflight -= 1
            self._last_harvest_t = time.monotonic()
        if err is not None:
            self._replica_failed(slot, batch, err)
            return
        dt = time.monotonic() - batch.t_dispatch
        obs.observe("serving_stage_seconds", dt, stage="device",
                    model=batch.model, flat=f"{self.name}/device")
        if batch.span is not None:
            batch.span.end(device_s=dt)
        scatter_batch_results(out, batch.reqs)
        if slot.breaker.record_success():
            obs.count("serving_replica_events_total", event="restored",
                      replica=slot.index, model=slot.model,
                      flat=f"{self.name}/replica_restored")
        if slot.rebuilt:
            slot.rebuilt = False
            obs.count("serving_replica_events_total", event="restored",
                      replica=slot.index, model=slot.model,
                      flat=f"{self.name}/replica_restored")


class _SloAdmission:
    """Weighted per-model admission (docs/SERVING.md "Warm start &
    multi-model").  Each model with a nonzero SLO gets a sliding window
    of recent e2e latencies; while its observed p99 exceeds its SLO the
    poller admits only a ``slo/p99`` fraction of that model's incoming
    records (deterministic fractional accumulator, not a coin flip) and
    sheds the rest with a typed ``overloaded`` error — the over-SLO
    model's queue pressure never starves its neighbours."""

    WINDOW = 256        # samples kept per model
    MIN_SAMPLES = 20    # below this, always admit (cold start)
    MIN_FRACTION = 0.05  # never shed more than 95%

    def __init__(self, slos: Dict[str, float]):
        self._slos = {m: float(v) for m, v in slos.items() if v > 0}
        self._lock = threading.Lock()
        self._win: Dict[str, deque] = {
            m: deque(maxlen=self.WINDOW) for m in self._slos}
        self._acc: Dict[str, float] = {m: 0.0 for m in self._slos}

    @property
    def active(self) -> bool:
        return bool(self._slos)

    def note(self, model: str, e2e_s: float) -> None:
        win = self._win.get(model)
        if win is None:
            return
        with self._lock:
            win.append(float(e2e_s))

    def p99(self, model: str) -> float:
        """Observed e2e p99 (ms) over the window; 0.0 = not enough
        samples yet."""
        win = self._win.get(model)
        if win is None:
            return 0.0
        with self._lock:
            xs = sorted(win)
        if len(xs) < self.MIN_SAMPLES:
            return 0.0
        return xs[min(len(xs) - 1, int(0.99 * len(xs)))] * 1e3

    def admit(self, model: str) -> bool:
        slo = self._slos.get(model)
        if slo is None:
            return True
        p99 = self.p99(model)
        if p99 <= slo:
            return True
        frac = max(self.MIN_FRACTION, slo / p99)
        with self._lock:
            self._acc[model] += frac
            if self._acc[model] >= 1.0:
                self._acc[model] -= 1.0
                return True
        return False


class ClusterServing:
    """The serving worker (reference ClusterServing.scala main loop).

    Default mode is the async pipeline (``ServingConfig.pipeline``)::

        poller ─→ decode pool ─→ DynamicBatcher ─→ DeviceExecutor ─→ respond pool
        (claim,    (base64/JSON    (shape buckets,   (pad, round-robin   (codec,
         trim,      + preprocess,   full-or-deadline   replicas, async     set_result,
         reload)    concurrent)     flush)             double-buffer)      metrics)

    ``pipeline=False`` (or calling :meth:`serve_once` directly) runs the
    original synchronous quantum.  One process per card; scale out by
    running more workers on the same file queue (FileQueue hands each
    record to exactly one claimer).  Backpressure trims the
    input stream like the reference's XTRIM-at-memory-threshold
    (ClusterServing.scala:123-138).
    """

    def __init__(self, model, queue, config: Optional[ServingConfig] = None,
                 preprocess: Optional[Callable] = None):
        # ``model`` is one InferenceModel or a dict of named models
        # multiplexed by one executor under a shared device-memory
        # budget.  ``self.model`` stays the single/default model.
        if isinstance(model, dict):
            if not model:
                raise ValueError("ClusterServing needs at least one model")
            self.models: Dict[str, Any] = dict(model)
            for mname, m in self.models.items():
                if getattr(m, "name", None) != mname:
                    m.name = mname
        else:
            self.models = {getattr(model, "name", None)
                           or DEFAULT_MODEL: model}
        self._default_model = next(iter(self.models))
        self.model = self.models[self._default_model]
        self.queue = queue
        self._wire = getattr(queue, "wire", "json")
        self.cfg = config or ServingConfig()
        self._tb = None
        self._tb_last_t = time.monotonic()
        self._tb_last_n = 0
        if self.cfg.tensorboard_dir:
            from analytics_zoo_tpu_torch.core.summary import SummaryWriter
            self._tb = SummaryWriter(self.cfg.tensorboard_dir)
        self.preprocess = preprocess
        self._stop = threading.Event()
        self._stopped = False
        self._thread: Optional[threading.Thread] = None
        self._threads: List[threading.Thread] = []
        self._poller: Optional[threading.Thread] = None
        self._executor: Optional[DeviceExecutor] = None
        self._batcher: Optional[DynamicBatcher] = None
        self._hb: Optional[Heartbeat] = None
        self._supervisor: Optional[Supervisor] = None
        self._topn_on_device = False
        self._topn_by_model: Dict[str, bool] = {}
        self.records_served = 0
        self._count_lock = threading.Lock()
        # warm start: one shared CompileCache for every hosted model
        self._compile_cache = None
        if self.cfg.compile_cache_dir:
            from analytics_zoo_tpu_torch.deploy.compile_cache import (
                CompileCache)
            self._compile_cache = CompileCache(
                self.cfg.compile_cache_dir,
                max_entries=self.cfg.compile_cache_entries)
            for mname, m in self.models.items():
                if getattr(m, "_net", None) is not None:
                    m.attach_compile_cache(self._compile_cache)
        # per-model SLO admission + autoscaler actuator state
        self._admission = _SloAdmission(
            {m: self.cfg.slo_for(m) for m in self.models})
        self._autoscaler = None
        self._scale_lock = threading.Lock()
        self._decode_target = self.cfg.decode_workers
        self._replica_plan: Dict[str, int] = {}
        # observability: spans always on (a dict append per stage hop),
        # event log / flight recorder by config
        self.flight_recorder: Optional[FlightRecorder] = None
        self._event_log: Optional[JsonlEventLog] = None
        if self.cfg.span_ring:
            TRACER.resize(self.cfg.span_ring)
        if self.cfg.jsonl_path:
            self._event_log = JsonlEventLog(self.cfg.jsonl_path)
            self._event_log.attach(TRACER)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ClusterServing":
        if self.is_alive():
            return self
        self._stop.clear()
        self._stopped = False
        if self.cfg.pipeline:
            self._start_pipeline()
        else:
            self._thread = threading.Thread(target=self.run_forever,
                                            daemon=True, name="srv-sync")
            self._thread.start()
        return self

    def _build_replicas(self, model: Optional[str] = None,
                        n: Optional[int] = None) -> List:
        mname = model or self._default_model
        if n is None:
            n = self._replica_plan.get(mname, self.cfg.replicas)
        return self.models[mname].replica_forwards(
            n=n, top_n=self.cfg.postprocess_top_n)

    def _plan_replicas(self) -> Dict[str, int]:
        """Per-model replica counts under the shared device-memory
        budget: every model starts at ``cfg.replicas``; while the summed
        weight bytes exceed ``hbm_budget_bytes`` the heaviest group sheds
        one replica (never below 1 — the budget bounds *copies*, not
        presence)."""
        plan = {m: self.cfg.replicas for m in self.models}
        budget = self.cfg.hbm_budget_bytes
        if not budget:
            return plan
        sizes = {m: max(1, int(getattr(mdl, "weight_nbytes",
                                       lambda: 0)() or 1))
                 for m, mdl in self.models.items()}
        def cost(p):
            return sum(sizes[m] * p[m] for m in p)
        while cost(plan) > budget and any(v > 1 for v in plan.values()):
            heavy = max((m for m in plan if plan[m] > 1),
                        key=lambda m: sizes[m] * plan[m])
            plan[heavy] -= 1
        if cost(plan) > budget:
            logging.getLogger("analytics_zoo_tpu_torch.deploy").warning(
                "serving: even one replica per model (%d bytes) exceeds "
                "the device-memory budget (%d bytes); proceeding at 1 each",
                cost(plan), budget)
        return plan

    def _warm_models(self) -> None:
        """Capture every cached program signature before the replicas are
        built, so a restarted worker's first request hits full bucket
        coverage with zero live captures (``compile_count`` stays 0, cache
        ``hit`` events >= bucket count)."""
        if self._compile_cache is None:
            return
        log = logging.getLogger("analytics_zoo_tpu_torch.deploy")
        t0 = time.perf_counter()
        for mname, m in self.models.items():
            if getattr(m, "_net", None) is None:
                continue
            n = m.warm()
            if n:
                log.info("serving: model %r warm-started %d program(s) "
                         "from %s in %.2fs", mname, n,
                         self.cfg.compile_cache_dir,
                         time.perf_counter() - t0)

    def _start_pipeline(self) -> None:
        self._warm_models()
        self._replica_plan = self._plan_replicas()
        rep_map: Dict[str, List] = {}
        bucket_map: Dict[str, tuple] = {}
        fb_map: Dict[str, Callable] = {}
        for mname, m in self.models.items():
            reps = self._build_replicas(mname)
            rep_map[mname] = reps
            self._topn_by_model[mname] = bool(reps[0].on_device_topn)
            bucket_map[mname] = tuple(
                getattr(m, "batch_buckets", None)
                or (1, self.cfg.batch_size))
            fb_map[mname] = (lambda fused, _m=m: _m.predict(
                fused[0] if len(fused) == 1 else fused))
        self._topn_on_device = self._topn_by_model[self._default_model]
        self._hb = Heartbeat()
        self._executor = DeviceExecutor(
            rep_map, buckets=bucket_map,
            max_inflight=self.cfg.max_inflight,
            breaker_threshold=self.cfg.breaker_threshold,
            breaker_cooldown_s=self.cfg.breaker_cooldown_s,
            fallback=fb_map)
        self._executor._heartbeat = lambda: self._hb.beat("device")
        self._batcher = DynamicBatcher(
            max_batch=self.cfg.batch_size,
            max_latency_ms=self.cfg.max_batch_delay_ms,
            dispatch_fn=self._executor.submit,
            heartbeat=lambda: self._hb.beat("batcher"))
        self._decode_q: "pyqueue.Queue" = pyqueue.Queue(
            maxsize=max(64, self.cfg.batch_size * 4))
        self._respond_q: "pyqueue.Queue" = pyqueue.Queue()
        self._poller = threading.Thread(target=self._poll_loop, daemon=True,
                                        name="srv-poll")
        with self._scale_lock:      # vs a concurrent resize_decode_pool
            self._decode_workers = [
                threading.Thread(target=self._decode_loop, daemon=True,
                                 name=f"srv-decode-{i}")
                for i in range(self._decode_target)]
            decode_workers = list(self._decode_workers)
        self._respond_workers = [
            threading.Thread(target=self._respond_loop, daemon=True,
                             name=f"srv-respond-{i}")
            for i in range(max(1, self.cfg.decode_workers // 2))]
        self._threads = ([self._poller] + decode_workers
                         + self._respond_workers)
        for t in self._threads:
            t.start()
        if self.cfg.supervise:
            self._start_supervisor()

    # -- supervision -------------------------------------------------------
    def _start_supervisor(self) -> None:
        """Background healer: replica rebuilds, the harvest watchdog,
        stage restarts, and health gauges (docs/SERVING.md)."""
        sup = Supervisor(interval_s=self.cfg.supervisor_interval_s,
                         name="serving_supervisor")
        sup.add_check("harvest_watchdog", lambda: self._executor
                      .check_harvest(self.cfg.harvest_deadline_s))
        sup.add_check("heal_replicas", self._heal_replicas)
        reclaim = getattr(self.queue, "reclaim_dead_result_leases", None)
        if callable(reclaim):
            # shm result slots leased to a client that was SIGKILL-ed
            # would otherwise stay READY forever (nobody left to call
            # get_result) — harvest them every tick
            sup.add_check("shm_lease_reclaim", reclaim)
        sup.add_check("stages", self._check_stages)
        sup.add_check("gauges", self._publish_gauges)
        # the flight recorder rides the supervisor cadence: e2e-p99
        # SLOs (per model — e2e series carry a {model} label) plus
        # breaker trips always
        slos = []
        slo_map = self.cfg.slo_models()
        if not slo_map and not isinstance(self.cfg.slo_p99_ms, dict) \
                and self.cfg.slo_p99_ms > 0:
            # scalar config: one shared bound applied to every model
            slo_map = {m: self.cfg.slo_p99_ms for m in self.models}
        for mname, p99_ms in slo_map.items():
            suffix = "" if mname == self._default_model else f"_{mname}"
            slos.append(SLO(f"serving_e2e_p99{suffix}",
                            "serving_stage_seconds",
                            labels={"stage": "e2e", "model": mname},
                            p99_ms=p99_ms, min_count=10))
        profile_dir = None
        if self.cfg.profile_on_breach and self.cfg.flight_dir:
            profile_dir = os.path.join(self.cfg.flight_dir, "profile")
        self.flight_recorder = FlightRecorder(
            slos=slos,
            watch_counters=[("breaker_transitions_total", {"to": "open"})],
            window_s=self.cfg.slo_window_s,
            out_dir=self.cfg.flight_dir or None,
            profile_dir=profile_dir,
            cooldown_s=max(1.0, 2.0 * self.cfg.slo_window_s))
        sup.add_check("flight_recorder", self.flight_recorder.check)
        if self.cfg.autoscale:
            from analytics_zoo_tpu_torch.deploy.autoscale import Autoscaler
            self._autoscaler = Autoscaler(
                self, policy=self.cfg.autoscale_policy)
            every = max(1, int(round(
                self.cfg.autoscale_interval_s
                / self.cfg.supervisor_interval_s)))
            sup.add_check("autoscale", self._autoscaler.check, every=every)
        self._supervisor = sup
        sup.start()

    def _heal_replicas(self) -> None:
        """Rebuild quarantined replicas: a breaker still open after its
        cooldown (or re-opened by a failed probe) gets a FRESH replica —
        new program + weights on the same device — hot-swapped into its
        slot, mirroring the ``swap_replicas`` reload path but per-slot."""
        ex = self._executor
        if ex is None:
            return
        stale = ex.quarantined_slots(min_open_s=self.cfg.breaker_cooldown_s)
        if not stale:
            return
        # one replica_forwards call per affected model rebuilds its full
        # set; pick out the slots that need one (a fresh replica serves
        # from the model's captured programs)
        by_model: Dict[str, List] = {}
        for slot in stale:
            by_model.setdefault(slot.model, []).append(slot)
        for mname, slots in by_model.items():
            if mname not in self.models:
                continue
            fresh = self._build_replicas(mname, n=ex.group_size(mname))
            for slot in slots:
                if slot.index < len(fresh):
                    ex.rebuild_slot(slot.index, fresh[slot.index],
                                    model=mname)

    def _check_stages(self) -> None:
        """Watchdog for wedged/dead stage threads.  A dead thread is
        restarted outright; a live thread whose heartbeat is stale past
        ``stage_stall_s`` is only *flagged* (``serving/stage_stalled``)
        — killing a live Python thread isn't possible, and the harvest
        watchdog already covers the one stage that can block on a
        device."""
        if self._stop.is_set():
            return
        ex = self._executor
        if ex is not None:
            ex.ensure_threads()
        log = logging.getLogger("analytics_zoo_tpu_torch.deploy")
        if self._poller is not None and not self._poller.is_alive():
            obs.count("serving_stage_restarts_total", stage="poller",
                      flat="serving/stage_restarted")
            log.warning("serving poller died; restarting")
            self._poller = threading.Thread(
                target=self._poll_loop, daemon=True, name="srv-poll")
            self._threads.append(self._poller)
            self._poller.start()
        with self._scale_lock:
            # prune dead workers, then top up only to the AUTOSCALER'S
            # target — a shrink retires workers via sentinel, and those
            # intentional deaths must not be resurrected here
            alive = [t for t in self._decode_workers if t.is_alive()]
            pruned = len(self._decode_workers) - len(alive)
            self._decode_workers = alive
            deficit = self._decode_target - len(alive)
            for _ in range(max(0, deficit)):
                obs.count("serving_stage_restarts_total", stage="decode",
                          flat="serving/stage_restarted")
                log.warning("decode pool below target (%d/%d); restarting",
                            len(self._decode_workers), self._decode_target)
                nt = threading.Thread(
                    target=self._decode_loop, daemon=True,
                    name=f"srv-decode-{len(self._decode_workers)}")
                self._decode_workers.append(nt)
                self._threads.append(nt)
                nt.start()
            if pruned and deficit <= 0:
                log.info("decode pool pruned %d retired worker(s) "
                         "(target %d)", pruned, self._decode_target)
        for i, t in enumerate(self._respond_workers):
            if not t.is_alive():
                obs.count("serving_stage_restarts_total", stage="respond",
                          flat="serving/stage_restarted")
                log.warning("respond worker %d died; restarting", i)
                nt = threading.Thread(target=self._respond_loop, daemon=True,
                                      name=f"srv-respond-{i}")
                self._respond_workers[i] = nt
                self._threads.append(nt)
                nt.start()
        if self._hb is not None:
            # an idle stage blocks on its queue with an aging heartbeat —
            # only a stale beat WITH work pending means wedged
            busy = (self._decode_q.qsize() > 0
                    or self._respond_q.qsize() > 0
                    or (ex is not None and ex.inflight > 0))
            if busy:
                for stage, age in self._hb.ages().items():
                    if age > self.cfg.stage_stall_s:
                        TIMERS.incr(f"serving/stage_stalled/{stage}")

    # -- autoscaler actuators (deploy/autoscale.py drives these) -----------
    def resize_decode_pool(self, n: int) -> int:
        """Grow/shrink the decode pool to ``n`` threads.  Growth spawns
        immediately; shrink retires workers with ``None`` sentinels (a
        worker finishes its current record, then exits) and
        ``_check_stages`` prunes the dead threads next tick."""
        n = max(1, int(n))
        with self._scale_lock:
            cur = self._decode_target
            self._decode_target = n
            if n > cur:
                for i in range(n - cur):
                    nt = threading.Thread(
                        target=self._decode_loop, daemon=True,
                        name=f"srv-decode-{len(self._decode_workers) + i}")
                    self._decode_workers.append(nt)
                    self._threads.append(nt)
                    nt.start()
            else:
                for _ in range(cur - n):
                    self._decode_q.put(None)
        return n

    def _budget_allows(self, model: str, extra: int) -> bool:
        """True if ``extra`` more replicas of ``model`` fit the shared
        device-memory budget (0/unset = unlimited)."""
        budget = self.cfg.hbm_budget_bytes
        if not budget or self._executor is None:
            return True
        used = 0
        for mname, m in self.models.items():
            nb = int(getattr(m, "weight_nbytes", lambda: 0)() or 0)
            used += nb * self._executor.group_size(mname)
        add = int(getattr(self.models[model], "weight_nbytes",
                          lambda: 0)() or 0) * extra
        return used + add <= budget

    def resize_model_replicas(self, model: str, n: int) -> int:
        """Rebuild one model's replica group at ``n`` copies (hot swap —
        in-flight batches finish on the old set).  A grow that would
        bust the device-memory budget is refused (returns the current
        size)."""
        n = max(1, int(n))
        ex = self._executor
        if ex is None or model not in self.models:
            return 0
        cur = ex.group_size(model)
        if n == cur:
            return cur
        if n > cur and not self._budget_allows(model, n - cur):
            logging.getLogger("analytics_zoo_tpu_torch.deploy").warning(
                "serving: replica grow %s -> %d refused (memory budget)",
                model, n)
            return cur
        reps = self._build_replicas(model, n=n)
        ex.swap_replicas(reps, model=model)
        self._replica_plan[model] = n
        return n

    def set_batch_deadline_ms(self, ms: float) -> float:
        """Retune the DynamicBatcher's flush deadline in place."""
        ms = max(0.1, float(ms))
        if self._batcher is not None:
            self._batcher.max_latency = ms / 1e3
        return ms

    # -- scenario hooks (the loadgen harness rides these) ------------------
    def add_scenario_check(self, name: str, fn, every: int = 1) -> bool:
        """Register an extra periodic check on the serving supervisor —
        the loadgen harness uses it to export status snapshots and to
        script mid-run events at the supervisor cadence.  Returns False
        when there is no supervisor to ride (``supervise=False`` or the
        sync engine)."""
        if self._supervisor is None:
            return False
        self._supervisor.add_check(name, fn, every=every)
        return True

    def autoscale_actions(self) -> List[Dict[str, Any]]:
        """The autoscaler's applied-action audit ledger (deep copies;
        empty when autoscaling is off) — the convergence assertions in
        the loadgen soak read this, not internals."""
        if self._autoscaler is None:
            return []
        return self._autoscaler.export_actions()

    def autoscale_audit(self) -> Optional[Dict[str, Any]]:
        """Hysteresis audit over the action ledger (flap detection —
        :func:`deploy.autoscale.audit_actions`); None when off."""
        if self._autoscaler is None:
            return None
        return self._autoscaler.audit()

    def _publish_gauges(self) -> None:
        ex = self._executor
        if ex is not None:
            obs.set_gauge("serving_replicas_healthy",
                          ex.healthy_replicas(),
                          flat="serving/replicas_healthy")
            for mname in ex.models():
                obs.set_gauge("serving_replicas_healthy",
                              ex.healthy_replicas(mname), model=mname,
                              flat=f"serving/replicas_healthy/{mname}")
            obs.set_gauge("serving_inflight", ex.inflight,
                          flat="serving/inflight")
        if self._hb is not None:
            for stage, age in self._hb.ages().items():
                obs.set_gauge("serving_heartbeat_age_seconds", age,
                              stage=stage,
                              flat=f"serving/heartbeat_age_s/{stage}")

    def is_alive(self) -> bool:
        """True while any worker thread (pipeline stage or sync loop) is
        running — mirror of ``PrefetchIterator``'s liveness probe."""
        threads = list(self._threads)
        if self._thread is not None:
            threads.append(self._thread)
        if self._executor is not None and self._executor.is_alive():
            return True
        return any(t.is_alive() for t in threads)

    def stop(self, timeout: float = 5.0) -> None:
        """Graceful, idempotent shutdown: stages drain in pipeline order
        (claimed records are answered, not lost).  A thread that
        outlives ``timeout`` is logged as leaked — mirroring
        ``PrefetchIterator.close()`` — instead of silently abandoned."""
        if self._stopped:
            return
        self._stopped = True
        self._stop.set()
        log = logging.getLogger("analytics_zoo_tpu_torch.deploy")
        if self._supervisor is not None:
            # the healer goes down FIRST so it can't resurrect stages
            # that are draining on purpose
            self._supervisor.stop(timeout=timeout)
        if self._threads:  # pipeline mode
            self._poller.join(timeout=timeout)
            with self._scale_lock:  # snapshot vs a late autoscaler tick
                decode_workers = list(self._decode_workers)
            for _ in decode_workers:
                self._decode_q.put(None)
            for t in decode_workers:
                t.join(timeout=timeout)
            if self._batcher is not None:
                self._batcher.close(flush=True)
            if self._executor is not None:
                self._executor.stop(timeout=timeout)
            for _ in self._respond_workers:
                self._respond_q.put(None)
            for t in self._respond_workers:
                t.join(timeout=timeout)
        elif self._thread is not None:
            self._thread.join(timeout=timeout)
        if self.is_alive():
            leaked = [t.name for t in self._threads + (
                [self._thread] if self._thread else []) if t.is_alive()]
            log.warning(
                "ClusterServing.stop(): worker thread(s) %s still alive "
                "after %.1fs — leaked (likely stuck in model forward or "
                "backend I/O)", leaked or ["device-executor"], timeout)
        if self._tb is not None:
            self._tb.flush()
        if self._event_log is not None:
            # one final metrics dump so the log tail always carries the
            # end-of-run registry state
            self._event_log.detach(TRACER)
            self._event_log.metrics_dump()
            self._event_log.close()

    # -- deadline-aware admission (docs/SERVING.md "Failure semantics") ----
    def _record_ttl_s(self, rec: Dict) -> Optional[float]:
        """Remaining time budget in seconds for a claimed record, from
        its enqueue timestamp + client TTL (or the config default).
        None = no deadline; <= 0 = already expired."""
        ttl_ms = rec.get("ttl_ms")
        if ttl_ms is None:
            ttl_ms = self.cfg.default_ttl_ms
        if ttl_ms is None:
            return None
        try:
            ttl_ms = float(ttl_ms)
        except (TypeError, ValueError):
            return None
        ts = rec.get("ts")
        age = (time.time() - ts) if isinstance(ts, (int, float)) else 0.0
        return ttl_ms / 1e3 - age

    def _shed(self, rid: str, rec: Dict, code: str, msg: str) -> None:
        """Answer a shed record with a structured error — every claimed
        record terminates in a result or a typed error payload, never
        silence.  The record's root span (started at claim, or here for
        the sync path) ends with the shed code as its terminal status."""
        model = rec.get("model") or self._default_model
        obs.count("serving_shed_total", code=code, model=model,
                  flat=f"serving/shed_{'expired' if code == 'expired' else 'early'}")
        obs.count("serving_errors_total", code=code, model=model,
                  flat="serving/errors_returned")
        sp = rec.pop("_span", None)
        if sp is None:
            sp = TRACER.start("serving/request", uri=rec.get("uri") or rid)
        sp.end(status=code, error=msg)
        try:
            self.queue.set_result(
                rid, error_payload(code, msg, uri=rec.get("uri")))
        except Exception:
            logging.getLogger("analytics_zoo_tpu_torch.deploy").exception(
                "failed to write shed-error result for %r", rid)

    # -- pipeline stages ---------------------------------------------------
    def _poll_loop(self) -> None:
        """Stage 1: claim records, account queue-wait, shed expired /
        hopeless work before it costs decode+dispatch, apply
        backpressure and hot reload, feed the decode pool."""
        log = logging.getLogger("analytics_zoo_tpu_torch.deploy")
        while not self._stop.is_set():
            try:
                self._hb.beat("poller")
                if self._maybe_reload():
                    self._executor.swap_replicas(self._build_replicas())
                dropped = self.queue.trim(self.cfg.backpressure_maxlen)
                if dropped:
                    TIMERS.incr("serving/backpressure_dropped", dropped)
                    log.warning("backpressure: dropped %d queued records",
                                dropped)
                batch = self.queue.pop_batch(self.cfg.batch_size,
                                             timeout=self.cfg.poll_timeout_s)
                now = time.time()
                for rid, rec in batch:
                    # root span: trace id is fresh per claim (rids may
                    # repeat across runs); the rid rides as the uri attr
                    rec["_span"] = TRACER.start("serving/request",
                                                uri=rec.get("uri") or rid)
                    # multi-model routing + weighted admission: resolve
                    # the target model, reject unknown names typed, and
                    # shed a fraction of an over-SLO model's traffic
                    # BEFORE it costs decode/dispatch
                    model = rec.get("model") or self._default_model
                    if model not in self.models:
                        self._shed(rid, rec, "malformed",
                                   f"unknown model {model!r}")
                        continue
                    rec["model"] = model
                    if not self._admission.admit(model):
                        self._shed(
                            rid, rec, "overloaded",
                            f"model {model!r} over its p99 SLO "
                            f"({self._admission.p99(model):.0f}ms > "
                            f"{self.cfg.slo_for(model):.0f}ms); "
                            "weighted admission shed")
                        continue
                    ts = rec.get("ts")
                    if isinstance(ts, (int, float)):
                        obs.observe("serving_stage_seconds",
                                    max(0.0, now - ts), stage="queue_wait",
                                    model=model, flat="serving/queue_wait")
                    remaining = self._record_ttl_s(rec)
                    if remaining is not None:
                        if remaining <= 0:
                            self._shed(rid, rec, "expired",
                                       "client TTL expired before decode")
                            continue
                        # estimated time-to-answer from recent e2e p50:
                        # if the pipeline can't plausibly make the
                        # deadline, failing fast beats a late answer
                        est = TIMERS.percentile("serving/e2e", 50)
                        if est > 0 and est > remaining:
                            self._shed(
                                rid, rec, "overloaded",
                                f"estimated service time {est * 1e3:.0f}ms "
                                f"exceeds remaining TTL "
                                f"{remaining * 1e3:.0f}ms")
                            continue
                        rec["_deadline_mono"] = time.monotonic() + remaining
                    while not self._stop.is_set():
                        try:
                            self._decode_q.put((rid, rec), timeout=0.1)
                            break
                        except pyqueue.Full:
                            continue
            except Exception:
                log.exception("serving poller failed; worker continues")
                time.sleep(0.05)

    def _decode_loop(self) -> None:
        """Stage 2a: base64/JSON decode + host preprocess, concurrent
        with device compute (``serving/decode_overlap`` proves it)."""
        while True:
            item = self._decode_q.get()
            if item is None:
                return
            self._hb.beat("decode")
            rid, rec = item
            deadline = rec.get("_deadline_mono")
            model = rec.get("model") or self._default_model
            root = rec.get("_span")
            dsp = None
            try:
                faults.inject("serving.decode_error")
                if root is not None:
                    dsp = TRACER.start("serving/decode", trace=root.trace,
                                       parent=root.sid, model=model)
                with obs.time_stage("serving_stage_seconds",
                                    stage="decode", model=model,
                                    flat="serving/decode"):
                    decoded = _decode_record(rec)
                    # the image, else the first tensor field, is the
                    # model's input
                    x = next(iter(decoded.values()), None)
                    if x is None:
                        raise MalformedRecordError(
                            "record decoded to no tensor fields")
                    if self.preprocess is not None:
                        x = self.preprocess(x)
                    x = np.asarray(x)
                if dsp is not None:
                    dsp.end()
                # the decode itself may have eaten the rest of the budget
                if deadline is not None and time.monotonic() > deadline:
                    raise DeadlineExpired(
                        "client TTL expired during decode")
                if self._executor.busy():
                    TIMERS.incr("serving/decode_overlap")
                wsp = None
                if root is not None:
                    # ended by the DynamicBatcher at flush/shed time —
                    # the batch_wait leg of the record's timeline
                    wsp = TRACER.start("serving/batch_wait",
                                       trace=root.trace, parent=root.sid)
                self._batcher.submit(
                    [x[None]],
                    lambda out, err, _rid=rid, _rec=rec:
                        self._respond_q.put((_rid, _rec, out, err)),
                    deadline=deadline, span=wsp,
                    model=rec.get("model"))
            except Exception as e:
                # a bad record answers with an error instead of poisoning
                # the pipeline (clients see it in query(), not a hang)
                if isinstance(e, DeadlineExpired):
                    obs.count("serving_shed_total", code="expired",
                              model=model, flat="serving/shed_expired")
                elif not isinstance(e, ServingError):
                    try:
                        e.code = getattr(e, "code", "decode_error")
                    except Exception:
                        pass
                if dsp is not None:
                    dsp.end(status=getattr(e, "code", None) or "error",
                            error=str(e))
                self._respond_q.put((rid, rec, None, e))

    def _respond_loop(self) -> None:
        """Stage 4: format + write results, close the e2e span, emit
        TensorBoard scalars.  Writes are BATCHED: the worker greedily
        drains whatever is already queued (up to one device batch) and
        publishes the whole group through one ``set_result_many`` round
        — on ShmQueue that is one lock claim for N results instead of N.
        Transient result-store failures retry (above the backend's own
        I/O retries); a formatting failure degrades to a typed
        internal-error payload — the record still terminates."""
        log = logging.getLogger("analytics_zoo_tpu_torch.deploy")
        retry = _io_retry("serving_respond", retry_on=(Exception,))
        cap = max(8, self.cfg.batch_size)
        while True:
            item = self._respond_q.get()
            if item is None:
                return
            items = [item]
            while len(items) < cap:
                try:
                    nxt = self._respond_q.get_nowait()
                except pyqueue.Empty:
                    break
                if nxt is None:
                    # hand the stop sentinel on (ours arrives at the
                    # next blocking get) and publish what we have
                    self._respond_q.put(None)
                    break
                items.append(nxt)
            self._hb.beat("respond")
            self._respond_many(items, retry, log)

    def _respond_many(self, items: List, retry, log) -> None:
        t0 = time.perf_counter()
        prepared: List[Tuple] = []  # (rid, rec, val, root, rsp)
        for rid, rec, out, err in items:
            root = rec.pop("_span", None)
            rsp = None
            if root is not None:
                rsp = TRACER.start("serving/respond", trace=root.trace,
                                   parent=root.sid)
            try:
                faults.inject("serving.respond_error")
                val = self._format_result(out, err, rec)
            except Exception as fe:
                log.exception("result formatting failed for %r", rid)
                val = error_payload(
                    "internal", f"result formatting failed: {fe}",
                    uri=rec.get("uri"))
            if isinstance(val, dict) and "error" in val:
                obs.count("serving_errors_total",
                          code=val.get("code") or "internal",
                          model=rec.get("model") or self._default_model,
                          flat="serving/errors_returned")
            prepared.append((rid, rec, val, root, rsp))

        def _write():
            pairs = []
            for _rid, _rec, _val, _root, _rsp in prepared:
                # keep the per-record fault cadence the chaos plans
                # target, batched write or not
                faults.inject("serving.queue_io")
                pairs.append((_rid, _val))
            many = getattr(self.queue, "set_result_many", None)
            if many is not None:
                many(pairs)
            else:
                for _rid, _val in pairs:
                    self.queue.set_result(_rid, _val)

        try:
            retry.call(_write)
        except Exception:
            TIMERS.incr("serving/respond_failed", len(prepared))
            log.exception("serving respond failed for %d record(s)",
                          len(prepared))
            for _rid, _rec, _val, root, rsp in prepared:
                if rsp is not None:
                    rsp.end(status="error", error="respond failed")
                if root is not None:
                    root.end(status="internal", error="respond failed")
            return
        if len(prepared) > 1:
            TIMERS.incr("serving/respond_batched_writes")
        # per-record stage time: the batch wall time amortized over its
        # members, so breakdown math (total / records) stays honest
        per = (time.perf_counter() - t0) / len(prepared)
        now = time.time()
        for rid, rec, val, root, rsp in prepared:
            model = rec.get("model") or self._default_model
            obs.observe("serving_stage_seconds", per, stage="respond",
                        model=model, flat="serving/respond")
            # terminal spans: the respond leg, then the root with the
            # typed outcome — the span chain is now reconstructable
            outcome_code = (val.get("code") or "internal") \
                if isinstance(val, dict) and "error" in val else "ok"
            if rsp is not None:
                rsp.end()
            if root is not None:
                root.end(status=outcome_code)
            obs.count("serving_records_total", model=model,
                      outcome="ok" if outcome_code == "ok" else "error")
            ts = rec.get("ts")
            if isinstance(ts, (int, float)):
                e2e = max(0.0, now - ts)
                obs.observe("serving_stage_seconds", e2e, stage="e2e",
                            model=model, flat="serving/e2e")
                # feed the per-model admission window (only models with
                # an SLO keep one)
                self._admission.note(model, e2e)
        with self._count_lock:
            self.records_served += len(prepared)
        self._maybe_tb_flush()

    def _maybe_tb_flush(self) -> None:
        """The serving scalars, every 32 records or second at most."""
        if self._tb is None:
            return
        now = time.monotonic()
        with self._count_lock:
            n, dt = self.records_served, now - self._tb_last_t
            if n - self._tb_last_n < 32 and dt < 1.0:
                return
            delta = n - self._tb_last_n
            self._tb_last_t, self._tb_last_n = now, n
        self._tb.add_scalar("serving_throughput",
                            delta / dt if dt > 0 else 0.0, n)
        self._tb.add_scalar("total_records", n, n)
        for stage in ("queue_wait", "decode", "batch_wait", "device",
                      "respond", "e2e"):
            p99 = TIMERS.percentile(f"serving/{stage}", 99)
            if p99:
                self._tb.add_scalar(f"serving_{stage}_p99_ms", p99 * 1e3, n)
        if self._executor is not None:
            self._tb.add_scalar("serving_replicas_healthy",
                                self._executor.healthy_replicas(), n)

    def _format_result(self, out, err, rec: Dict) -> Any:
        """One result value for the wire: typed error payload, top-N
        pairs, or the raw row (tensor-codec envelope for native clients,
        ``tolist()`` for reference-wire records)."""
        if err is not None:
            code = getattr(err, "code", None) or "internal"
            return error_payload(code, err, uri=rec.get("uri"))
        top_n = self.cfg.postprocess_top_n
        outs = out if isinstance(out, list) else [out]
        topn_on_device = self._topn_by_model.get(
            rec.get("model") or self._default_model, self._topn_on_device)
        if top_n and topn_on_device and len(outs) == 2:
            # the jitted forward already ran lax.top_k: outs = (idx, val)
            idx, vals = np.asarray(outs[0])[0], np.asarray(outs[1])[0]
            return [[int(i), float(v)] for i, v in zip(idx, vals)]
        row = np.asarray(outs[0])
        # pipeline requests are single-row: drop the leading batch axis so
        # the wire value matches what serve_once returns per record
        if row.ndim > 1 or (row.ndim == 1 and row.dtype.kind in "OUS"
                            and row.shape[0] == 1):
            row = row[0] if row.shape[0] == 1 else row
        row = np.asarray(row)
        return self._format_row(row, native=rec.get("fmt") == "tensor")

    def _format_row(self, row: np.ndarray, native: bool) -> Any:
        top_n = self.cfg.postprocess_top_n
        if top_n and row.ndim == 1 and row.dtype.kind in "biufc":
            # top-N (class, prob) pairs — reference PostProcessing topN
            idx = np.argsort(row)[::-1][:top_n]
            return [[int(j), float(row[j])] for j in idx]
        if native and row.dtype.kind in "biufc":
            if self._wire == "binary":
                # the backend frames the raw array itself — no base64
                return {"tensor": row}
            return {"tensor": encode_tensor(row)}
        # object/str rows (e.g. a detector forward returning JSON blobs)
        # can't ride the tensor codec — hand the value through as-is
        return row.tolist()

    def health(self) -> Dict[str, Any]:
        """Liveness + per-stage latency rollups + pipeline counters."""
        qh = (self.queue.health() if hasattr(self.queue, "health")
              else {"ok": True})
        stages = {}
        for k, v in TIMERS.stats().items():
            if k.startswith("serving/"):
                stages[k.split("/", 1)[1]] = {
                    "count": v["count"],
                    "mean_ms": v["mean_s"] * 1e3,
                    "p50_ms": v["p50_s"] * 1e3,
                    "p99_ms": v["p99_s"] * 1e3}
        with self._count_lock:
            records_served = self.records_served
        h: Dict[str, Any] = {
            "ok": bool(qh.get("ok", True)),
            "running": self.is_alive(),
            "records_served": records_served,
            "queue": qh,
            "stages": stages,
            "counters": {k: n for k, n in TIMERS.counts().items()
                         if k.startswith(("serving/", "inference/"))},
        }
        if self._executor is not None:
            h["inflight"] = self._executor.inflight
            h["replicas"] = len(self._executor.replicas)
            h["replicas_healthy"] = self._executor.healthy_replicas()
            h["replica_states"] = self._executor.replica_states()
            h["models"] = {
                m: {"replicas": self._executor.group_size(m),
                    "replicas_healthy": self._executor.healthy_replicas(m),
                    "slo_p99_ms": self.cfg.slo_for(m),
                    "observed_p99_ms": self._admission.p99(m),
                    "compile_count": getattr(self.models.get(m),
                                             "compile_count", 0),
                    "warm_count": getattr(self.models.get(m),
                                          "warm_count", 0)}
                for m in self._executor.models()}
        if self._compile_cache is not None:
            h["compile_cache"] = self._compile_cache.stats()
        if self._autoscaler is not None:
            h["autoscale"] = self._autoscaler.stats()
            # convergence at a glance (full flap events via autoscale_audit)
            audit = self._autoscaler.audit()
            h["autoscale"]["flaps"] = audit["flaps"]
            h["autoscale"]["quiet_s"] = audit["quiet_s"]
        with self._scale_lock:
            h["decode_target"] = self._decode_target
        if self._hb is not None:
            h["stage_heartbeat_age_s"] = self._hb.ages()
        if self._supervisor is not None:
            h["supervisor"] = self._supervisor.is_alive()
        gauges = {k: v for k, v in TIMERS.gauges().items()
                  if k.startswith("serving/")}
        if gauges:
            h["gauges"] = gauges
        observe: Dict[str, Any] = {
            "span_ring": TRACER.ring_size(),
            "spans_completed": TRACER.completed_count(),
            "spans_active": TRACER.active_count(),
            "metric_series": obs.METRICS.series_count(),
        }
        if self.flight_recorder is not None:
            observe["flight_recorder"] = self.flight_recorder.stats()
        h["observe"] = observe
        return h

    def metrics_text(self) -> str:
        """The labeled metric registry in Prometheus text format —
        scrape endpoint payload (``parse_prometheus`` round-trips it)."""
        return to_prometheus(obs.METRICS)

    # -- model hot reload (reference ClusterServingHelper.scala:185-193:
    # the config/model path is re-checked periodically and the serving
    # model swapped in place without stopping the stream) ----------------
    def enable_hot_reload(self, model_path: str,
                          check_interval_s: float = 10.0
                          ) -> "ClusterServing":
        self._reload_path = model_path
        self._reload_interval = check_interval_s
        self._reload_last_check = 0.0
        self._reload_mtime = self._path_mtime(model_path)
        return self

    @staticmethod
    def _path_mtime(path: str) -> float:
        if os.path.isdir(path):
            return max((os.path.getmtime(os.path.join(path, f))
                        for f in os.listdir(path)), default=0.0)
        return os.path.getmtime(path) if os.path.exists(path) else 0.0

    def _maybe_reload(self) -> bool:
        path = getattr(self, "_reload_path", None)
        if path is None:
            return False
        now = time.time()
        if now - self._reload_last_check < self._reload_interval:
            return False
        self._reload_last_check = now
        mtime = self._path_mtime(path)
        if mtime <= self._reload_mtime:
            return False
        # save_model writes config.json + weights.npz non-atomically:
        # only reload once the mtime has been STABLE for a full check
        # interval, so a mid-write snapshot (new config + old weights,
        # or a truncated npz) is never loaded
        if mtime != getattr(self, "_reload_pending_mtime", None):
            self._reload_pending_mtime = mtime
            return False
        from analytics_zoo_tpu_torch.deploy.inference import InferenceModel

        import logging
        logging.getLogger("analytics_zoo_tpu_torch.deploy").info(
            "model at %s changed (mtime %.0f); hot-reloading", path, mtime)
        old = self.models.get(self._default_model)
        self.model = InferenceModel.load(
            path, device=getattr(old, "device", None),
            batch_buckets=getattr(old, "batch_buckets", (1, 8, 64, 256)),
            preprocess=getattr(old, "_preprocess", None),
            weight_dtype=getattr(old, "_weight_dtype", None))
        self.model.name = self._default_model
        self.models[self._default_model] = self.model
        if (self._compile_cache is not None
                and getattr(self.model, "_net", None) is not None):
            self.model.attach_compile_cache(self._compile_cache)
        self._reload_mtime = mtime
        self._reload_pending_mtime = None
        return True

    def run_forever(self) -> None:
        import logging

        log = logging.getLogger("analytics_zoo_tpu_torch.deploy")
        while not self._stop.is_set():
            try:
                self._maybe_reload()
                self.serve_once()
            except Exception:  # keep serving: one bad batch must not
                log.exception("serving batch failed; worker continues")
                time.sleep(0.05)  # kill the worker (reference keeps its
                #                   streaming query alive the same way)

    # -- one scheduling quantum (sync mode / tests / bench baseline) ------
    def serve_once(self) -> int:
        """Serve up to one batch; returns number of records served.

        Records are grouped by decoded shape/dtype and each group served
        as its own (bucket-padded) batch — a record whose shape differs
        from its neighbors is servable, not an error (mixed 224/299
        traffic in one poll just becomes two programs)."""
        dropped = self.queue.trim(self.cfg.backpressure_maxlen)
        if dropped:
            logging.getLogger("analytics_zoo_tpu_torch.deploy").warning(
                "backpressure: dropped %d queued records", dropped)
        batch = self.queue.pop_batch(self.cfg.batch_size,
                                     timeout=self.cfg.poll_timeout_s)
        if not batch:
            return 0
        t0 = time.perf_counter()
        groups: Dict[Any, List] = {}  # (shape, dtype) -> [(rid, x, native)]
        for rid, rec in batch:
            # root span for the sync path too: _shed/error/success all
            # terminate it, so span chains reconstruct either way
            rec["_span"] = TRACER.start("serving/request", sync=True,
                                        uri=rec.get("uri") or rid)
            remaining = self._record_ttl_s(rec)
            if remaining is not None and remaining <= 0:
                self._shed(rid, rec, "expired",
                           "client TTL expired before decode")
                continue
            model = rec.get("model") or self._default_model
            if model not in self.models:
                self._shed(rid, rec, "malformed",
                           f"unknown model {model!r}")
                continue
            rec["model"] = model
            try:
                decoded = _decode_record(rec)
                x = next(iter(decoded.values()), None)
                if x is None:
                    raise MalformedRecordError(
                        "record decoded to no tensor fields")
                if self.preprocess is not None:
                    x = self.preprocess(x)
                x = np.asarray(x)
            except Exception as e:
                # a bad record answers with an error instead of poisoning
                # the batch (clients see it in query() rather than a hang)
                code = getattr(e, "code", None) or "decode_error"
                obs.count("serving_errors_total", code=code, model=model,
                          flat="serving/errors_returned")
                sp = rec.pop("_span", None)
                if sp is not None:
                    sp.end(status=code, error=str(e))
                self.queue.set_result(
                    rid, error_payload(code, e, uri=rec.get("uri")))
                continue
            groups.setdefault((model, x.shape, str(x.dtype)), []).append(
                (rid, x, rec.get("fmt") == "tensor", rec))
        served = 0
        for (model, _shape, _dt), entries in groups.items():
            x = np.stack([e[1] for e in entries], axis=0)
            try:
                out = self.models[model].predict(x)
            except Exception as e:
                # records are already destructively popped from the queue —
                # answer every one with the error rather than losing them
                for rid, _, _, rec in entries:
                    obs.count("serving_errors_total", code="model_error",
                              model=model, flat="serving/errors_returned")
                    sp = rec.pop("_span", None)
                    if sp is not None:
                        sp.end(status="model_error", error=str(e))
                    self.queue.set_result(rid, error_payload(
                        "model_error", e, uri=rec.get("uri")))
                continue
            outs = out[0] if isinstance(out, list) else out
            for i, (rid, _, native, _rec) in enumerate(entries):
                self.queue.set_result(
                    rid, self._format_row(np.asarray(outs[i]), native))
                sp = _rec.pop("_span", None)
                if sp is not None:
                    sp.end()
            obs.count("serving_records_total", len(entries),
                      model=model, outcome="ok")
            served += len(entries)
        # serve_once can run concurrently with a started pipeline's
        # respond pool, which bumps this counter under _count_lock —
        # an unlocked += here would lose increments (THR-GUARD)
        dt = time.perf_counter() - t0
        with self._count_lock:
            self.records_served += served
            total = self.records_served
        if self._tb is not None and served:
            self._tb.add_scalar("serving_throughput", served / dt, total)
            self._tb.add_scalar("total_records", total, total)
        return served
