"""ShmQueue: the zero-copy serving transport over a
``multiprocessing.shared_memory`` ring buffer.

The Memory/File/Redis backends all pay the string-codec tax: tensors
cross as base64 inside JSON, and the worker re-materializes every
payload at least twice.  ShmQueue moves raw bytes instead — records are
packed by :mod:`analytics_zoo_tpu_torch.deploy.codec` straight into a
fixed-size slot arena inside one shared-memory segment, and
``pop_batch`` hands back ``np.frombuffer`` *views* into the slot, which
the serving bucket copies once into its pinned staging buffer on the way
to the card (no codec copy).

Segment layout (one ``SharedMemory``, sized at construction)::

    geometry header (magic, slot counts and sizes, push-lock path)
    | gseq u64 | slot state[u8 * slots]
    | slot seq[u64 * slots] | slot len[u32 * slots] | slot rid[96 * slots]
    | slot owner-pid[u32 * slots]
    | result state[u8] / len[u32] / rid[96] / owner-pid[u32] arrays
    | 4096-aligned request arena  (slots x slot_bytes)
    | 4096-aligned result arena   (result_slots x result_slot_bytes)

Slot protocol (lock-light by construction): the queue condition is held
only to *claim* a slot — scan the state flags, flip ``FREE → WRITING``
(push) or ``READY → READING`` (pop), bump the shared ``gseq`` cursor.
The payload memcpy happens outside the lock (the claimed state makes
the slot single-owner), and publishing is one byte store
(``WRITING → READY``) followed by a notify.  FIFO order rides the
``gseq`` stamps: pop sorts its claims by sequence number, so
single-producer order is exact and multi-producer order is
claim-order (the same guarantee the Redis stream gives concurrent
``xadd`` callers).

Slot lifetime is reference-counted, not copied: each popped record
leases its slot through a ctypes window over the shm buffer, and a
``weakref.finalize`` on that window returns the slot to ``FREE`` when
the last tensor view dies (after the copy into the staging buffer,
typically).
The release path is deliberately **lock-free** — finalizers can fire
during GC at any point, including while the releasing thread already
holds the queue lock, so they only append to a ``deque``; push/pop
drain it under the condition, and blocked pushers poll on a short wait
timeout.  ``serving/shm_backpressure_waits`` counts pushers that found
the arena full (slot exhaustion == backpressure, bounded by
``push_timeout_s``).

Cross-process leases: every ``push`` stamps the caller's pid into a
shared per-slot owner array; ``pop_batch`` carries it to the result
slot when the worker publishes.  A READY result slot whose owner pid no
longer exists will never be consumed (the waiter died between push and
``get_result``) — ``reclaim_dead_result_leases`` frees those slots and
counts ``serving_shm_lease_reclaims_total``; the serving supervisor
runs it every tick so a SIGKILL-ed client cannot strand result
capacity.

Lifecycle: the segment is ``unlink``-ed the moment ``stop()`` runs
(POSIX keeps live mappings valid after unlink, so in-flight leases
finish safely), outstanding leases defer only the ``close()``, and an
``atexit`` registry warns about — and unlinks — any queue whose owner
never called ``stop()``, so a crashed test run cannot strand segments
in ``/dev/shm``.

Processes: the worker that makes the queue owns the segment;
clients in other processes open it by name with
:meth:`ShmQueue.attach` (``queue.segment``) and push records and read
results as the owner does.  Claims of a free request slot take an
``flock`` on a lock file named in the segment's header, so pushers in
several processes never claim one slot twice; the other transitions
each have one writer (the popping worker, or the one client whose
result it is).  A condition variable wakes waiters of the same process
only, so waits poll the shared state every ``POLL_S`` seconds for work
another process published.  One worker process pops a segment.
"""

from __future__ import annotations

import atexit
import contextlib
import ctypes
import fcntl
import logging
import os
import struct
import tempfile
import threading
import time
import uuid
import weakref
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from analytics_zoo_tpu_torch.core.profiling import TIMERS
from analytics_zoo_tpu_torch.deploy import codec
from analytics_zoo_tpu_torch.observe import metrics as obs
from analytics_zoo_tpu_torch.robust.errors import (MalformedRecordError,
                                             ServingOverloaded)

__all__ = ["ShmQueue", "live_segments", "shm_available"]

_log = logging.getLogger("analytics_zoo_tpu_torch.deploy")

FREE, WRITING, READY, READING = 0, 1, 2, 3
_RID_CAP = 94            # rid bytes per slot (2-byte length prefix)
_ARENA_ALIGN = 4096
# geometry header: magic, slots, slot_bytes, result_slots,
# result_slot_bytes, then the push-lock path (u16 length + utf-8)
_GEOM = struct.Struct("<4sQQQQ")
_GEOM_MAGIC = b"AZSQ"
_HEADER_BYTES = 512

# segment name -> queue, for leak warnings at interpreter exit
_LIVE: Dict[str, "ShmQueue"] = {}


def shm_available() -> bool:
    """True when POSIX shared memory actually works here (containers
    can mount /dev/shm noexec/ro or not at all)."""
    try:
        from multiprocessing import shared_memory

        seg = shared_memory.SharedMemory(create=True, size=64)
        seg.buf[0] = 1
        seg.close()
        seg.unlink()
        return True
    except Exception:
        return False


def live_segments() -> List[str]:
    """Names of segments created and not yet stopped (leak probe)."""
    return sorted(_LIVE)


@atexit.register
def _warn_leaked_segments() -> None:
    for seg, q in list(_LIVE.items()):
        _log.warning("ShmQueue segment %s leaked (stop() was never "
                     "called); unlinking at exit", seg)
        try:
            q.stop(timeout=0.5)
        except Exception:
            pass


def _align(n: int, a: int) -> int:
    return (n + a - 1) & ~(a - 1)


def _pid_alive(pid: int) -> bool:
    """Signal-0 probe; EPERM means the pid exists under another uid."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:        # PermissionError included: process exists
        return True
    return True


class ShmQueue:
    """Shared-memory ring-buffer stream + result store (see module
    docstring for the slot protocol and lifecycle contract)."""

    wire = "binary"

    # how often a wait rescans the shared state (work published by
    # another process sends no notify)
    POLL_S = 0.001

    def __init__(self, name: str = "serving_stream", slots: int = 256,
                 slot_bytes: int = 1 << 20,
                 result_slots: Optional[int] = None,
                 result_slot_bytes: Optional[int] = None,
                 push_timeout_s: float = 5.0):
        from multiprocessing import shared_memory

        self.name = name
        self.slots = max(2, int(slots))
        self.slot_bytes = int(slot_bytes)
        self.result_slots = int(result_slots or self.slots)
        self.result_slot_bytes = int(result_slot_bytes or self.slot_bytes)
        self.push_timeout_s = float(push_timeout_s)
        self.segment = f"azs-{name[:32]}-{uuid.uuid4().hex[:8]}"
        self._owner_proc = True
        self._lock_path = os.path.join(tempfile.gettempdir(),
                                       self.segment + ".lock")
        open(self._lock_path, "a").close()
        total = self._layout()
        self._shm = shared_memory.SharedMemory(create=True, size=total,
                                               name=self.segment)
        lp = self._lock_path.encode("utf-8")
        if _GEOM.size + 2 + len(lp) > _HEADER_BYTES:
            raise ValueError(f"lock path too long: {self._lock_path}")
        hdr = (_GEOM.pack(_GEOM_MAGIC, self.slots, self.slot_bytes,
                          self.result_slots, self.result_slot_bytes)
               + struct.pack("<H", len(lp)) + lp)
        self._shm.buf[:len(hdr)] = hdr
        self._views()
        self._gseq[0] = 0
        self._st[:] = FREE
        self._rst[:] = FREE
        self._pid[:] = 0
        self._rpid[:] = 0
        self._local_state(push_timeout_s)
        _LIVE[self.segment] = self

    @classmethod
    def attach(cls, segment: str, push_timeout_s: float = 5.0
               ) -> "ShmQueue":
        """Open the queue another process made, by its ``segment`` name,
        to push records and read results.  ``stop()`` on an attached
        queue closes this process's mapping and leaves the segment to
        its owner."""
        from multiprocessing import resource_tracker, shared_memory

        q = cls.__new__(cls)
        q._shm = shared_memory.SharedMemory(name=segment)
        # this process does not own the segment: keep the resource
        # tracker from unlinking it when this process exits
        resource_tracker.unregister(q._shm._name, "shared_memory")
        magic, slots, slot_bytes, rslots, rbytes = _GEOM.unpack_from(
            q._shm.buf, 0)
        if magic != _GEOM_MAGIC:
            q._shm.close()
            raise ValueError(f"{segment} is not a ShmQueue segment")
        (n,) = struct.unpack_from("<H", q._shm.buf, _GEOM.size)
        q._lock_path = bytes(
            q._shm.buf[_GEOM.size + 2:_GEOM.size + 2 + n]).decode("utf-8")
        q.name = segment.split("-", 1)[1].rsplit("-", 1)[0]
        q.segment = segment
        q.slots, q.slot_bytes = int(slots), int(slot_bytes)
        q.result_slots, q.result_slot_bytes = int(rslots), int(rbytes)
        q._owner_proc = False
        q._layout()
        q._views()
        q._local_state(push_timeout_s)
        return q

    def _layout(self) -> int:
        """Offsets of every array in the segment; returns its size."""
        off = _HEADER_BYTES
        self._gseq_off = off
        off += 8
        self._state_off = off
        off += self.slots
        off = _align(off, 8)
        self._seq_off = off
        off += 8 * self.slots
        self._len_off = off
        off += 4 * self.slots
        self._rid_off = off
        off += (2 + _RID_CAP) * self.slots
        off = _align(off, 4)
        self._pid_off = off
        off += 4 * self.slots
        self._rstate_off = off
        off += self.result_slots
        off = _align(off, 4)
        self._rlen_off = off
        off += 4 * self.result_slots
        self._rrid_off = off
        off += (2 + _RID_CAP) * self.result_slots
        off = _align(off, 4)
        self._rpid_off = off
        off += 4 * self.result_slots
        self._arena_off = _align(off, _ARENA_ALIGN)
        self._rarena_off = _align(
            self._arena_off + self.slots * self.slot_bytes, _ARENA_ALIGN)
        return self._rarena_off + self.result_slots * self.result_slot_bytes

    def _views(self) -> None:
        buf = self._shm.buf
        self._gseq = np.frombuffer(buf, np.uint64, 1, self._gseq_off)
        self._st = np.frombuffer(buf, np.uint8, self.slots, self._state_off)
        self._seq = np.frombuffer(buf, np.uint64, self.slots, self._seq_off)
        self._ln = np.frombuffer(buf, np.uint32, self.slots, self._len_off)
        self._rid = np.frombuffer(buf, np.uint8,
                                  (2 + _RID_CAP) * self.slots,
                                  self._rid_off).reshape(self.slots, -1)
        self._pid = np.frombuffer(buf, np.uint32, self.slots,
                                  self._pid_off)
        self._rst = np.frombuffer(buf, np.uint8, self.result_slots,
                                  self._rstate_off)
        self._rln = np.frombuffer(buf, np.uint32, self.result_slots,
                                  self._rlen_off)
        self._rrid = np.frombuffer(
            buf, np.uint8, (2 + _RID_CAP) * self.result_slots,
            self._rrid_off).reshape(self.result_slots, -1)
        self._rpid = np.frombuffer(buf, np.uint32, self.result_slots,
                                   self._rpid_off)

    def _local_state(self, push_timeout_s: float) -> None:
        self.push_timeout_s = float(push_timeout_s)
        self._cond = threading.Condition()    # request-slot claims
        self._rcond = threading.Condition()   # result-slot claims
        # slots whose last lease died; appended lock-free by finalizers,
        # drained under _cond (see module docstring: GC-reentrancy)
        self._freed: "deque[int]" = deque()
        # rid -> pusher pid, carried from the request slot at pop_batch
        # so set_result_many can stamp the result-slot owner.  Worker-
        # process local (only the popping side consults it).
        self._owner: Dict[str, int] = {}
        self.lease_reclaims = 0
        self._closed = False

    @contextlib.contextmanager
    def _push_lock(self):
        """The cross-process lock of a request-slot claim (an ``flock``,
        held by one pusher of any process at a time)."""
        fd = os.open(self._lock_path, os.O_RDWR | os.O_CREAT, 0o600)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            os.close(fd)

    # -- slot bookkeeping ---------------------------------------------------

    def _slot_off(self, idx: int) -> int:
        return self._arena_off + idx * self.slot_bytes

    def _rslot_off(self, idx: int) -> int:
        return self._rarena_off + idx * self.result_slot_bytes

    @staticmethod
    def _put_rid(arr: np.ndarray, idx: int, rid: str) -> None:
        b = rid.encode("utf-8")[:_RID_CAP]
        arr[idx, 0] = len(b) & 0xFF
        arr[idx, 1] = len(b) >> 8
        arr[idx, 2:2 + len(b)] = np.frombuffer(b, np.uint8)

    @staticmethod
    def _get_rid(arr: np.ndarray, idx: int) -> str:
        n = int(arr[idx, 0]) | (int(arr[idx, 1]) << 8)
        return bytes(arr[idx, 2:2 + n]).decode("utf-8")

    def _drain_freed_locked(self) -> None:
        while True:
            try:
                idx = self._freed.popleft()
            except IndexError:
                return
            self._st[idx] = FREE

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError(f"ShmQueue[{self.name}] is stopped")

    # -- stream: request direction -----------------------------------------

    def push(self, record: Dict) -> str:
        self._check_open()
        rid = record.get("uri") or uuid.uuid4().hex
        prepared = codec.prepare_record(record)
        need = prepared[2]
        if need > self.slot_bytes:
            raise MalformedRecordError(
                f"record packs to {need} bytes > slot_bytes="
                f"{self.slot_bytes}; raise serving_shm_slot_bytes or "
                "shrink the payload")
        deadline = time.monotonic() + self.push_timeout_s
        with self._cond:
            while True:
                self._drain_freed_locked()
                idx = None
                with self._push_lock():
                    free = np.flatnonzero(self._st == FREE)
                    if free.size:
                        idx = int(free[0])
                        self._st[idx] = WRITING
                        self._gseq[0] += 1
                        seq = int(self._gseq[0])
                if idx is not None:
                    break
                if time.monotonic() >= deadline:
                    raise ServingOverloaded(
                        f"ShmQueue[{self.name}]: all {self.slots} slots "
                        f"busy for {self.push_timeout_s:.1f}s "
                        "(slot-exhaustion backpressure)")
                TIMERS.incr("serving/shm_backpressure_waits")
                # short timeout: finalizer-freed slots (and slots freed by
                # another process) arrive without a notify
                self._cond.wait(0.005)
        n = codec.pack_record_into(record, self._shm.buf,
                                   self._slot_off(idx), codec="shm",
                                   prepared=prepared)
        self._ln[idx] = n
        self._seq[idx] = seq
        self._put_rid(self._rid, idx, rid)
        self._pid[idx] = os.getpid()
        self._st[idx] = READY       # publish: single byte store
        with self._cond:
            self._cond.notify_all()
        return rid

    def pop_batch(self, n: int, timeout: float = 0.1
                  ) -> List[Tuple[str, Dict]]:
        self._check_open()
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                self._drain_freed_locked()
                ready = np.flatnonzero(self._st == READY)
                if ready.size:
                    take = ready[np.argsort(self._seq[ready],
                                            kind="stable")][:n]
                    self._st[take] = READING
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    return []
                self._cond.wait(min(left, self.POLL_S))
        out: List[Tuple[str, Dict]] = []
        for idx in (int(i) for i in take):
            ln = int(self._ln[idx])
            # the lease: a ctypes window over the slot.  Tensor views
            # produced by unpack_record keep it alive through their
            # .base chain; when the last one dies the finalizer returns
            # the slot — append only, no locks (GC-safe).
            lease = (ctypes.c_char * ln).from_buffer(
                self._shm.buf, self._slot_off(idx))
            weakref.finalize(lease, self._freed.append, idx)
            rec = codec.unpack_record(lease, codec="shm")
            rid = self._get_rid(self._rid, idx)
            self._owner[rid] = int(self._pid[idx])
            out.append((rid, rec))
            del lease  # the record's tensor views now own the slot
        return out

    def __len__(self) -> int:
        if self._closed:
            return 0
        with self._cond:
            return int((self._st == READY).sum())

    def trim(self, maxlen: int) -> int:
        """Drop oldest undelivered records beyond maxlen (XTRIM-style
        backpressure, same contract as the other backends)."""
        self._check_open()
        with self._cond:
            self._drain_freed_locked()
            ready = np.flatnonzero(self._st == READY)
            drop = max(0, int(ready.size) - int(maxlen))
            if drop:
                oldest = ready[np.argsort(self._seq[ready],
                                          kind="stable")][:drop]
                self._st[oldest] = FREE
                self._cond.notify_all()
            return drop

    # -- result direction ---------------------------------------------------

    def set_result(self, rid: str, value: Any) -> None:
        self.set_result_many([(rid, value)])

    def set_result_many(self, pairs: List[Tuple[str, Any]]) -> None:
        """Batched result writes: the respond pool drains its queue and
        publishes every ready result under ONE claim round."""
        self._check_open()
        blobs = []
        for rid, value in pairs:
            data = codec.pack_result(value, codec="shm")
            if len(data) > self.result_slot_bytes:
                from analytics_zoo_tpu_torch.deploy.serving import error_payload

                data = codec.pack_result(error_payload(
                    "internal",
                    f"result of {len(data)} bytes exceeds "
                    f"result_slot_bytes={self.result_slot_bytes}",
                    uri=rid), codec="shm")
            blobs.append((rid, data))
        deadline = time.monotonic() + self.push_timeout_s
        with self._rcond:
            for rid, data in blobs:
                while True:
                    free = np.flatnonzero(self._rst == FREE)
                    if free.size:
                        idx = int(free[0])
                        break
                    if time.monotonic() >= deadline:
                        raise ServingOverloaded(
                            f"ShmQueue[{self.name}]: all "
                            f"{self.result_slots} result slots busy "
                            "(results not being consumed?)")
                    self._rcond.wait(0.005)
                off = self._rslot_off(idx)
                self._shm.buf[off:off + len(data)] = data
                self._rln[idx] = len(data)
                self._put_rid(self._rrid, idx, rid)
                self._rpid[idx] = self._owner.pop(rid, 0)
                self._rst[idx] = READY
            self._rcond.notify_all()

    def get_result(self, rid: str, timeout: float = 10.0) -> Any:
        self._check_open()
        deadline = time.monotonic() + timeout
        with self._rcond:
            while True:
                for idx in np.flatnonzero(self._rst == READY):
                    idx = int(idx)
                    if self._get_rid(self._rrid, idx) == rid:
                        off = self._rslot_off(idx)
                        ln = int(self._rln[idx])
                        data = bytes(self._shm.buf[off:off + ln])
                        self._rst[idx] = FREE
                        self._rcond.notify_all()
                        return codec.unpack_result(data, copy=False,
                                                   codec="shm")
                left = deadline - time.monotonic()
                if left <= 0:
                    from analytics_zoo_tpu_torch.deploy.serving import _timeout_msg

                    raise TimeoutError(_timeout_msg(self, rid, timeout))
                self._rcond.wait(min(left, self.POLL_S))

    def reclaim_dead_result_leases(self) -> int:
        """Free READY result slots whose owner process is gone.

        A result slot stays READY until the pusher that owns the rid
        calls :meth:`get_result`; if that process was SIGKILL-ed the
        slot would otherwise leak until the segment dies.  The serving
        supervisor runs this every tick — each reclaim counts
        ``serving_shm_lease_reclaims_total``.  Slots with no stamped
        owner (pid 0: results published for rids this worker never
        popped, e.g. decode-stage error payloads) are left alone.
        """
        if self._closed:
            return 0
        freed = 0
        with self._rcond:
            for idx in np.flatnonzero(self._rst == READY):
                idx = int(idx)
                pid = int(self._rpid[idx])
                if pid > 0 and not _pid_alive(pid):
                    self._rst[idx] = FREE
                    self._rpid[idx] = 0
                    freed += 1
            if freed:
                self._rcond.notify_all()
        # prune owner stamps whose waiter died before the result was
        # ever published (the respond pool would stamp a dead pid and
        # the next tick frees it; dropping the map entry here keeps the
        # worker-local map bounded)
        for rid, pid in list(self._owner.items()):
            if pid > 0 and not _pid_alive(pid):
                self._owner.pop(rid, None)
        if freed:
            self.lease_reclaims += freed
            obs.count("serving_shm_lease_reclaims_total", freed,
                      flat="serving/shm_lease_reclaims")
            _log.warning("ShmQueue[%s]: reclaimed %d result lease(s) "
                         "whose owner process died", self.name, freed)
        return freed

    def pending_results(self) -> List[str]:
        if self._closed:
            return []
        with self._rcond:
            return [self._get_rid(self._rrid, int(i))
                    for i in np.flatnonzero(self._rst == READY)]

    # -- health / lifecycle -------------------------------------------------

    def leased_slots(self) -> int:
        """Records popped whose tensor views are still alive (test and
        leak-probe surface)."""
        if self._closed:
            return 0
        with self._cond:
            self._drain_freed_locked()
            return int((self._st == READING).sum())

    def health(self) -> Dict[str, Any]:
        if self._closed:
            return {"ok": False, "backend": "shm", "closed": True,
                    "segment": self.segment}
        with self._cond:
            self._drain_freed_locked()
            return {"ok": True, "backend": "shm",
                    "segment": self.segment,
                    "depth": int((self._st == READY).sum()),
                    "slots_free": int((self._st == FREE).sum()),
                    "slots_leased": int((self._st == READING).sum()),
                    "pending_results": int((self._rst == READY).sum())}

    def _await_leases(self, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._cond:
                self._drain_freed_locked()
                leased = int((self._st == READING).sum())
            if not leased:
                return
            time.sleep(0.01)
        _log.warning(
            "ShmQueue[%s]: %d leased record view(s) still alive "
            "after %.1fs at stop — mapping close deferred until "
            "they are garbage-collected (segment already unlinked)",
            self.name, leased, timeout)

    def stop(self, timeout: float = 2.0) -> None:
        """Unlink the segment (immediately — live leases keep their
        mappings valid), wait briefly for outstanding leases, drop our
        views, close the mapping.  Idempotent; leak-warns instead of
        hanging when a consumer still holds record views.  An attached
        queue only closes its own mapping."""
        if self._closed:
            return
        self._closed = True
        _LIVE.pop(self.segment, None)
        if self._owner_proc:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass
            with contextlib.suppress(OSError):
                os.unlink(self._lock_path)
        if self._owner_proc:
            self._await_leases(timeout)
        # our metadata views are buffer exports too; drop them so
        # close() can release the mapping
        self._gseq = self._st = self._seq = self._ln = self._rid = None
        self._rst = self._rln = self._rrid = None
        self._pid = self._rpid = None
        try:
            self._shm.close()
        except BufferError:
            # outstanding leases still export the buffer.  __del__ would
            # retry close() and raise the same BufferError unraisably at
            # GC time, so neuter it: the segment is already unlinked and
            # the mapping is reclaimed when the process (or the last
            # view) dies — nothing leaks in /dev/shm either way.
            self._shm.close = lambda: None
