"""Input-pipeline overlap: background-thread batch prefetch, and the
host-to-device staging of host batches.

``PrefetchIterator`` is the JAX package's ``train/prefetch.py``: a
daemon thread runs the source iterator (and a per-item transform)
``depth`` items ahead of the consumer; a producer exception is re-raised
at the consumption point, so the Estimator's failure retry sees it; and
``close()`` is idempotent, drains the queue, joins with a timeout and
warns about a producer wedged in its source.  The consumer's wait
aggregates under ``prefetch/consumer_wait``: a large total against the
step time means the input pipeline, not the device, is the bottleneck.

``HostStager`` is the transform the Estimator's host path runs on that
thread.  It gathers a batch's rows from the host arrays straight into
pinned buffers and, on the card, copies them with ``non_blocking=True``
on a side stream, recording an event; the consumer makes its compute
stream wait on the event (``ready``) before the step reads the batch.  A
pinned buffer is reused only after its copy's event has completed, and
each device tensor is marked used on the compute stream, so the caching
allocator does not hand its memory out while the step still reads it.
On the CPU the gather is the batch.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator, List, Optional

import numpy as np
import torch

from analytics_zoo_tpu_torch.core.profiling import TIMERS
from analytics_zoo_tpu_torch.observe import metrics as obs
from analytics_zoo_tpu_torch.robust import faults

logger = logging.getLogger("analytics_zoo_tpu_torch.train")

_SENTINEL = object()


class PrefetchIterator:
    """Wraps an iterator, running it (plus an optional per-item transform)
    on a daemon thread ``depth`` items ahead of the consumer."""

    def __init__(self, it: Iterable, transform: Optional[Callable] = None,
                 depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._err_lock = threading.Lock()
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._closed = False
        self._close_lock = threading.Lock()

        def put_retry(obj) -> bool:
            """Deliver unless the consumer called close(); never drop."""
            stalled = False
            while not self._stop.is_set():
                try:
                    self._q.put(obj, timeout=0.1)
                    obs.set_gauge("prefetch_queue_depth", self._q.qsize())
                    return True
                except queue.Full:
                    if not stalled:
                        # once per item: the producer outran the consumer
                        # by a full queue
                        stalled = True
                        obs.count("prefetch_producer_stalls_total",
                                  flat="prefetch/producer_stalls")
            return False

        def run():
            try:
                for item in it:
                    faults.inject("prefetch.producer")
                    if transform is not None:
                        item = transform(item)
                    if not put_retry(item):
                        return
            except BaseException as e:  # propagate to consumer
                with self._err_lock:
                    self._err = e
            finally:
                # the sentinel is never dropped: a consumer that drains
                # the queue would otherwise block on get() for ever;
                # consumers close() on early exit so this ends
                put_retry(_SENTINEL)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        t0 = time.perf_counter()
        item = self._get()
        TIMERS.observe("prefetch/consumer_wait", time.perf_counter() - t0)
        if item is _SENTINEL:
            self._thread.join()
            err = self._error()
            if err is not None:
                raise err
            raise StopIteration
        return item

    def _error(self) -> Optional[BaseException]:
        with self._err_lock:
            return self._err

    def _get(self) -> Any:
        while True:
            try:
                return self._q.get(timeout=1.0)
            except queue.Empty:
                if not self._thread.is_alive():
                    try:
                        return self._q.get_nowait()
                    except queue.Empty:
                        err = self._error()
                        if err is not None:
                            raise err
                        raise StopIteration from None

    def close(self, timeout: float = 5.0) -> None:
        """Stop the producer (early exit, exception paths).  Idempotent.
        Drains the queue so a producer blocked in ``put_retry`` sees the
        stop flag, then joins it within ``timeout``: a producer wedged in
        the source iterator or transform (which Python cannot interrupt)
        is logged and abandoned; being a daemon it cannot block exit."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        self._stop.set()
        deadline = None
        while self._thread.is_alive():
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
            if not self._thread.is_alive():
                break
            if deadline is None:
                deadline = time.monotonic() + timeout
            elif time.monotonic() > deadline:
                logger.warning(
                    "prefetch producer did not stop within %.1fs of "
                    "close(); it is wedged in the source iterator or "
                    "transform and will be abandoned (daemon thread)",
                    timeout)
                break


def prefetch(it: Iterable, transform: Optional[Callable] = None,
             depth: int = 2) -> Iterable:
    """``depth <= 0`` disables prefetching (synchronous passthrough)."""
    if depth <= 0:
        if transform is None:
            return it
        return (transform(x) for x in it)
    return PrefetchIterator(it, transform=transform, depth=depth)


class HostStager:
    """Host rows to device tensors through ``slots`` pinned buffers per
    array (see the module docstring).  ``stage`` runs on one producer
    thread; ``ready`` on the consumer, before the batch is used."""

    def __init__(self, device: torch.device, slots: int = 4):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._slots: List[Optional[dict]] = [None] * max(2, slots)
        self._next = 0
        if self.cuda:
            self.compute = torch.cuda.current_stream(self.device)
            self.stream = torch.cuda.Stream(self.device)

    def _slot(self, arrays, n) -> dict:
        """The next slot's pinned buffers, once the copy that last read
        them has completed; grown when ``n`` rows do not fit."""
        i = self._next
        self._next = (i + 1) % len(self._slots)
        slot = self._slots[i]
        if slot is not None:
            slot["event"].synchronize()
        if slot is None or any(
                b.shape[0] < n or b.shape[1:] != a.shape[1:]
                or b.numpy().dtype != a.dtype
                for b, a in zip(slot["bufs"], arrays)):
            slot = {"bufs": [torch.from_numpy(np.empty(
                (n,) + a.shape[1:], a.dtype)).pin_memory() for a in arrays],
                "event": torch.cuda.Event()}
            self._slots[i] = slot
        return slot

    def stage(self, arrays: List[np.ndarray], rows: np.ndarray,
              nan: bool = False):
        """``arrays[j][rows]`` for every array, as device tensors, and the
        event the consumer waits on (None on the CPU).  ``nan`` fills the
        float arrays with NaN (the ``estimator.step`` fault's batch)."""
        n = len(rows)
        if not self.cuda:
            out = [np.take(a, rows, axis=0) for a in arrays]
            if nan:
                out = faults.poison_nan(out)
            return [torch.from_numpy(a) for a in out], None
        slot = self._slot(arrays, n)
        host = [b[:n] for b in slot["bufs"]]
        for a, h in zip(arrays, host):
            view = h.numpy()
            np.take(a, rows, axis=0, out=view)
            if nan and np.issubdtype(view.dtype, np.floating):
                view.fill(np.nan)
        with torch.cuda.stream(self.stream):
            dev = [h.to(self.device, non_blocking=True) for h in host]
            slot["event"].record(self.stream)
        for t in dev:
            t.record_stream(self.compute)
        return dev, slot["event"]

    def ready(self, event) -> None:
        """Order the compute stream after a staged batch's copy."""
        if event is not None:
            self.compute.wait_event(event)
