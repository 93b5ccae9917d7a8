"""STREAM cache tier — shard rotation through device slots.

The JAX package's ``data/streaming.py`` on one process, in PyTorch.  A
dataset larger than ``ZooConfig.data_device_budget_bytes`` is cut into
budget-sized shards of one static shape (``plan_stream``), and an
uploader thread keeps ``ZooConfig.data_stream_slots`` (default 2) of
them on the device: it copies shard N+1 while the Estimator's shard
program trains on shard N.

- **Slots.**  Every slot is a fixed set of device tensors (the arrays,
  their quantization scalars, the in-shard permutation) with a pinned
  host buffer of the same bytes beside it (``StreamSlots``), allocated
  once per plan.  A CUDA graph replays the addresses it captured, so the
  Estimator captures one shard program per slot and replays it for every
  shard that lands there, in every epoch.
- **Upload.**  ``read_rows``, then the FeatureSet's transforms, then the
  optional uint8 / int8 encode of float features
  (``ops/quantization.quantize_feature_array``), into the slot's pinned
  buffer, then one copy on a side stream into the slot, ending with an
  event the consumer's stream waits on.  The uploader thread only
  copies: it makes no graph and runs no library call, so it needs none
  of the per-thread library handles a capture does.
- **Leases.**  ``ShardUploader.get()`` hands the consumer a
  ``ShardLease``; ``lease.release(after=event)`` returns the slot with
  an event recorded after the shard program's last launch, and the
  uploader waits on that event, on its own thread, before it overwrites
  the slot.  The training loop never synchronises.
- **Shuffle.**  Two levels, both pure functions of ``(seed, epoch[,
  shard])`` as in the JAX package (``epoch_shard_order``,
  ``shard_permutation``): the shard order per epoch, and the rows within
  a shard, whose permutation travels with the shard and is applied by
  the gathers on the device.  A resumed shard cursor replays both.
- **Faults.**  ``data.shard_upload`` (an uploader crash) and
  ``data.shard_torn`` (a short read caught by the shape check) surface at
  ``get()`` as ``StreamUploadError``; the Estimator finishes the epoch's
  remaining shards from host batches and counts the fallback.

The JAX package's multi-controller parts (``ProcessRowView``, the
per-shard barriers, ``data.host_lost`` and ``data.shard_skew``) belong to
the multi-GPU slice (ROADMAP A9).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.data.featureset import _apply
from analytics_zoo_tpu_torch.observe import metrics as obs
from analytics_zoo_tpu_torch.robust import faults

logger = logging.getLogger("analytics_zoo_tpu_torch.data")

_SENTINEL = object()


def epoch_shard_order(n_shards: int, seed: int, epoch: int,
                      shuffle: bool = True) -> np.ndarray:
    """Shard visit order for ``epoch``, level 1 of the shuffle: a pure
    function of ``(seed, epoch)``, so a resume re-derives it from the
    epoch number alone."""
    if not shuffle or n_shards == 1:
        return np.arange(n_shards)
    rs = np.random.RandomState(
        (int(seed) + 7919 * (int(epoch) + 1)) % (2 ** 31 - 1))
    return rs.permutation(n_shards)


def shard_permutation(n_rows: int, seed: int, epoch: int, shard_id: int,
                      *, shuffle: bool = True,
                      pair_structured: bool = False) -> np.ndarray:
    """Level 2: the in-shard row permutation, a pure function of ``(seed,
    epoch, shard_id)``.  ``pair_structured`` moves (even, odd) row pairs
    together, as the resident path's pair shuffle does."""
    if not shuffle:
        return np.arange(n_rows, dtype=np.int32)
    rs = np.random.RandomState(
        (int(seed) + 7919 * (int(epoch) + 1)
         + 104729 * (int(shard_id) + 1)) % (2 ** 31 - 1))
    if pair_structured:
        pairs = rs.permutation(n_rows // 2)
        idx = np.stack([pairs * 2, pairs * 2 + 1], axis=1).reshape(-1)
        if n_rows % 2:
            idx = np.concatenate([idx, np.array([n_rows - 1])])
        return idx.astype(np.int32)
    return rs.permutation(n_rows).astype(np.int32)


class StreamUploadError(RuntimeError):
    """A shard failed to stage or upload (uploader crash, torn shard).
    The Estimator catches it mid-rotation and finishes the epoch's
    remaining shards from host batches: the epoch is never lost."""


class StreamPlan:
    """Shard geometry for one STREAM fit: how many shards, how many rows
    each, and which arrays travel quantized.  Every shard has one static
    shape (``shard_rows`` rows, a multiple of the batch), so one shard
    program per slot serves every shard of every epoch; the rows beyond
    ``n_shards * shard_rows`` are dropped each epoch (less than one
    batch per shard)."""

    def __init__(self, *, n_rows: int, n_shards: int, shard_rows: int,
                 steps_per_shard: int, eff_batch: int, slots: int,
                 cache_dtype: Optional[str],
                 specs: List[Tuple[Tuple[int, ...], np.dtype]],
                 quantized: Tuple[bool, ...]):
        self.n_rows = n_rows
        self.n_shards = n_shards
        self.shard_rows = shard_rows
        self.steps_per_shard = steps_per_shard
        self.eff_batch = eff_batch
        self.slots = slots
        self.cache_dtype = cache_dtype
        self.specs = specs              # post-transform (row shape, dtype)
        self.quantized = quantized      # per array: encoded for upload?
        self.dropped_rows = n_rows - n_shards * shard_rows
        self.device_shard_bytes = shard_rows * self._device_row_bytes()
        # quantized bytes each shard dispatch decodes (gathered rows)
        self.decode_bytes_per_shard = steps_per_shard * eff_batch * sum(
            int(np.prod(shape, dtype=np.int64))
            for (shape, _), q in zip(specs, quantized) if q)

    def _device_row_bytes(self) -> int:
        total = 0
        for (shape, dtype), q in zip(self.specs, self.quantized):
            elems = int(np.prod(shape, dtype=np.int64))
            total += elems * (1 if q else dtype.itemsize)
        return total

    @property
    def key(self) -> tuple:
        """What a shard program depends on: the geometry and the dtypes."""
        return (self.shard_rows, self.eff_batch, self.steps_per_shard,
                self.cache_dtype, self.quantized,
                tuple((s, str(d)) for s, d in self.specs))

    def epoch_order(self, seed: int, epoch: int,
                    shuffle: bool) -> np.ndarray:
        return epoch_shard_order(self.n_shards, seed, epoch, shuffle)

    def shard_perm(self, seed: int, epoch: int, shard_id: int, *,
                   shuffle: bool = True,
                   pair_structured: bool = False) -> np.ndarray:
        return shard_permutation(self.shard_rows, seed, epoch, shard_id,
                                 shuffle=shuffle,
                                 pair_structured=pair_structured)

    def load_shard(self, fs, shard_id: int) -> List[np.ndarray]:
        """Shard ``shard_id``'s rows on the host: a row-span read plus the
        FeatureSet's transforms, applied once per shard (row-independent,
        as the per-batch protocol implies)."""
        start = shard_id * self.shard_rows
        arrays = fs.read_rows(start, start + self.shard_rows)
        if fs.transforms:
            arrays = list(_apply(fs.transforms,
                                 tuple(np.asarray(a) for a in arrays)))
        return arrays

    def validate_shard(self, arrays: Sequence[np.ndarray],
                       shard_id: int) -> None:
        """A staged shard must match the plan's static shape exactly, or
        it was torn."""
        for j, (a, (shape, dtype)) in enumerate(zip(arrays, self.specs)):
            want = (self.shard_rows,) + tuple(shape)
            if tuple(a.shape) != want or a.dtype != dtype:
                raise StreamUploadError(
                    f"torn shard {shard_id}: array {j} is "
                    f"{a.shape}/{a.dtype}, expected {want}/{dtype}")

    def probe_inputs(self, fs) -> List[np.ndarray]:
        """Two post-transform feature rows for the model's build."""
        arrays = fs.read_rows(0, min(len(fs), 2))
        if fs.transforms:
            arrays = list(_apply(fs.transforms,
                                 tuple(np.asarray(a) for a in arrays)))
        return [np.asarray(a) for a in arrays[:-1]]


def plan_stream(fs, budget_bytes: int, eff_batch: int, *, slots: int = 2,
                cache_dtype: Optional[str] = None
                ) -> Tuple[Optional[StreamPlan], str]:
    """The shard geometry that streams ``fs`` through ``budget_bytes`` of
    device memory, or why streaming is infeasible: ``(plan, "")`` or
    ``(None, reason)``.  Each shard fills one of ``slots`` slots of
    ``budget / slots`` bytes, so the live shards respect the budget the
    DEVICE tier would have used."""
    n = len(fs)
    if n == 0:
        return None, "empty dataset"
    if eff_batch <= 0 or n < eff_batch:
        return None, (f"dataset ({n} rows) smaller than one effective "
                      f"batch ({eff_batch})")
    probe = fs.read_rows(0, min(n, 2))
    if fs.transforms:
        probe = list(_apply(fs.transforms,
                            tuple(np.asarray(a) for a in probe)))
    specs = [(tuple(int(s) for s in np.shape(a)[1:]),
              np.dtype(np.asarray(a).dtype)) for a in probe]
    if len(specs) < 2:
        return None, "streaming needs (inputs..., label) arrays"
    if cache_dtype is not None and cache_dtype not in ("uint8", "int8"):
        raise ValueError(f"unknown data_cache_dtype {cache_dtype!r}; "
                         "known: None, uint8, int8")
    # float feature arrays only: the label (last) and integer features
    # (ids, tokens) pass unquantized
    quantized = tuple(
        cache_dtype is not None and j < len(specs) - 1
        and np.issubdtype(dtype, np.floating)
        for j, (_, dtype) in enumerate(specs))
    slots = max(2, int(slots))
    slot_budget = max(1, int(budget_bytes) // slots)
    row_bytes = sum(
        int(np.prod(shape, dtype=np.int64)) * (1 if q else dtype.itemsize)
        for (shape, dtype), q in zip(specs, quantized))
    max_rows_per_shard = slot_budget // max(1, row_bytes)
    if max_rows_per_shard < eff_batch:
        return None, (
            f"a {slot_budget}B device slot holds {max_rows_per_shard} rows "
            f"({row_bytes}B/row) — less than one batch ({eff_batch})")
    n_shards = max(1, -(-n * row_bytes // slot_budget))   # ceil
    shard_rows = ((n // n_shards) // eff_batch) * eff_batch
    if shard_rows == 0:
        return None, (f"{n} rows over {n_shards} shards leaves no full "
                      f"batch of {eff_batch} per shard")
    plan = StreamPlan(
        n_rows=n, n_shards=n_shards, shard_rows=shard_rows,
        steps_per_shard=shard_rows // eff_batch, eff_batch=eff_batch,
        slots=slots, cache_dtype=cache_dtype, specs=specs,
        quantized=quantized)
    if plan.dropped_rows:
        logger.warning(
            "STREAM tier drops %d/%d rows per epoch (%d shards x %d "
            "rows; < one batch per shard, the streaming analog of "
            "drop_remainder)", plan.dropped_rows, n, n_shards, shard_rows)
    return plan, ""


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype)).dtype


class _Slot:
    """One slot's device tensors and the pinned host buffers the uploader
    fills before copying them over: per array ``q`` (the rows, encoded or
    not) and, for a quantized array, ``[scale, zero]``; and the in-shard
    permutation (int64, the gathers' index type)."""

    def __init__(self, plan: StreamPlan, device: torch.device, pin: bool):
        rows = plan.shard_rows

        def pair(shape, dtype):
            dev = torch.empty(shape, dtype=dtype, device=device)
            host = (torch.empty(shape, dtype=dtype, pin_memory=True)
                    if pin else None)
            return dev, host

        self.arrays = []            # [(dev, host)] per array
        self.scales = []            # [(dev, host) of [scale, zero]] or None
        for (shape, dtype), q in zip(plan.specs, plan.quantized):
            dt = (_torch_dtype(np.dtype(plan.cache_dtype)) if q
                  else _torch_dtype(dtype))
            self.arrays.append(pair((rows,) + tuple(shape), dt))
            self.scales.append(pair((2,), torch.float32) if q else None)
        self.perm = pair((rows,), torch.int64)

    def views(self):
        """The device tensors a shard program reads: per array the rows,
        or ``(q, scale, zero)`` for a quantized one; and the permutation."""
        out = []
        for (dev, _), sc in zip(self.arrays, self.scales):
            out.append(dev if sc is None else (dev, sc[0][0], sc[0][1]))
        return out, self.perm[0]


class StreamSlots:
    """The ``plan.slots`` device slots of a plan and the side stream the
    uploads run on, made on the calling thread (allocations and pinned
    buffers stay out of the uploader thread and out of any capture).  An
    Estimator keeps them across epochs and fits with the same plan, so
    its per-slot shard programs keep their addresses."""

    def __init__(self, plan: StreamPlan, device):
        self.device = torch.device(device)
        self.key = plan.key + (plan.slots,)
        cuda = self.device.type == "cuda"
        self.slots = [_Slot(plan, self.device, cuda)
                      for _ in range(plan.slots)]
        self.stream = torch.cuda.Stream(self.device) if cuda else None

    def fill(self, slot: int, plan: StreamPlan, host: Sequence[np.ndarray],
             perm: np.ndarray) -> Optional[torch.cuda.Event]:
        """Encode ``host`` (one staged shard) into slot ``slot``: through
        its pinned buffers and one side-stream copy on the card, ending
        in the event returned; copied in place on the CPU (None)."""
        from analytics_zoo_tpu_torch.ops.quantization import \
            quantize_feature_array

        s = self.slots[slot]
        parts = []
        for a, q, (dev, pinned), sc in zip(host, plan.quantized, s.arrays,
                                           s.scales):
            if q:
                qa, scale, zero = quantize_feature_array(
                    np.asarray(a), plan.cache_dtype)
                parts.append((dev, pinned, qa))
                parts.append((sc[0], sc[1], np.asarray([scale, zero],
                                                       np.float32)))
            else:
                parts.append((dev, pinned, a))
        parts.append((s.perm[0], s.perm[1], np.asarray(perm, np.int64)))
        if self.stream is None:
            for dev, _, src in parts:
                dev.numpy()[...] = src
            return None
        for _, pinned, src in parts:
            pinned.numpy()[...] = src
        with torch.cuda.stream(self.stream):
            for dev, pinned, _ in parts:
                dev.copy_(pinned, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self.stream)
        return ready


class ShardLease:
    """One uploaded shard, alive in its slot until released.

    ``ready`` is the event its copy recorded (None on the CPU): the
    consumer's stream waits on it (``wait``) before the shard program
    reads the slot.  ``release(after=event)`` hands the slot back with an
    event recorded after the shard's last launch; the uploader waits on
    it before overwriting the slot."""

    __slots__ = ("position", "shard_id", "slot", "ready", "_uploader",
                 "_released")

    def __init__(self, position: int, shard_id: int, slot: int, ready,
                 uploader: "ShardUploader"):
        self.position = position        # index into the epoch's order
        self.shard_id = shard_id        # which fixed partition
        self.slot = slot
        self.ready = ready
        self._uploader = uploader
        self._released = False

    def wait(self, device) -> None:
        """Order the current stream after this shard's copy."""
        if self.ready is not None:
            torch.cuda.current_stream(device).wait_event(self.ready)

    def release(self, after=None) -> None:
        if self._released:
            return
        self._released = True
        self._uploader._release_slot(self.slot, after)


class ShardUploader:
    """Background shard staging on a daemon thread, at most
    ``plan.slots`` shards ahead of the consumer.  Producer exceptions
    surface at ``get()`` as ``StreamUploadError``; ``close()`` is
    idempotent and bounded.  Fault sites: ``data.shard_upload`` (a
    planned crash before a shard's read) and ``data.shard_torn`` (a
    planned short read, caught by ``validate_shard``)."""

    def __init__(self, fs, plan: StreamPlan, order: np.ndarray,
                 slots: StreamSlots, *, start: int = 0, perm_fn=None):
        self._ready: "queue.Queue" = queue.Queue()
        self._free: "queue.Queue" = queue.Queue()
        for slot in range(plan.slots):
            self._free.put((slot, None))
        self._stop = threading.Event()
        self._err_lock = threading.Lock()
        self._err: Optional[BaseException] = None
        self._closed = False
        self._close_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._upload_ms_total = 0.0
        self._uploads = 0
        if perm_fn is None:
            def perm_fn(_shard_id):
                return np.arange(plan.shard_rows)

        def claim_slot() -> Optional[Tuple[int, object]]:
            while not self._stop.is_set():
                try:
                    return self._free.get(timeout=0.1)
                except queue.Empty:
                    continue
            return None

        def run():
            try:
                for pos in range(start, len(order)):
                    claimed = claim_slot()
                    if claimed is None:
                        return          # closed mid-rotation
                    slot, after = claimed
                    if after is not None:
                        # the slot's last shard program must finish before
                        # the slot is overwritten: waited here, on this
                        # thread, while the consumer dispatches the other
                        after.synchronize()
                    shard_id = int(order[pos])
                    faults.inject("data.shard_upload")
                    t0 = time.perf_counter()
                    host = plan.load_shard(fs, shard_id)
                    torn = faults.fire("data.shard_torn")
                    if torn is not None:
                        if torn.exc is not None:
                            raise torn.exc
                        host = [a[:max(0, len(a) // 2)] for a in host]
                    plan.validate_shard(host, shard_id)
                    ready = slots.fill(slot, plan, host, perm_fn(shard_id))
                    del host
                    dt_ms = (time.perf_counter() - t0) * 1e3
                    obs.observe("data_shard_upload_ms", dt_ms,
                                flat="stream/shard_upload_ms")
                    with self._stats_lock:
                        self._upload_ms_total += dt_ms
                        self._uploads += 1
                    if self._stop.is_set():
                        return
                    self._ready.put(ShardLease(pos, shard_id, slot, ready,
                                               self))
            except BaseException as e:  # surfaced by get()
                with self._err_lock:
                    self._err = e
            finally:
                self._ready.put(_SENTINEL)

        self._thread = threading.Thread(
            target=run, daemon=True, name="zoo-shard-uploader")
        self._thread.start()

    def get(self) -> ShardLease:
        """The next uploaded shard; blocks while the uploader is behind
        (the ``data_shard_wait_ms`` histogram: near zero at steady
        state)."""
        t0 = time.perf_counter()
        item = self._get()
        obs.observe("data_shard_wait_ms", (time.perf_counter() - t0) * 1e3,
                    flat="stream/shard_wait_ms")
        if item is _SENTINEL:
            self._thread.join()
            err = self._error()
            if err is not None:
                if isinstance(err, StreamUploadError):
                    raise err
                raise StreamUploadError(
                    f"shard uploader failed: {err}") from err
            raise StreamUploadError(
                "shard uploader exhausted before the rotation finished")
        return item

    def _get(self):
        while True:
            try:
                return self._ready.get(timeout=1.0)
            except queue.Empty:
                if not self._thread.is_alive():
                    try:
                        return self._ready.get_nowait()
                    except queue.Empty:
                        raise StreamUploadError(
                            "shard uploader thread died without a "
                            "sentinel") from None

    def _error(self) -> Optional[BaseException]:
        with self._err_lock:
            return self._err

    def _release_slot(self, slot: int, after) -> None:
        self._free.put((slot, after))

    def stats(self) -> Dict[str, float]:
        with self._stats_lock:
            return {"upload_ms_total": self._upload_ms_total,
                    "uploads": float(self._uploads)}

    def close(self, timeout: float = 5.0) -> None:
        """Stop the uploader (epoch end, early exit, fallback).
        Idempotent; joins with a bounded timeout."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        self._stop.set()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            logger.warning("shard uploader did not stop within %.1fs of "
                           "close(); abandoned (daemon thread)", timeout)
