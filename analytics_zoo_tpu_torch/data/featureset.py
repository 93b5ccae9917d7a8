"""FeatureSet — a host dataset of aligned numpy arrays with memory tiers
and cache levels.

The numpy half of the JAX package's ``data/featureset.py``, copied: rows
live on the host as numpy arrays (``memory_type`` "DRAM") or as
memory-mapped ``.npy`` files on disk ("DISK_AND_DRAM", "DIRECT";
``from_npy_files``, and ``from_npy_slices`` for a ``SlicedFeatureSet``
that holds one slice in memory at a time).  ``transform`` appends a
per-batch function applied lazily; ``read_rows`` reads a row span, the
STREAM tier's shard loader.  The cache level says where the Estimator
trains from: host batches (``HOST``), the whole set copied to the device
once (``DEVICE``, ``device_arrays``), or budget-sized shards rotated
through device slots (``STREAM``, ``data/streaming.py``).
"""

from __future__ import annotations

import math
import os
import tempfile
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

MemoryType = str  # "DRAM" | "DISK_AND_DRAM" | "DIRECT"


def _gather(a: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Batch assembly: the native parallel row gather (``native``) for a
    C-contiguous array whose batch is 1 MiB or more, numpy fancy
    indexing otherwise (the same rows either way)."""
    row_bytes = a.dtype.itemsize * int(np.prod(a.shape[1:], dtype=int))
    if row_bytes * len(idx) >= (1 << 20) and a.flags["C_CONTIGUOUS"]:
        from analytics_zoo_tpu_torch.native import available, gather_rows

        if available():
            return gather_rows(a, idx)
    return np.asarray(a[idx])


def npy_header(path: str) -> Tuple[Tuple[int, ...], np.dtype]:
    """(shape, dtype) of a .npy file from its header only: no data is
    read or mapped, so the tier router can size a dataset larger than
    memory without touching its rows."""
    fmt = np.lib.format
    with open(path, "rb") as f:
        version = fmt.read_magic(f)
        read = (fmt.read_array_header_1_0 if version == (1, 0)
                else fmt.read_array_header_2_0)
        shape, _fortran, dtype = read(f)
    return tuple(int(s) for s in shape), np.dtype(dtype)


def _apply(transforms, batch: Tuple[np.ndarray, ...]
           ) -> Tuple[np.ndarray, ...]:
    for fn in transforms:
        batch = fn(*batch)
        if not isinstance(batch, tuple):
            batch = (batch,)
    return batch


class CacheLevel:
    """Where a FeatureSet's rows live while the Estimator trains from it.

    - ``HOST``: rows stay on the host (numpy or mmap, per
      ``memory_type``); each batch is gathered there and copied to the
      device.
    - ``DEVICE``: the whole set is copied to the device once and each
      epoch's shuffle and gathers run there — no host-to-device bytes per
      batch.  Over ``ZooConfig.data_device_budget_bytes`` it streams (or
      trains from host batches when streaming is not feasible).
    - ``STREAM``: for sets larger than the budget: the rows are cut into
      budget-sized shards that an uploader thread rotates through
      ``ZooConfig.data_stream_slots`` device slots, copying shard N+1
      while the captured shard program trains on shard N.  The shard
      order is shuffled per epoch, the rows within a shard on the
      device; float features may travel as uint8 / int8
      (``ZooConfig.data_cache_dtype``), decoded after the minibatch
      gather.
    """

    HOST = "HOST"
    DEVICE = "DEVICE"
    STREAM = "STREAM"

    _LEVELS = (HOST, DEVICE, STREAM)

    @staticmethod
    def normalize(level: str) -> str:
        lv = str(level).upper()
        if lv not in CacheLevel._LEVELS:
            raise ValueError(f"unknown cache level {level!r}; "
                             f"known: {CacheLevel._LEVELS}")
        return lv


class FeatureSet:
    """A set of aligned arrays (inputs..., label) with lazy transforms.

    ``batches(batch_size)`` yields tuples of numpy arrays; the final
    element is the label (if present).
    """

    def __init__(self, arrays: Sequence[np.ndarray],
                 memory_type: MemoryType = "DRAM",
                 transforms: Optional[List[Callable]] = None,
                 seed: int = 0, cache_level: Optional[str] = None):
        """The JAX signature.  ``memory_type`` "DRAM" keeps the rows in
        host memory; "DISK_AND_DRAM" and "DIRECT" spill each array to a
        temporary ``.npy`` file and map it.  ``transforms``: per-batch
        functions ``fn(*arrays) -> arrays``, applied in order to each
        batch (and once to the whole set for a DEVICE cache, once per
        shard for a STREAM one)."""
        if not arrays:
            raise ValueError("FeatureSet needs at least one array")
        n = len(arrays[0])
        for a in arrays:
            if len(a) != n:
                raise ValueError("arrays must be aligned on dim 0")
        self.memory_type = str(memory_type).upper()
        self.transforms = list(transforms or [])
        self.seed = seed
        self._rng = np.random.RandomState(seed)
        # None = inherit ZooConfig.data_cache_level at fit time
        self.cache_level = (CacheLevel.normalize(cache_level)
                            if cache_level is not None else None)
        if self.memory_type in ("DISK_AND_DRAM", "DIRECT"):
            self.arrays = [self._to_mmap(np.asarray(a)) for a in arrays]
        else:
            self.arrays = [np.asarray(a) for a in arrays]

    # -- constructors -----------------------------------------------------
    @staticmethod
    def from_ndarrays(x, y=None, memory_type: MemoryType = "DRAM",
                      seed: int = 0,
                      cache_level: Optional[str] = None) -> "FeatureSet":
        xs = list(x) if isinstance(x, (list, tuple)) else [x]
        if y is not None:
            xs = xs + [y]
        return FeatureSet(xs, memory_type=memory_type, seed=seed,
                          cache_level=cache_level)

    @staticmethod
    def from_npy_files(paths: Sequence[str],
                       memory_type: MemoryType = "DISK_AND_DRAM"
                       ) -> "FeatureSet":
        """Aligned ``.npy`` files, memory-mapped (read into memory for
        "DRAM")."""
        mode = "r" if memory_type.upper() != "DRAM" else None
        fs = FeatureSet.__new__(FeatureSet)
        fs.memory_type = memory_type.upper()
        fs.transforms = []
        fs.seed = 0
        fs._rng = np.random.RandomState(0)
        fs.cache_level = None
        fs.arrays = [np.load(p, mmap_mode=mode) for p in paths]
        return fs

    @staticmethod
    def from_parquet(path: str, feature_cols: Sequence[str], label_col: str,
                     memory_type: MemoryType = "DRAM") -> "FeatureSet":
        """Columnar ingestion: one array per feature column (stacked when
        its cells are lists) and the label column last.  Needs pandas with
        a parquet engine."""
        import pandas as pd

        df = pd.read_parquet(path)
        arrays = [np.stack(df[c].to_numpy()) for c in feature_cols]
        arrays.append(df[label_col].to_numpy())
        return FeatureSet(arrays, memory_type=memory_type)

    @staticmethod
    def from_npy_slices(slices: Sequence[Sequence[str]],
                        seed: int = 0) -> "SlicedFeatureSet":
        """Slice-wise disk training: ``slices`` is a list of aligned
        ``.npy`` path tuples; one slice is in memory at a time and epochs
        stream slice by slice (slice order and rows within a slice
        shuffled), bounding host memory to the largest slice."""
        return SlicedFeatureSet(slices, seed=seed)

    # -- transforms -------------------------------------------------------
    def transform(self, fn: Callable[..., Tuple[np.ndarray, ...]]
                  ) -> "FeatureSet":
        """A copy with ``fn(*arrays) -> arrays`` appended to the per-batch
        transforms (lazy), sharing the backing arrays and the shuffle
        stream."""
        fs = FeatureSet.__new__(FeatureSet)
        fs.__dict__.update(self.__dict__)
        fs.transforms = self.transforms + [fn]
        return fs

    # -- cache levels -----------------------------------------------------
    def cache(self, level: str = CacheLevel.DEVICE) -> "FeatureSet":
        """Pin this FeatureSet's cache level; a shallow copy sharing the
        backing arrays."""
        fs = FeatureSet.__new__(FeatureSet)
        fs.__dict__.update(self.__dict__)
        fs.cache_level = CacheLevel.normalize(level)
        return fs

    @property
    def nbytes(self) -> int:
        """Total bytes of the backing arrays (the device bill of a DEVICE
        cache, before the transforms)."""
        return int(sum(a.dtype.itemsize * a.size for a in self.arrays))

    def device_arrays(self, device) -> List[torch.Tensor]:
        """The whole set on ``device``: one copy per array, after the
        transforms, applied once over the whole arrays (per-sample
        transforms, as the per-batch protocol already implies)."""
        return [torch.from_numpy(np.require(a, requirements=("C", "W")))
                .to(device)
                for a in _apply(self.transforms, tuple(self.arrays))]

    # -- iteration --------------------------------------------------------
    def __len__(self) -> int:
        return len(self.arrays[0])

    @property
    def size(self) -> int:
        return len(self)

    def batches(self, batch_size: int, shuffle: bool = False,
                drop_remainder: bool = False, pad_to: int = 1,
                shuffle_buffer: Optional[int] = None
                ) -> Iterator[Tuple[np.ndarray, ...]]:
        """Yield host batches in a permutation drawn from this set's own
        ``RandomState`` (the JAX package's stream, so both yield the same
        batches from the same seed).  ``pad_to`` rounds ``batch_size`` up
        to a multiple of it; ``shuffle_buffer`` permutes the rows within
        contiguous blocks of that many and the blocks' order, so a disk
        tier reads near-sequentially (``None`` or at least the row count:
        one permutation of all rows)."""
        n = len(self)
        bs = int(math.ceil(batch_size / pad_to)) * pad_to
        if not shuffle:
            order = np.arange(n)
        elif shuffle_buffer is not None and 0 < shuffle_buffer < n:
            buf = int(shuffle_buffer)
            starts = np.arange(0, n, buf)
            self._rng.shuffle(starts)
            order = np.concatenate([
                s + self._rng.permutation(min(buf, n - s)) for s in starts])
        else:
            order = self._rng.permutation(n)
        steps = n // bs if drop_remainder else int(math.ceil(n / bs))
        for s in range(steps):
            idx = order[s * bs:(s + 1) * bs]
            yield _apply(self.transforms,
                         tuple(_gather(a, idx) for a in self.arrays))

    def read_rows(self, start: int, stop: int) -> List[np.ndarray]:
        """Row span [start, stop) of every backing array (views for DRAM
        arrays, page-backed reads for the mmap tiers), before the
        transforms: the STREAM tier's shard loader."""
        if not (0 <= start <= stop <= len(self)):
            raise ValueError(f"row span [{start}, {stop}) out of range "
                             f"for {len(self)} rows")
        return [a[start:stop] for a in self.arrays]

    # -- internals --------------------------------------------------------
    @staticmethod
    def _to_mmap(a: np.ndarray) -> np.ndarray:
        """Spill an array to a temporary ``.npy`` file and map it."""
        fd, path = tempfile.mkstemp(suffix=".npy", prefix="zoo_featureset_")
        os.close(fd)
        np.save(path, a)
        return np.load(path, mmap_mode="r")


class SlicedFeatureSet(FeatureSet):
    """A FeatureSet whose rows live in per-slice ``.npy`` files on disk;
    only one slice is in host memory at a time.  Its size is read from
    the files' headers, so it never caches on the device whole: its
    level is HOST, or STREAM."""

    def __init__(self, slices: Sequence[Sequence[str]], seed: int = 0):
        if not slices:
            raise ValueError("need at least one slice")
        self.slice_paths = [tuple(s) for s in slices]
        width = len(self.slice_paths[0])
        if any(len(s) != width for s in self.slice_paths):
            raise ValueError("every slice must have the same array count")
        self.memory_type = "DISK_AND_DRAM"
        self.transforms = []
        self.seed = seed
        self._rng = np.random.RandomState(seed)
        self.cache_level = CacheLevel.HOST
        self._slice_rows = []
        self._disk_bytes = 0
        self._row_specs: Optional[List[Tuple[Tuple[int, ...],
                                             np.dtype]]] = None
        for s in self.slice_paths:
            counts = set()
            specs = []
            for p in s:
                shape, dtype = npy_header(p)
                counts.add(shape[0] if shape else 0)
                specs.append((shape[1:], dtype))
                self._disk_bytes += dtype.itemsize * int(
                    np.prod(shape, dtype=np.int64))
            if len(counts) != 1:
                raise ValueError(f"slice {s} arrays are not aligned")
            if self._row_specs is None:
                self._row_specs = specs
            elif specs != self._row_specs:
                raise ValueError(
                    f"slice {s} row shapes/dtypes differ from the first "
                    f"slice: {specs} vs {self._row_specs}")
            self._slice_rows.append(counts.pop())

    def transform(self, fn) -> "SlicedFeatureSet":
        fs = SlicedFeatureSet.__new__(SlicedFeatureSet)
        fs.__dict__.update(self.__dict__)
        fs.transforms = self.transforms + [fn]
        return fs

    @property
    def nbytes(self) -> int:
        """Summed bytes of the slices, from their headers."""
        return int(self._disk_bytes)

    def cache(self, level: str = CacheLevel.DEVICE) -> "SlicedFeatureSet":
        lv = CacheLevel.normalize(level)
        if lv == CacheLevel.DEVICE:
            raise ValueError(
                "SlicedFeatureSet streams slices because the dataset "
                "outgrows resident memory; a DEVICE cache cannot hold it "
                "— use CacheLevel.STREAM to rotate budget-sized shards "
                "through the device, or FeatureSet.from_ndarrays for data "
                "that fits the device budget")
        fs = SlicedFeatureSet.__new__(SlicedFeatureSet)
        fs.__dict__.update(self.__dict__)
        fs.cache_level = lv
        return fs

    def read_rows(self, start: int, stop: int) -> List[np.ndarray]:
        """Global rows [start, stop) across the slice files (mapped reads,
        copied out), before the transforms."""
        if not (0 <= start <= stop <= len(self)):
            raise ValueError(f"row span [{start}, {stop}) out of range "
                             f"for {len(self)} rows")
        width = len(self.slice_paths[0])
        parts: List[List[np.ndarray]] = [[] for _ in range(width)]
        offset = 0
        for si, rows in enumerate(self._slice_rows):
            lo, hi = max(start - offset, 0), min(stop - offset, rows)
            if lo < hi:
                for j, p in enumerate(self.slice_paths[si]):
                    a = np.load(p, mmap_mode="r")
                    parts[j].append(np.asarray(a[lo:hi]))
            offset += rows
            if offset >= stop:
                break
        return [np.concatenate(ps) if len(ps) > 1 else ps[0]
                for ps in parts]

    def __len__(self) -> int:
        return int(sum(self._slice_rows))

    def batches(self, batch_size: int, shuffle: bool = False,
                drop_remainder: bool = False, pad_to: int = 1,
                shuffle_buffer: Optional[int] = None
                ) -> Iterator[Tuple[np.ndarray, ...]]:
        """Batches slice by slice.  Rows left over when a slice does not
        divide the batch are carried into the next slice, so small slices
        still contribute every row.  ``shuffle_buffer`` is accepted and
        moot: the slice in memory is the shuffle window."""
        bs = int(math.ceil(batch_size / pad_to)) * pad_to
        order = (self._rng.permutation(len(self.slice_paths)) if shuffle
                 else np.arange(len(self.slice_paths)))
        carry: Optional[List[np.ndarray]] = None
        for si in order:
            arrays = [np.load(p) for p in self.slice_paths[si]]
            if carry is not None:
                arrays = [np.concatenate([c, a])
                          for c, a in zip(carry, arrays)]
                carry = None
            n = len(arrays[0])
            rows = self._rng.permutation(n) if shuffle else np.arange(n)
            for s in range(n // bs):
                idx = rows[s * bs:(s + 1) * bs]
                yield _apply(self.transforms,
                             tuple(_gather(a, idx) for a in arrays))
            rem = rows[(n // bs) * bs:]
            if len(rem):
                carry = [a[rem] for a in arrays]
            del arrays          # release the slice before loading the next
        if carry is not None and not drop_remainder:
            yield _apply(self.transforms, tuple(carry))
