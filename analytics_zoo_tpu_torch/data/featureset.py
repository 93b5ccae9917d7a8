"""FeatureSet — a host dataset of aligned numpy arrays with cache levels.

The numpy half of the JAX package's ``data/featureset.py``, copied and
cut to what the Estimator reads: rows live on the host as numpy arrays;
``batches`` yields shuffled host batches (``CacheLevel.HOST``), and
``device_arrays`` copies the whole set onto the device once
(``CacheLevel.DEVICE``), where the Estimator shuffles and gathers each
batch.  ``memory_type`` takes the JAX package's "DRAM" (rows in host
memory); its disk tiers, ``transform`` / ``read_rows``, the
``from_npy_*`` / ``from_parquet`` readers, ``SlicedFeatureSet`` and the
STREAM tier are not ported yet (ROADMAP A5.6).  Per-batch transforms given
at construction apply as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch


class CacheLevel:
    """Where a FeatureSet's rows live while the Estimator trains from it.

    - ``HOST``: rows stay in host memory; each batch is gathered there and
      copied to the device.
    - ``DEVICE``: the whole set is copied to the device once and each
      epoch's shuffle and gathers run there — no host-to-device bytes per
      batch.  Over ``ZooConfig.data_device_budget_bytes`` it falls back
      to HOST.
    """

    HOST = "HOST"
    DEVICE = "DEVICE"

    _LEVELS = (HOST, DEVICE)

    @staticmethod
    def normalize(level: str) -> str:
        lv = str(level).upper()
        if lv not in CacheLevel._LEVELS:
            raise ValueError(f"unknown cache level {level!r}; "
                             f"known: {CacheLevel._LEVELS}")
        return lv


class FeatureSet:
    """A set of aligned arrays (inputs..., label).

    ``batches(batch_size)`` yields tuples of numpy arrays; the final
    element is the label (if present).
    """

    def __init__(self, arrays: Sequence[np.ndarray],
                 memory_type: str = "DRAM",
                 transforms: Optional[List[Callable]] = None,
                 seed: int = 0, cache_level: Optional[str] = None):
        """The JAX signature.  ``memory_type`` "DRAM" keeps the rows in
        host memory; the disk tiers ("DISK_AND_DRAM", "DIRECT") raise
        until ROADMAP A5.6.  ``transforms``: per-batch functions
        ``fn(*arrays) -> arrays``, applied in order to each batch (and once
        to the whole set for a DEVICE cache)."""
        if not arrays:
            raise ValueError("FeatureSet needs at least one array")
        n = len(arrays[0])
        for a in arrays:
            if len(a) != n:
                raise ValueError("arrays must be aligned on dim 0")
        self.memory_type = str(memory_type).upper()
        if self.memory_type != "DRAM":
            raise NotImplementedError(
                f"memory_type={memory_type!r}: the disk tiers of the JAX "
                f"FeatureSet are not ported yet (ROADMAP A5.6); use "
                f"\"DRAM\"")
        self.transforms = list(transforms or [])
        self.seed = seed
        self._rng = np.random.RandomState(seed)
        # None = inherit ZooConfig.data_cache_level at fit time
        self.cache_level = (CacheLevel.normalize(cache_level)
                            if cache_level is not None else None)
        self.arrays = [np.asarray(a) for a in arrays]

    @staticmethod
    def from_ndarrays(x, y=None, memory_type: str = "DRAM", seed: int = 0,
                      cache_level: Optional[str] = None) -> "FeatureSet":
        xs = list(x) if isinstance(x, (list, tuple)) else [x]
        if y is not None:
            xs = xs + [y]
        return FeatureSet(xs, memory_type=memory_type, seed=seed,
                          cache_level=cache_level)

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
        cache)."""
        return int(sum(a.dtype.itemsize * a.size for a in self.arrays))

    def device_arrays(self, device) -> List[torch.Tensor]:
        """The whole set on ``device``: one copy per array, after the
        transforms, applied once over the whole arrays (per-sample
        transforms, as the per-batch protocol already implies)."""
        return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in self._transformed(tuple(self.arrays))]

    def _transformed(self, batch: Tuple[np.ndarray, ...]
                     ) -> Tuple[np.ndarray, ...]:
        for fn in self.transforms:
            batch = fn(*batch)
            if not isinstance(batch, tuple):
                batch = (batch,)
        return batch

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
        contiguous blocks of that many and the blocks' order (``None`` or
        at least the row count: one permutation of all rows)."""
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
            yield self._transformed(tuple(a[idx] for a in self.arrays))
