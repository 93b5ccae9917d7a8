"""FeatureSet — a host dataset of aligned numpy arrays with cache levels.

The numpy half of the JAX package's ``data/featureset.py``, copied and
cut to what the Estimator reads: rows live on the host as numpy arrays;
``batches`` yields shuffled host batches (``CacheLevel.HOST``), and
``device_arrays`` copies the whole set onto the device once
(``CacheLevel.DEVICE``), where the Estimator shuffles and gathers each
batch.  Transforms, the disk tiers, ``SlicedFeatureSet`` and the STREAM
tier are not ported yet.
"""

from __future__ import annotations

import math
from typing import Iterator, List, Optional, Sequence, Tuple

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

    def __init__(self, arrays: Sequence[np.ndarray], seed: int = 0,
                 cache_level: Optional[str] = None):
        if not arrays:
            raise ValueError("FeatureSet needs at least one array")
        n = len(arrays[0])
        for a in arrays:
            if len(a) != n:
                raise ValueError("arrays must be aligned on dim 0")
        self.seed = seed
        self._rng = np.random.RandomState(seed)
        # None = inherit ZooConfig.data_cache_level at fit time
        self.cache_level = (CacheLevel.normalize(cache_level)
                            if cache_level is not None else None)
        self.arrays = [np.asarray(a) for a in arrays]

    @staticmethod
    def from_ndarrays(x, y=None, seed: int = 0,
                      cache_level: Optional[str] = None) -> "FeatureSet":
        xs = list(x) if isinstance(x, (list, tuple)) else [x]
        if y is not None:
            xs = xs + [y]
        return FeatureSet(xs, seed=seed, cache_level=cache_level)

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
        """The whole set on ``device``: one copy per array."""
        return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in self.arrays]

    def __len__(self) -> int:
        return len(self.arrays[0])

    @property
    def size(self) -> int:
        return len(self)

    def batches(self, batch_size: int, shuffle: bool = False,
                drop_remainder: bool = False
                ) -> Iterator[Tuple[np.ndarray, ...]]:
        """Yield host batches in a permutation drawn from this set's own
        ``RandomState`` (the JAX package's stream, so both yield the same
        batches from the same seed)."""
        n = len(self)
        order = self._rng.permutation(n) if shuffle else np.arange(n)
        steps = n // batch_size if drop_remainder else \
            int(math.ceil(n / batch_size))
        for s in range(steps):
            idx = order[s * batch_size:(s + 1) * batch_size]
            yield tuple(a[idx] for a in self.arrays)
