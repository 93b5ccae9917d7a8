"""Seeded zipfian id draws: one source of truth for skewed traffic.

The JAX package's ``data/zipf.py``, copied (it is numpy alone).  The
loadgen ``ZipfianIdPayload`` class draws through this module, and the
two packages give **byte-identical** id streams for the same ``(vocab,
n, s)`` and generator state, so a hit-rate claim at skew s=1.0 is about
the distribution the load harness offers, whichever package drew it.

The draw is a plain ``Generator.choice`` over the normalized
``1/rank**s`` weights (rank 1 = id 0): deterministic from the generator
state, no rejection sampling, so callers that interleave other draws on
the same generator consume exactly one ``choice`` per call.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["zipf_weights", "zipfian_ids"]


def zipf_weights(vocab: int, s: float = 1.0) -> np.ndarray:
    """Normalized zipf pmf over ids ``0..vocab-1``: id k has weight
    ``1/(k+1)**s`` (id 0 is the hottest row).  ``s=0`` is uniform."""
    if vocab <= 0:
        raise ValueError(f"vocab must be positive, got {vocab}")
    ranks = np.arange(1, int(vocab) + 1, dtype=np.float64)
    w = ranks ** -float(s)
    return w / w.sum()


def zipfian_ids(vocab: int, n: int, s: float = 1.0, *, seed: int = 0,
                rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """``n`` int32 ids drawn zipf(s) over ``0..vocab-1``.

    Pass ``rng`` to ride an existing ``np.random.Generator`` stream
    (the loadgen payload path — deterministic per (seed, arrival
    index)); without one, ``default_rng(seed)`` makes the draw
    self-contained.  Same (vocab, n, s) and generator state -> the same
    bytes, whichever caller asks.
    """
    if rng is None:
        rng = np.random.default_rng(seed)
    p = zipf_weights(vocab, s)
    return rng.choice(int(vocab), size=int(n), p=p).astype(np.int32)
