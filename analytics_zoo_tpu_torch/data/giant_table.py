"""Deterministic lazily-generated giant embedding tables.

The JAX package's module, copied bit for bit.  DLRM-scale tables have
10⁸ rows and must never be materialized on the host whole — a 10⁸×64
f32 table is ~25 GiB.  ``SyntheticGiantTable`` is the table-shaped
sibling of ``SlicedFeatureSet``: its size accounting (``.nbytes``,
``len``) comes from header math alone, and actual values exist only for
the row range somebody asks for, computed on demand as a pure function
of ``(seed, row_id)`` — so every consumer (a device table filled chunk
by chunk, a shard of a sharded table, a parity check, the JAX package)
sees the identical table without any of them holding more than its own
slice.

The generator is a vectorized splitmix64-style integer hash: uniform,
stateless, and cheap enough to fill a multi-GiB shard at memory
bandwidth — no RNG object, no sequential dependency between rows.
"""

from __future__ import annotations

import numpy as np

# splitmix64 constants (Steele et al.); the standard finalizer mixes
# each 64-bit counter value into an independent uniform word
_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + _GAMMA) * np.uint64(1)
    x ^= x >> np.uint64(30)
    x *= _MIX1
    x ^= x >> np.uint64(27)
    x *= _MIX2
    x ^= x >> np.uint64(31)
    return x


class SyntheticGiantTable:
    """A virtual ``(rows, dim)`` float table defined by ``(seed, row)``.

    ``rows(lo, hi)`` materializes just that row range (the contract
    ``init_table_sharded`` uses to fill each device's shard), ``row(i)``
    one row; values are uniform in ``[-scale, scale)`` and identical
    for the same ``(seed, row, column)`` regardless of which range they
    were generated through.
    """

    def __init__(self, rows: int, dim: int, seed: int = 0,
                 dtype=np.float32, scale: float = 0.05):
        if rows <= 0 or dim <= 0:
            raise ValueError(f"need positive rows/dim, got {rows}x{dim}")
        self.row_count = int(rows)
        self.dim = int(dim)
        self.seed = int(seed)
        self.dtype = np.dtype(dtype)
        self.scale = float(scale)

    # -- header-only accounting (the SlicedFeatureSet discipline) ------
    def __len__(self) -> int:
        return self.row_count

    @property
    def shape(self):
        return (self.row_count, self.dim)

    @property
    def nbytes(self) -> int:
        """Total virtual bytes — pure arithmetic, nothing generated."""
        return self.row_count * self.dim * self.dtype.itemsize

    # -- on-demand materialization -------------------------------------
    # cells per generation chunk: bounds the uint64/f64 intermediates to
    # ~100 MB however large the requested slice is (a 10⁸-row shard fill
    # must not transiently triple its own footprint)
    _CHUNK_CELLS = 4 << 20

    def rows(self, lo: int, hi: int) -> np.ndarray:
        """Rows ``[lo, hi)`` as a ``(hi-lo, dim)`` array."""
        if not 0 <= lo <= hi <= self.row_count:
            raise IndexError(
                f"row range [{lo}, {hi}) outside table of "
                f"{self.row_count} rows")
        n = hi - lo
        out = np.empty((n * self.dim,), self.dtype)
        # one 64-bit counter per cell: row * dim + col, offset by the
        # seed far enough that different seeds never share counters
        base = np.uint64(self.seed) * np.uint64(0x51ED2701)
        start, stop = lo * self.dim, hi * self.dim
        for c0 in range(start, stop, self._CHUNK_CELLS):
            c1 = min(c0 + self._CHUNK_CELLS, stop)
            idx = np.arange(c0, c1, dtype=np.uint64) + base
            with np.errstate(over="ignore"):  # uint64 wrap is the point
                bits = _splitmix64(idx)
            # top 24 bits -> uniform [0, 1) at f32 resolution, centered
            unit = (bits >> np.uint64(40)).astype(np.float64) / \
                float(1 << 24)
            out[c0 - start:c1 - start] = \
                ((unit * 2.0 - 1.0) * self.scale).astype(self.dtype)
        return out.reshape(n, self.dim)

    def row(self, i: int) -> np.ndarray:
        return self.rows(i, i + 1)[0]
