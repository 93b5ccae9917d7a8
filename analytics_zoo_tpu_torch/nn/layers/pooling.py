"""Pooling layers: max and average, windowed and global, 1-D/2-D/3-D —
the JAX package's ``nn/layers/pooling.py``.

Inputs are channels-last (``dim_ordering="tf"``) or channels-first
(``"th"``), viewed channels-first without a copy as in
``convolutional.py``.  ``border_mode="same"`` is TensorFlow's, with the
smaller half of the padding before: a padded max pool pads with -inf
(the 3x3/s2 pool on 112 pads (0, 1), where PyTorch's ``padding=1``
would pad (1, 1)), and a padded average divides each window's sum by
the count of real elements in it.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.nn.layers.convolutional import (
    DIM_ORDERINGS, _tuple, channels_back, channels_first, check_orderings,
    out_size, pad_spatial, same_pads)
from analytics_zoo_tpu_torch.nn.module import Layer

IntOrPair = Union[int, Sequence[int]]
_MAX = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


class PoolND(Layer):
    spatial = 2
    mode = "max"  # or "avg"

    def __init__(self, pool_size, strides=None, border_mode: str = "valid",
                 dim_ordering: str = "tf", **kw):
        super().__init__(**kw)
        check_orderings(dim_ordering, border_mode)
        self.pool_size = _tuple(pool_size, self.spatial)
        self.strides = (_tuple(strides, self.spatial) if strides is not None
                        else self.pool_size)
        self.border_mode = border_mode
        self.dim_ordering = dim_ordering

    def output_shape(self, input_shape):
        th = self.dim_ordering == "th"
        sizes = input_shape[2:] if th else input_shape[1:-1]
        out = tuple(out_size(n, k, s, 1, self.border_mode) for n, k, s
                    in zip(sizes, self.pool_size, self.strides))
        if th:
            return tuple(input_shape[:2]) + out
        return (input_shape[0],) + out + (input_shape[-1],)

    def forward(self, x):
        xc = channels_first(x, self.dim_ordering)
        pads = [(0, 0)] * self.spatial
        if self.border_mode == "same":
            pads = same_pads(xc.shape[2:], self.pool_size, self.strides,
                             (1,) * self.spatial)
        k, s = self.pool_size, self.strides
        if self.mode == "max":
            y = _MAX[self.spatial](pad_spatial(xc, pads, float("-inf")), k, s)
        elif not any(a or b for a, b in pads):
            y = _AVG[self.spatial](xc, k, s)
        else:
            # window sum / real elements in the window, both as means
            # over the full window (the window size cancels)
            mean = _AVG[self.spatial](pad_spatial(xc, pads), k, s)
            ones = torch.ones((1, 1) + tuple(xc.shape[2:]), dtype=xc.dtype,
                              device=xc.device)
            share = _AVG[self.spatial](pad_spatial(ones, pads), k, s)
            y = mean / share
        return channels_back(y, self.dim_ordering)


class MaxPooling1D(PoolND):
    spatial, mode = 1, "max"

    def __init__(self, pool_length: int = 2, stride=None, **kw):
        super().__init__((pool_length,),
                         (stride,) if stride is not None else None, **kw)


class MaxPooling2D(PoolND):
    spatial, mode = 2, "max"

    def __init__(self, pool_size: IntOrPair = (2, 2), strides=None, **kw):
        super().__init__(pool_size, strides, **kw)


class MaxPooling3D(PoolND):
    spatial, mode = 3, "max"

    def __init__(self, pool_size: IntOrPair = (2, 2, 2), strides=None, **kw):
        super().__init__(pool_size, strides, **kw)


class AveragePooling1D(PoolND):
    spatial, mode = 1, "avg"

    def __init__(self, pool_length: int = 2, stride=None, **kw):
        super().__init__((pool_length,),
                         (stride,) if stride is not None else None, **kw)


class AveragePooling2D(PoolND):
    spatial, mode = 2, "avg"

    def __init__(self, pool_size: IntOrPair = (2, 2), strides=None, **kw):
        super().__init__(pool_size, strides, **kw)


class AveragePooling3D(PoolND):
    spatial, mode = 3, "avg"

    def __init__(self, pool_size: IntOrPair = (2, 2, 2), strides=None, **kw):
        super().__init__(pool_size, strides, **kw)


class GlobalPoolND(Layer):
    """Reduce over every spatial axis of (B, *S, C) ("tf") or (B, C, *S)
    ("th") inputs, giving (B, C)."""

    spatial = 2
    mode = "max"

    def __init__(self, dim_ordering: str = "tf", **kw):
        super().__init__(**kw)
        if dim_ordering not in DIM_ORDERINGS:
            raise ValueError(f"dim_ordering must be one of {DIM_ORDERINGS}, "
                             f"got {dim_ordering!r}")
        self.dim_ordering = dim_ordering

    def _axes(self):
        first = 2 if self.dim_ordering == "th" else 1
        return tuple(range(first, first + self.spatial))

    def output_shape(self, input_shape):
        c = input_shape[1] if self.dim_ordering == "th" else input_shape[-1]
        return (input_shape[0], c)

    def forward(self, x):
        axes = self._axes()
        return x.amax(dim=axes) if self.mode == "max" else x.mean(dim=axes)


class GlobalMaxPooling1D(GlobalPoolND):
    spatial, mode = 1, "max"


class GlobalMaxPooling2D(GlobalPoolND):
    spatial, mode = 2, "max"


class GlobalMaxPooling3D(GlobalPoolND):
    spatial, mode = 3, "max"


class GlobalAveragePooling1D(GlobalPoolND):
    spatial, mode = 1, "avg"


class GlobalAveragePooling2D(GlobalPoolND):
    spatial, mode = 2, "avg"


class GlobalAveragePooling3D(GlobalPoolND):
    spatial, mode = 3, "avg"
