"""Typed, chainable preprocessing combinators (the JAX package's module,
copied: it is plain numpy).

Reference capability: ``feature/common/Preprocessing.scala`` — a typed
``Preprocessing[A, B]`` composed with ``->`` plus the converter zoo
(SeqToTensor, MLlibVectorToTensor, ScalarToTensor,
FeatureLabelPreprocessing, TensorToSample...).

Host-side equivalents: a ``Preprocessing`` is any single-argument
callable; ``>>`` (and ``chain``) compose left-to-right; converters lower
python/scalar/sequence rows to dense numpy.  The image/text pipelines'
chains and nnframes' feature/label preprocessing params all accept these.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Preprocessing", "ChainedPreprocessing", "SeqToTensor",
           "ScalarToTensor", "ArrayToTensor", "ToFloat32",
           "FeatureLabelPreprocessing", "TensorToSample"]


class Preprocessing:
    """A -> B transform, composable with ``>>`` (reference ``->``)."""

    def apply(self, value):
        raise NotImplementedError

    def __call__(self, value):
        return self.apply(value)

    def __rshift__(self, other: "Preprocessing") -> "ChainedPreprocessing":
        return ChainedPreprocessing([self, other])

    def chain(self, other: "Preprocessing") -> "ChainedPreprocessing":
        return self >> other


class ChainedPreprocessing(Preprocessing):
    def __init__(self, stages: Sequence[Callable]):
        self.stages: List[Callable] = []
        for s in stages:
            if isinstance(s, ChainedPreprocessing):
                self.stages.extend(s.stages)
            else:
                self.stages.append(s)

    def apply(self, value):
        for s in self.stages:
            value = s(value)
        return value


class SeqToTensor(Preprocessing):
    """Python sequence / list-of-lists -> ndarray with optional shape
    check (reference SeqToTensor)."""

    def __init__(self, size: Optional[Sequence[int]] = None,
                 dtype=np.float32):
        self.size = tuple(size) if size is not None else None
        self.dtype = dtype

    def apply(self, value):
        arr = np.asarray(value, self.dtype)
        if self.size is not None:
            arr = arr.reshape(self.size)
        return arr


class ScalarToTensor(Preprocessing):
    """Scalar -> shape-(1,) tensor (reference ScalarToTensor)."""

    def __init__(self, dtype=np.float32):
        self.dtype = dtype

    def apply(self, value):
        return np.asarray([value], self.dtype)


class ArrayToTensor(Preprocessing):
    """ndarray passthrough with dtype/shape normalization (the
    MLlibVectorToTensor role — dense vectors are plain arrays here)."""

    def __init__(self, size: Optional[Sequence[int]] = None,
                 dtype=np.float32):
        self.size = tuple(size) if size is not None else None
        self.dtype = dtype

    def apply(self, value):
        arr = np.asarray(value)
        if arr.dtype != self.dtype:
            arr = arr.astype(self.dtype)
        if self.size is not None:
            arr = arr.reshape(self.size)
        return arr


class ToFloat32(Preprocessing):
    def apply(self, value):
        return np.asarray(value, np.float32)


class TensorToSample(Preprocessing):
    """(feature, label) pair -> sample dict (reference TensorToSample /
    FeatureToTupleAdapter)."""

    def apply(self, value):
        if isinstance(value, tuple) and len(value) == 2:
            return {"feature": value[0], "label": value[1]}
        return {"feature": value}


class FeatureLabelPreprocessing(Preprocessing):
    """Pair transform: independent feature/label sub-chains (reference
    FeatureLabelPreprocessing.scala — the NNEstimator sample
    preprocessing).  Applies to (feature, label) tuples; a bare value is
    treated as feature-only."""

    def __init__(self, feature: Callable, label: Optional[Callable] = None):
        self.feature = feature
        self.label = label

    def apply(self, value):
        if isinstance(value, tuple) and len(value) == 2:
            f, l = value
            return (self.feature(f),
                    self.label(l) if self.label is not None else l)
        return self.feature(value)

    def map_arrays(self, xs: Sequence[np.ndarray],
                   y: Optional[np.ndarray]
                   ) -> Tuple[List[np.ndarray], Optional[np.ndarray]]:
        """Whole-column application (the vectorised path nnframes uses)."""
        fx = [np.stack([self.feature(row) for row in x])
              if not isinstance(self.feature, (ArrayToTensor, ToFloat32))
              else self.feature(x) for x in xs]
        fy = y
        if y is not None and self.label is not None:
            fy = self.label(y)
        return fx, fy
