"""Payload distributions: what each scheduled arrival actually sends.

A :class:`PayloadClass` is one (model, tensor shape, dtype, TTL)
flavor; a :class:`PayloadMix` weights several classes and draws one
per arrival.  Weights may shift over the run (``shift_at_s`` /
``shift_weights``) — the two-model shifting mix the autoscale soak
drives is "balanced, then 80/20 onto the laggy model", expressed as
one mix.

:func:`saturated_images` is the JAX package's saturated-image draw, kept
byte for byte, so an image leg offers the same arrays in both packages.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["PayloadClass", "PayloadMix", "ZipfianIdPayload",
           "saturated_images"]


class PayloadClass:
    """One request flavor: tensor spec + routing + deadline."""

    def __init__(self, model: str, shape: Tuple[int, ...],
                 dtype: str = "float32", weight: float = 1.0,
                 field: str = "x", ttl_ms: Optional[float] = None,
                 low: float = 0.0, high: float = 1.0):
        if weight < 0:
            raise ValueError(f"weight must be >= 0, got {weight}")
        self.model = str(model)
        self.shape = tuple(int(d) for d in shape)
        self.dtype = np.dtype(dtype)
        self.weight = float(weight)
        self.field = str(field)
        self.ttl_ms = None if ttl_ms is None else float(ttl_ms)
        self.low = float(low)
        self.high = float(high)

    def draw(self, rng: np.random.Generator) -> np.ndarray:
        """One fresh array (distinct per request — identical payloads
        can be memoized downstream and would measure a cache)."""
        if self.dtype.kind in "ui":
            return rng.integers(int(self.low), max(int(self.high), 2),
                                size=self.shape).astype(self.dtype)
        a = rng.uniform(self.low, self.high, size=self.shape)
        return a.astype(self.dtype)

    def __repr__(self) -> str:
        return (f"PayloadClass(model={self.model!r}, shape={self.shape}, "
                f"dtype={self.dtype.name}, weight={self.weight})")


class ZipfianIdPayload(PayloadClass):
    """Skewed recommender id traffic: each request's id block draws
    zipf(s) over ``vocab`` through ``data/zipf.py::zipfian_ids``, whose
    ids are byte-identical to the JAX package's for the same generator
    state, so both packages' harnesses offer the same skewed traffic."""

    def __init__(self, model: str, shape: Tuple[int, ...], vocab: int,
                 s: float = 1.0, dtype: str = "int32",
                 weight: float = 1.0, field: str = "ids",
                 ttl_ms: Optional[float] = None):
        super().__init__(model, shape, dtype=dtype, weight=weight,
                         field=field, ttl_ms=ttl_ms, low=0.0,
                         high=float(vocab))
        if vocab <= 0:
            raise ValueError(f"vocab must be positive, got {vocab}")
        self.vocab = int(vocab)
        self.s = float(s)

    def draw(self, rng: np.random.Generator) -> np.ndarray:
        from analytics_zoo_tpu_torch.data.zipf import zipfian_ids

        n = int(np.prod(self.shape)) if self.shape else 1
        ids = zipfian_ids(self.vocab, n, self.s, rng=rng)
        return ids.reshape(self.shape).astype(self.dtype)

    def __repr__(self) -> str:
        return (f"ZipfianIdPayload(model={self.model!r}, "
                f"shape={self.shape}, vocab={self.vocab}, s={self.s})")


class PayloadMix:
    """Weighted mixture over payload classes, optionally time-varying.

    ``shift_at_s``/``shift_weights`` swap the per-class weights once at
    a run offset — the "two-model shifting mix" leg.  ``weights(t)``
    is pure; ``draw(rng, t)`` consumes exactly two draws from ``rng``
    per call (class pick + payload), so a mix driven by a seeded
    generator is deterministic from ``(seed, arrival index)``.
    """

    def __init__(self, classes: Sequence[PayloadClass],
                 shift_at_s: Optional[float] = None,
                 shift_weights: Optional[Sequence[float]] = None):
        if not classes:
            raise ValueError("PayloadMix needs at least one PayloadClass")
        self.classes = list(classes)
        if (shift_at_s is None) != (shift_weights is None):
            raise ValueError(
                "shift_at_s and shift_weights come together or not at all")
        if shift_weights is not None \
                and len(shift_weights) != len(self.classes):
            raise ValueError(
                f"shift_weights has {len(shift_weights)} entries for "
                f"{len(self.classes)} classes")
        self.shift_at_s = None if shift_at_s is None else float(shift_at_s)
        self.shift_weights = (None if shift_weights is None
                              else [float(w) for w in shift_weights])

    def models(self) -> List[str]:
        seen: List[str] = []
        for c in self.classes:
            if c.model not in seen:
                seen.append(c.model)
        return seen

    def weights(self, t: float = 0.0) -> np.ndarray:
        """Normalized class weights at run offset ``t``."""
        if self.shift_at_s is not None and t >= self.shift_at_s:
            w = np.asarray(self.shift_weights, dtype=np.float64)
        else:
            w = np.asarray([c.weight for c in self.classes],
                           dtype=np.float64)
        tot = w.sum()
        if tot <= 0:
            raise ValueError(f"mix weights sum to {tot} at t={t}")
        return w / tot

    def draw(self, rng: np.random.Generator,
             t: float = 0.0) -> Tuple[PayloadClass, np.ndarray]:
        """One (class, payload) pair for an arrival at offset ``t``."""
        idx = int(rng.choice(len(self.classes), p=self.weights(t)))
        cls = self.classes[idx]
        return cls, cls.draw(rng)

    def model_weights(self, t: float = 0.0) -> Dict[str, float]:
        """Per-model offered fraction at ``t`` (classes summed)."""
        w = self.weights(t)
        out: Dict[str, float] = {}
        for cls, wi in zip(self.classes, w):
            out[cls.model] = out.get(cls.model, 0.0) + float(wi)
        return out


def saturated_images(n: int, rs=None, seed: int = 0,
                     shape: Tuple[int, ...] = (224, 224, 3)
                     ) -> List[np.ndarray]:
    """``n`` distinct uint8 images for a saturated offered-load leg.

    The JAX package's draw, byte for byte.  Accepts an existing
    ``np.random.RandomState`` (``rs``) so callers that interleave other
    draws on the same stream keep their historical sequences; without
    one, a fresh ``RandomState(seed)`` makes the leg self-contained.
    """
    if rs is None:
        rs = np.random.RandomState(seed)
    return [rs.randint(0, 256, shape).astype(np.uint8) for _ in range(n)]
