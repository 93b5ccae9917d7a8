"""Embedding layers: dense gather tables, leaf ``table`` (vocab, dim).

Every lookup goes through ``ops/embedding_bag.py`` — the fused CUDA
kernel for a CUDA tensor, the plain version on the CPU.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from analytics_zoo_tpu_torch.nn import initializers
from analytics_zoo_tpu_torch.nn.module import Layer

COMBINERS = ("sum", "mean", "sqrtn")


def _table(layer, generator, dtype=torch.float32):
    if layer.pretrained is not None:
        table = torch.as_tensor(np.asarray(layer.pretrained), dtype=dtype)
        if tuple(table.shape) != (layer.input_dim, layer.output_dim):
            raise ValueError(
                f"pretrained weights {tuple(table.shape)} != "
                f"({layer.input_dim}, {layer.output_dim})")
        return table.clone()
    return layer.initializer(generator, (layer.input_dim, layer.output_dim),
                             dtype)


class Embedding(Layer):
    """Integer ids -> dense vectors. Input (B, ...) int -> (B, ..., dim)."""

    def __init__(self, input_dim: int, output_dim: int, init="uniform",
                 trainable: bool = True,
                 weights: Optional[np.ndarray] = None,
                 zero_based: bool = True, dtype=torch.float32, **kw):
        super().__init__(**kw)
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.initializer = initializers.get(init)
        self.trainable = trainable
        self.pretrained = weights
        # the reference's Embedding is 1-based (Lua heritage); default
        # here is 0-based, with an opt-in shift for API parity
        self.zero_based = zero_based
        self.dtype = dtype

    def build(self, generator, input_shape):
        self.set_leaf("table", _table(self, generator, self.dtype))

    def output_shape(self, input_shape):
        return tuple(input_shape) + (self.output_dim,)

    def forward(self, ids):
        from analytics_zoo_tpu_torch.ops.embedding_bag import embedding_gather

        table = self.leaf("table")
        if not self.trainable:
            table = table.detach()
        ids = ids.to(torch.int32)
        if not self.zero_based:
            ids = ids - 1
        return embedding_gather(table, ids)


class EmbeddingBag(Layer):
    """Dense multi-hot lookup + combine in one layer: ``(B, n_ids)`` int
    input -> ``(B, dim)``, ``combine_j table[ids[b, j]]``.  ``pad_id=None``
    (default) counts every slot; a ``pad_id`` masks ragged bags padded to
    fixed width (its table row is zeroed at build)."""

    def __init__(self, input_dim: int, output_dim: int,
                 combiner: str = "sum", init="uniform",
                 pad_id: Optional[int] = None, trainable: bool = True,
                 weights: Optional[np.ndarray] = None,
                 zero_based: bool = True, **kw):
        super().__init__(**kw)
        if combiner not in COMBINERS:
            raise ValueError(f"combiner must be sum|mean|sqrtn, got "
                             f"{combiner!r}")
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.combiner = combiner
        self.initializer = initializers.get(init)
        self.pad_id = pad_id
        self.trainable = trainable
        self.pretrained = weights
        self.zero_based = zero_based

    def build(self, generator, input_shape):
        table = _table(self, generator)
        if self.pad_id is not None:
            table[self.pad_id] = 0.0
        self.set_leaf("table", table)

    def output_shape(self, input_shape):
        return (input_shape[0], self.output_dim)

    def forward(self, x):
        from analytics_zoo_tpu_torch.ops.embedding_bag import embedding_bag

        table = self.leaf("table")
        if not self.trainable:
            table = table.detach()
        ids = x.to(torch.int32)
        if not self.zero_based:
            ids = ids - 1
        return embedding_bag(table, ids, self.combiner, self.pad_id)
