"""Embedding layers: dense gather tables, leaf ``table`` (vocab, dim),
and ``SparseDense`` over multi-hot rows.

Every table lookup goes through ``ops/embedding_bag.py`` — the fused CUDA
kernels (forward, and the backward when the table trains) for a CUDA
tensor, the plain version on the CPU.  ``SparseDense`` is a gather of its
kernel's rows and a weighted sum, as the JAX layer computes it outside
any Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from analytics_zoo_tpu_torch.nn import activations, initializers
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


class WordEmbedding(Embedding):
    """Pretrained word embeddings, frozen unless ``trainable`` (reference
    WordEmbedding.scala).  ``WordEmbedding.from_glove(path, word_index)``
    loads a GloVe text file filtered to a vocabulary."""

    def __init__(self, input_dim: int, output_dim: int,
                 weights: Optional[np.ndarray] = None,
                 trainable: bool = False, **kw):
        super().__init__(input_dim, output_dim, weights=weights,
                         trainable=trainable, **kw)

    @staticmethod
    def from_glove(path: str, word_index: dict, trainable: bool = False,
                   **kw) -> "WordEmbedding":
        """A table of ``max(word_index.values()) + 1`` rows, its width the
        file's: the vectors of the vocabulary's words, zeros for the rest
        (row 0, the pad and unknown word, among them).  Raises when no
        vocabulary word is in the file."""
        dim = None
        vectors = {}
        with open(path, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip().split(" ")
                word = parts[0]
                if word in word_index:
                    vec = np.asarray(parts[1:], dtype=np.float32)
                    dim = len(vec)
                    vectors[word] = vec
        if dim is None:
            raise ValueError(f"no vocabulary words found in {path}")
        n = max(word_index.values()) + 1
        table = np.zeros((n, dim), dtype=np.float32)
        for word, idx in word_index.items():
            if word in vectors:
                table[idx] = vectors[word]
        return WordEmbedding(n, dim, weights=table, trainable=trainable, **kw)


class SparseEmbedding(Layer):
    """Embedding over sparse multi-hot id rows (reference
    api/keras/layers/SparseEmbedding.scala): ``(B, max_nnz)`` ids padded
    with ``pad_id`` (row ``pad_id`` of the table is zeroed at build) ->
    ``(B, dim)``, combined by ``combiner`` (sum|mean|sqrtn over the ids
    that are not ``pad_id``)."""

    def __init__(self, input_dim: int, output_dim: int,
                 combiner: str = "sum", init="uniform", pad_id: int = 0,
                 **kw):
        super().__init__(**kw)
        if combiner not in COMBINERS:
            raise ValueError(f"combiner must be sum|mean|sqrtn, got "
                             f"{combiner!r}")
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.combiner = combiner
        self.initializer = initializers.get(init)
        self.pad_id = pad_id

    def build(self, generator, input_shape):
        table = self.initializer(generator,
                                 (self.input_dim, self.output_dim))
        table[self.pad_id] = 0.0
        self.set_leaf("table", table)

    def output_shape(self, input_shape):
        return (input_shape[0], self.output_dim)

    def forward(self, x):
        from analytics_zoo_tpu_torch.ops.embedding_bag import embedding_bag

        return embedding_bag(self.leaf("table"), x.to(torch.int32),
                             self.combiner, self.pad_id)


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


class SparseDense(Layer):
    """Dense layer over sparse multi-hot inputs (reference
    api/keras/layers/SparseDense.scala: ``y = act(sparse_x W + b)``).

    Input: ``(B, max_nnz)`` feature indices padded with ``pad_id``,
    optionally with ``(B, max_nnz)`` float values for weighted rows.
    Leaves ``kernel`` (input_dim, output_dim) and ``bias``.  A gather of
    the kernel's rows and a masked, weighted sum over them.
    """

    def __init__(self, output_dim: int, input_dim: int,
                 activation=None, init="glorot_uniform", bias: bool = True,
                 pad_id: int = 0, **kw):
        super().__init__(**kw)
        self.output_dim = output_dim
        self.input_dim = input_dim
        self.activation = activations.get(activation)
        self.initializer = initializers.get(init)
        self.use_bias = bias
        self.pad_id = pad_id

    def build(self, generator, *input_shapes):
        self.set_leaf("kernel", self.initializer(
            generator, (self.input_dim, self.output_dim)))
        if self.use_bias:
            self.set_leaf("bias", torch.zeros((self.output_dim,)))

    def output_shape(self, indices_shape, *rest):
        return (indices_shape[0], self.output_dim)

    def forward(self, indices, values=None):
        ids = indices.to(torch.int32)
        mask = (ids != self.pad_id).to(torch.float32)
        w = self.leaf("kernel")[ids.long()]          # (B, nnz, out)
        coeff = mask if values is None else mask * values
        y = torch.sum(w * coeff[..., None], dim=-2)
        if self.use_bias:
            y = y + self.leaf("bias")
        if self.activation is not None:
            y = self.activation(y)
        return y
