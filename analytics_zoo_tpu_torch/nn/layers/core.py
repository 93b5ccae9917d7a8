"""Core layers: Dense, Dropout, Flatten, Activation.

Shape-polymorphic over leading dims: Dense acts on the last axis, so the
same layer works for 2-D and sequence inputs.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.nn import activations, initializers
from analytics_zoo_tpu_torch.nn.module import Layer


class Dense(Layer):
    """Fully connected layer: ``y = act(x @ W + b)``; leaves ``kernel``
    (in, out) and ``bias`` (out,)."""

    def __init__(self, output_dim: int, activation=None,
                 use_bias: bool = True, init="glorot_uniform",
                 dtype=torch.float32, **kw):
        super().__init__(**kw)
        self.output_dim = output_dim
        self.activation = activations.get(activation)
        self.use_bias = use_bias
        self.initializer = initializers.get(init)
        self.dtype = dtype

    def build(self, generator, input_shape):
        self.set_leaf("kernel", self.initializer(
            generator, (input_shape[-1], self.output_dim), self.dtype))
        if self.use_bias:
            self.set_leaf("bias", torch.zeros((self.output_dim,),
                                              dtype=self.dtype))

    def output_shape(self, input_shape):
        return tuple(input_shape[:-1]) + (self.output_dim,)

    def forward(self, x):
        q = self.qleaf("kernel")
        if q is not None:
            # quantized serving leaf: the dequantize runs inside the
            # matmul (the CUDA kernel for a CUDA tensor), so the f32
            # kernel never exists in device memory
            from analytics_zoo_tpu_torch.ops.dequant_matmul import (
                dequant_matmul)

            if "q4" in q:
                y = dequant_matmul(x, q["q4"], q["scale"], bits=4,
                                   rows=x.shape[-1])
            else:
                y = dequant_matmul(x, q["q"], q["scale"])
        else:
            y = torch.matmul(x, self.leaf("kernel"))
        if self.use_bias:
            y = y + self.leaf("bias")
        if self.activation is not None:
            y = self.activation(y)
        return y


class Activation(Layer):
    def __init__(self, activation, **kw):
        super().__init__(**kw)
        self.activation = activations.get(activation)

    def forward(self, x):
        return self.activation(x)


class Dropout(Layer):
    """Inverted dropout in training mode; identity at inference."""

    def __init__(self, p: float, **kw):
        super().__init__(**kw)
        self.rate = float(p)

    def forward(self, x):
        if not self.training or self.rate <= 0.0:
            return x
        return F.dropout(x, self.rate, training=True)


class Flatten(Layer):
    """Flatten all dims after the batch dim."""

    def output_shape(self, input_shape):
        return (input_shape[0], math.prod(input_shape[1:]))

    def forward(self, x):
        return x.reshape(x.shape[0], -1)
