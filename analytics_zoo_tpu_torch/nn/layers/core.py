"""Core layers: Dense, Dropout, Flatten, Activation.

Shape-polymorphic over leading dims: Dense acts on the last axis, so the
same layer works for 2-D and sequence inputs.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from analytics_zoo_tpu_torch.nn import activations, initializers
from analytics_zoo_tpu_torch.nn import regularizers as _reg
from analytics_zoo_tpu_torch.nn.module import Layer


class Dense(Layer):
    """Fully connected layer: ``y = act(x @ W + b)``; leaves ``kernel``
    (in, out) and ``bias`` (out,).  ``w_regularizer`` / ``b_regularizer``
    (``nn.regularizers``) add their penalty to the training objective
    through ``regularization_loss``."""

    def __init__(self, output_dim: int, activation=None,
                 use_bias: bool = True, init="glorot_uniform",
                 w_regularizer=None, b_regularizer=None,
                 dtype=torch.float32, **kw):
        super().__init__(**kw)
        self.output_dim = output_dim
        self.activation = activations.get(activation)
        self.use_bias = use_bias
        self.initializer = initializers.get(init)
        self.w_regularizer = _reg.get(w_regularizer)
        self.b_regularizer = _reg.get(b_regularizer)
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
            w = self.leaf("kernel")
            if w.dtype != x.dtype:
                # jnp's promotion: an f32 input (a recurrent layer's f32
                # carry under bf16 compute) meets a bf16 kernel at f32
                dt = torch.promote_types(x.dtype, w.dtype)
                x, w = x.to(dt), w.to(dt)
            y = torch.matmul(x, w)
        if self.use_bias:
            y = y + self.leaf("bias")
        if self.activation is not None:
            y = self.activation(y)
        return y

    def regularization_loss(self):
        """This layer's weight penalty (0.0 without regularizers)."""
        loss = 0.0
        if self.w_regularizer is not None:
            loss = loss + self.w_regularizer(self.leaf("kernel"))
        if self.b_regularizer is not None and self.use_bias:
            loss = loss + self.b_regularizer(self.leaf("bias"))
        return loss


class Activation(Layer):
    def __init__(self, activation, **kw):
        super().__init__(**kw)
        self.activation = activations.get(activation)

    def forward(self, x):
        return self.activation(x)


class Dropout(Layer):
    """Inverted dropout in training mode; identity at inference.

    The keep-mask is drawn from ``generator``, an explicit
    ``torch.Generator`` on the input's device: the Estimator installs one
    for the length of ``fit``, seeded from ``ZooConfig.seed``, so a run
    with dropout replays from its seed.  Training without one raises, as
    the JAX layer does without an rng.  The masks follow the JAX layer's
    law (keep with probability ``1 - p``, kept values scaled by
    ``1 / (1 - p)``) but are not ``jax.random``'s bits.
    """

    def __init__(self, p: float, **kw):
        super().__init__(**kw)
        self.rate = float(p)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if not self.training or self.rate <= 0.0:
            return x
        if self.generator is None:
            raise ValueError(f"Dropout {self.name} needs a generator when "
                             "training (the Estimator installs one; call "
                             ".eval() to run without dropout)")
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class Flatten(Layer):
    """Flatten all dims after the batch dim."""

    def output_shape(self, input_shape):
        return (input_shape[0], math.prod(input_shape[1:]))

    def forward(self, x):
        return x.reshape(x.shape[0], -1)
