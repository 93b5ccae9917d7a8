"""Core layers: Dense, Dropout, Flatten, Activation, Reshape, Permute,
RepeatVector, Masking, Lambda, InputLayer, MaxoutDense, GaussianSampler.

Shape-polymorphic over leading dims: Dense acts on the last axis, so the
same layer works for 2-D and sequence inputs.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

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

    draws_from_generator = True

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


class Reshape(Layer):
    """Reshape the dims after the batch dim to ``target_shape`` (one dim
    may be -1)."""

    def __init__(self, target_shape: Sequence[int], **kw):
        super().__init__(**kw)
        self.target_shape = tuple(target_shape)

    def output_shape(self, input_shape):
        shape = list(self.target_shape)
        if -1 in shape:
            known = math.prod(d for d in shape if d != -1)
            shape[shape.index(-1)] = math.prod(input_shape[1:]) // known
        return (input_shape[0],) + tuple(shape)

    def forward(self, x):
        return x.reshape((x.shape[0],) + self.target_shape)


class Permute(Layer):
    """Permute the dims after the batch dim; ``dims`` is 1-indexed, as in
    Keras."""

    def __init__(self, dims: Sequence[int], **kw):
        super().__init__(**kw)
        self.dims = tuple(dims)

    def output_shape(self, input_shape):
        return (input_shape[0],) + tuple(input_shape[d] for d in self.dims)

    def forward(self, x):
        return x.permute((0,) + self.dims)


class RepeatVector(Layer):
    """(B, F) -> (B, n, F)."""

    def __init__(self, n: int, **kw):
        super().__init__(**kw)
        self.n = n

    def output_shape(self, input_shape):
        return (input_shape[0], self.n) + tuple(input_shape[1:])

    def forward(self, x):
        return x[:, None, :].expand(x.shape[0], self.n, *x.shape[1:])


class Masking(Layer):
    """Zero the timesteps whose every feature equals ``mask_value``."""

    def __init__(self, mask_value: float = 0.0, **kw):
        super().__init__(**kw)
        self.mask_value = mask_value

    def forward(self, x):
        keep = torch.any(x != self.mask_value, dim=-1, keepdim=True)
        return torch.where(keep, x, torch.zeros_like(x))


class Lambda(Layer):
    """A torch function of one or more tensors as a layer (KNRM's kernel
    pooling takes two).  Its output shape comes from running ``fn`` on
    meta tensors of the input shapes.  A closure deep-copies but does not
    pickle: a model holding one saves by name and config
    (``ZooModel.save_model``)."""

    def __init__(self, fn: Callable, **kw):
        super().__init__(**kw)
        self.fn = fn

    def output_shape(self, *input_shapes):
        metas = [torch.empty(s, device="meta") for s in input_shapes]
        return tuple(self.fn(*metas).shape)

    def forward(self, *inputs):
        return self.fn(*inputs)


class InputLayer(Layer):
    """The identity (Keras's InputLayer)."""

    def forward(self, x):
        return x


class MaxoutDense(Layer):
    """Maxout over ``nb_feature`` linear pieces: ``y_j = max_k (x W_k +
    b_k)_j``, as one (in, nb_feature * out) matmul and a max; leaves
    ``kernel`` and ``bias``."""

    def __init__(self, output_dim: int, nb_feature: int = 4,
                 init="glorot_uniform", bias: bool = True, **kw):
        super().__init__(**kw)
        self.output_dim = output_dim
        self.nb_feature = nb_feature
        self.initializer = initializers.get(init)
        self.use_bias = bias

    def build(self, generator, input_shape):
        width = self.nb_feature * self.output_dim
        self.set_leaf("kernel", self.initializer(
            generator, (input_shape[-1], width)))
        if self.use_bias:
            self.set_leaf("bias", torch.zeros((width,), dtype=torch.float32))

    def output_shape(self, input_shape):
        return tuple(input_shape[:-1]) + (self.output_dim,)

    def forward(self, x):
        y = torch.matmul(x, self.leaf("kernel"))
        if self.use_bias:
            y = y + self.leaf("bias")
        y = y.reshape(y.shape[:-1] + (self.nb_feature, self.output_dim))
        return torch.amax(y, dim=-2)


class GaussianSampler(Layer):
    """Reparameterised sampling for VAEs: (mean, log_var) -> mean +
    exp(log_var / 2) * eps in training, the mean otherwise.  ``eps`` is
    drawn from ``generator`` (an explicit ``torch.Generator``, which the
    Estimator installs for ``fit`` as it does for ``Dropout``), not
    ``jax.random``'s bits."""

    draws_from_generator = True

    def __init__(self, **kw):
        super().__init__(**kw)
        self.generator: Optional[torch.Generator] = None

    def output_shape(self, mean_shape, log_var_shape=None):
        return tuple(mean_shape)

    def forward(self, mean, log_var=None):
        if log_var is None:         # one stacked input [mean, log_var]
            mean, log_var = mean
        if not self.training or self.generator is None:
            return mean
        eps = torch.randn(mean.shape, generator=self.generator,
                          device=mean.device, dtype=mean.dtype)
        return mean + torch.exp(log_var * 0.5) * eps
