"""Normalization layers.  ``LayerNorm`` only: the JAX package's
BatchNormalization (and its ghost-batch variant), LRN2D and
WithinChannelLRN2D come with the image slice."""

from __future__ import annotations

import torch

from analytics_zoo_tpu_torch.nn.module import Layer


class LayerNorm(Layer):
    """Layer normalization over the last axis (used by the Transformer and
    BERT layers): ``(x - mean) * rsqrt(var + epsilon) * gamma + beta`` with
    the biased variance; leaves ``gamma`` (ones) and ``beta`` (zeros)."""

    def __init__(self, epsilon: float = 1e-5, **kw):
        super().__init__(**kw)
        self.epsilon = epsilon

    def build(self, generator, input_shape):
        d = input_shape[-1]
        self.set_leaf("gamma", torch.ones((d,), dtype=torch.float32))
        self.set_leaf("beta", torch.zeros((d,), dtype=torch.float32))

    def forward(self, x):
        mean = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, unbiased=False, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.epsilon)
        return y * self.leaf("gamma") + self.leaf("beta")
