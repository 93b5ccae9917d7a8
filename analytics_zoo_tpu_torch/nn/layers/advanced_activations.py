"""Parametric / advanced activation layers and noise layers (the JAX
package's ``nn/layers/advanced_activations.py``; reference
api/keras/layers/{LeakyReLU,ELU,PReLU,SReLU,ThresholdedReLU,
GaussianNoise,GaussianDropout,SpatialDropout1D/2D/3D}.scala).

All elementwise.  The noise layers draw from ``generator``, an explicit
``torch.Generator`` on the input's device that the Estimator installs for
the length of ``fit``, as it does for ``Dropout``; training without one
raises, as the JAX layers do without an rng (``RReLU`` then takes its
mean slope, as the JAX layer does).  The draws follow the JAX layers' law,
not ``jax.random``'s bits.
"""

from __future__ import annotations

from typing import Optional

import torch

from analytics_zoo_tpu_torch.nn.module import Layer, StatelessLayer


class _Elementwise(StatelessLayer):
    """The output has the input's shape."""

    output_shape = Layer.output_shape


class LeakyReLU(_Elementwise):
    def __init__(self, alpha: float = 0.3, **kw):
        super().__init__(**kw)
        self.alpha = alpha

    def forward(self, x):
        return torch.where(x >= 0, x, self.alpha * x)


class ELU(_Elementwise):
    def __init__(self, alpha: float = 1.0, **kw):
        super().__init__(**kw)
        self.alpha = alpha

    def forward(self, x):
        return torch.where(x >= 0, x, self.alpha * (torch.exp(x) - 1.0))


class ThresholdedReLU(_Elementwise):
    def __init__(self, theta: float = 1.0, **kw):
        super().__init__(**kw)
        self.theta = theta

    def forward(self, x):
        return torch.where(x > self.theta, x, torch.zeros_like(x))


class PReLU(_Elementwise):
    """ReLU with a learned per-element negative slope, leaf ``alpha`` of
    the input's shape without the batch dim (reference
    api/keras/layers/PReLU.scala)."""

    def build(self, generator, input_shape):
        self.set_leaf("alpha", torch.zeros(tuple(input_shape[1:])))

    def forward(self, x):
        return torch.where(x >= 0, x, self.leaf("alpha") * x)


class SReLU(_Elementwise):
    """S-shaped ReLU with four learned per-element leaves (reference
    api/keras/layers/SReLU.scala; Jin et al. 2016)::

        y = t_r + a_r (x - t_r)   if x >= t_r
        y = x                     if t_l < x < t_r
        y = t_l + a_l (x - t_l)   if x <= t_l
    """

    def build(self, generator, input_shape):
        shape = tuple(input_shape[1:])
        self.set_leaf("t_left", torch.zeros(shape))
        self.set_leaf("a_left", torch.zeros(shape))
        self.set_leaf("t_right", torch.ones(shape))
        self.set_leaf("a_right", torch.ones(shape))

    def forward(self, x):
        tl, al = self.leaf("t_left"), self.leaf("a_left")
        tr, ar = self.leaf("t_right"), self.leaf("a_right")
        y_right = tr + ar * (x - tr)
        y_left = tl + al * (x - tl)
        return torch.where(x >= tr, y_right,
                           torch.where(x <= tl, y_left, x))


class _Noise(_Elementwise):
    """A layer that draws from the fit's generator in training."""

    draws_from_generator = True

    def __init__(self, **kw):
        super().__init__(**kw)
        self.generator: Optional[torch.Generator] = None

    def _generator(self) -> torch.Generator:
        if self.generator is None:
            raise ValueError(f"{type(self).__name__} {self.name} needs a "
                             "generator when training (the Estimator "
                             "installs one; call .eval() to run without "
                             "noise)")
        return self.generator


class GaussianNoise(_Noise):
    """Additive zero-mean Gaussian noise in training (reference
    api/keras/layers/GaussianNoise.scala)."""

    def __init__(self, sigma: float, **kw):
        super().__init__(**kw)
        self.sigma = sigma

    def forward(self, x):
        if not self.training:
            return x
        eps = torch.randn(x.shape, generator=self._generator(),
                          device=x.device, dtype=x.dtype)
        return x + self.sigma * eps


class GaussianDropout(_Noise):
    """Multiplicative 1-mean Gaussian noise (reference
    api/keras/layers/GaussianDropout.scala)."""

    def __init__(self, p: float, **kw):
        super().__init__(**kw)
        self.rate = p

    def forward(self, x):
        if not self.training or self.rate <= 0:
            return x
        stddev = (self.rate / (1.0 - self.rate)) ** 0.5
        eps = torch.randn(x.shape, generator=self._generator(),
                          device=x.device, dtype=x.dtype)
        return x * (1.0 + stddev * eps)


class SpatialDropoutND(_Noise):
    """Drop whole feature maps: one keep draw per (sample, channel),
    channels last (``dim_ordering="tf"``) or at axis 1 (``"th"``)."""

    spatial = 2

    def __init__(self, p: float = 0.5, dim_ordering: str = "tf", **kw):
        super().__init__(**kw)
        self.rate = p
        self.dim_ordering = dim_ordering

    def forward(self, x):
        if not self.training or self.rate <= 0:
            return x
        keep = 1.0 - self.rate
        ch_axis = 1 if self.dim_ordering == "th" else x.ndim - 1
        shape = [x.shape[0]] + [1] * (x.ndim - 1)
        shape[ch_axis] = x.shape[ch_axis]
        mask = torch.rand(shape, generator=self._generator(),
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class SpatialDropout1D(SpatialDropoutND):
    spatial = 1


class SpatialDropout2D(SpatialDropoutND):
    spatial = 2


class SpatialDropout3D(SpatialDropoutND):
    spatial = 3


class RReLU(_Noise):
    """Randomized leaky ReLU: the negative slope ~ U[lower, upper] per
    element in training (with a generator), the mean slope otherwise."""

    def __init__(self, lower: float = 1.0 / 8, upper: float = 1.0 / 3,
                 **kw):
        super().__init__(**kw)
        self.lower = lower
        self.upper = upper

    def forward(self, x):
        if self.training and self.generator is not None:
            u = torch.rand(x.shape, generator=self.generator,
                           device=x.device, dtype=x.dtype)
            a = self.lower + (self.upper - self.lower) * u
        else:
            a = (self.lower + self.upper) / 2.0
        return torch.where(x >= 0, x, a * x)
