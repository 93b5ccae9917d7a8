"""Normalization layers: ``BatchNormalization`` (and its ghost-batch
form), ``LayerNorm``, and the local response normalizations ``LRN2D``
(across channels) and ``WithinChannelLRN2D`` (over a spatial window)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.nn.module import Layer


class BatchNormalization(Layer):
    """Batch normalization over the channel axis, the JAX package's
    layer: leaves ``gamma`` (ones, when ``scale``) and ``beta`` (zeros,
    when ``center``), state ``moving_mean`` (zeros) and ``moving_var``
    (ones).  ``axis`` is -1 (channels last) unless ``dim_ordering="th"``,
    which takes axis 1.

    Training normalizes with the batch's mean and biased variance and
    hands ``moving = momentum * moving + (1 - momentum) * batch`` (Keras's
    convention; the moving variance is the biased batch variance) to
    ``update_state``; evaluation normalizes with the moving statistics.
    ``stats_fraction < 1`` (ghost-BN) takes the training statistics over
    the leading ``ceil(fraction * B)`` rows and normalizes every row.

    ``F.batch_norm`` normalizes (with f32 gamma, beta and statistics,
    whatever the input's dtype) and hands back the batch statistics in
    two f32 buffers it fills with ``momentum=1``: the mean, and the
    unbiased variance, scaled back to the biased one here.  Its own
    running-statistics rule (the unbiased variance, the opposite
    momentum) is not used.  Under bf16 compute the state reaches the
    layer cast to bf16, as in the JAX package, and the Estimator casts
    the new values back to f32.  A ghost-BN batch takes its statistics
    through ``var_mean`` on the slice, differentiated through, and
    normalizes with plain ops."""

    def __init__(self, epsilon: float = 1e-3, momentum: float = 0.99,
                 beta_init="zero", gamma_init="one", axis: int = -1,
                 dim_ordering: str = "tf", scale: bool = True,
                 center: bool = True, stats_fraction: float = 1.0, **kw):
        super().__init__(**kw)
        self.epsilon = epsilon
        self.momentum = momentum
        self.axis = 1 if dim_ordering == "th" else axis
        self.scale = scale
        self.center = center
        if not 0.0 < stats_fraction <= 1.0:
            raise ValueError(
                f"stats_fraction must be in (0, 1], got {stats_fraction}")
        self.stats_fraction = float(stats_fraction)

    def build(self, generator, input_shape):
        d = input_shape[self.axis]
        if self.scale:
            self.set_leaf("gamma", torch.ones((d,), dtype=torch.float32))
        if self.center:
            self.set_leaf("beta", torch.zeros((d,), dtype=torch.float32))
        self.set_state("moving_mean", torch.zeros((d,), dtype=torch.float32))
        self.set_state("moving_var", torch.ones((d,), dtype=torch.float32))

    def _affine(self):
        gamma = self.leaf("gamma").float() if self.scale else None
        beta = self.leaf("beta").float() if self.center else None
        return gamma, beta

    def forward(self, x):
        axis = self.axis % x.ndim
        # channels on dim 1, as F.batch_norm takes them: a view (an NHWC
        # tensor becomes NCHW in channels-last memory)
        xc = x.movedim(axis, 1) if axis != 1 else x
        gamma, beta = self._affine()
        c = x.shape[axis]
        n = x.numel() // max(c, 1)
        ghost = self.stats_fraction < 1.0 and x.shape[0] > 1
        if not self.training:
            y = F.batch_norm(xc, self.state_leaf("moving_mean").float(),
                             self.state_leaf("moving_var").float(),
                             gamma, beta, False, 0.0, self.epsilon)
        elif ghost or n < 2:
            rows = max(1, int(math.ceil(x.shape[0] * self.stats_fraction)))
            xs = xc[:rows] if ghost else xc
            # statistics of a slice normalize every row: differentiated
            # through, as the JAX layer is
            var, mean = torch.var_mean(xs.float(), dim=[
                d for d in range(x.ndim) if d != 1], correction=0)
            shape = [1] * x.ndim
            shape[1] = c
            inv = torch.rsqrt(var + self.epsilon)
            if gamma is not None:
                inv = inv * gamma
            y = (xc - mean.reshape(shape)) * inv.reshape(shape)
            if beta is not None:
                y = y + beta.reshape(shape)
            y = y.to(x.dtype)
        else:
            mean = torch.zeros(c, dtype=torch.float32, device=x.device)
            var = torch.zeros(c, dtype=torch.float32, device=x.device)
            y = F.batch_norm(xc, mean, var, gamma, beta, True, 1.0,
                             self.epsilon)
            var = var * ((n - 1) / n)
        if self.training:
            m = self.momentum
            mean, var = mean.detach(), var.detach()
            self.update_state("moving_mean", m * self.state_leaf(
                "moving_mean") + (1 - m) * mean)
            self.update_state("moving_var", m * self.state_leaf(
                "moving_var") + (1 - m) * var)
        return y.movedim(1, axis) if axis != 1 else y


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


class LRN2D(Layer):
    """Local response normalization across channels (AlexNet's):
    ``x / (k + alpha / n * sum(x^2 over n neighbouring channels))^beta``,
    the window padded ``(n // 2, n - 1 - n // 2)`` along the channel axis
    (1 when ``dim_ordering="th"``, else the last)."""

    def __init__(self, alpha: float = 1e-4, k: float = 1.0,
                 beta: float = 0.75, n: int = 5, dim_ordering: str = "tf",
                 **kw):
        super().__init__(**kw)
        self.alpha, self.k, self.beta, self.n = alpha, k, beta, n
        self.dim_ordering = dim_ordering

    def forward(self, x):
        axis = 1 if self.dim_ordering == "th" else x.ndim - 1
        sq = torch.square(x).movedim(axis, -1)
        half = self.n // 2
        padded = F.pad(sq, (half, self.n - 1 - half))
        c = x.shape[axis]
        summed = padded[..., 0:c]
        for i in range(1, self.n):
            summed = summed + padded[..., i:i + c]
        denom = torch.pow(self.k + self.alpha / self.n * summed, self.beta)
        return x / denom.movedim(-1, axis)


class WithinChannelLRN2D(Layer):
    """Local response normalization within each channel over a ``size``
    x ``size`` spatial window (SAME: the window padded with zeros, the
    smaller half before): ``x / (1 + alpha / size^2 * sum(x^2))^beta``.
    Channels-last (NHWC) always, as the JAX layer is."""

    def __init__(self, size: int = 5, alpha: float = 1.0,
                 beta: float = 0.75, **kw):
        super().__init__(**kw)
        self.size, self.alpha, self.beta = size, alpha, beta

    def forward(self, x):
        n = self.size
        sq = torch.square(x).movedim(-1, 1)
        lo = (n - 1) // 2
        padded = F.pad(sq, (lo, n - 1 - lo, lo, n - 1 - lo))
        h, w = sq.shape[2:]
        summed = None
        for i in range(n):
            for j in range(n):
                win = padded[:, :, i:i + h, j:j + w]
                summed = win if summed is None else summed + win
        denom = torch.pow(1.0 + self.alpha / (n ** 2) * summed, self.beta)
        return x / denom.movedim(1, -1)
