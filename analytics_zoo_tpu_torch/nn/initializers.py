"""Weight initializers (Keras-name compatible).

Each takes an explicit ``torch.Generator``, a shape and a dtype and
returns a CPU tensor.  The distributions are the JAX package's
(``jax.nn.initializers``): the same names give the same laws, not the
same numbers — tests that compare the packages copy weights across.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Union

import torch

Initializer = Callable[..., torch.Tensor]

# std of a standard normal truncated to [-2, 2]: jax's variance_scaling
# divides by it so the truncated draw keeps the target variance
_TRUNC_STD = 0.87962566103423978


def _fans(shape: Sequence[int]):
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def _variance_scaling(scale: float, mode: str, distribution: str):
    def init(generator, shape, dtype=torch.float32):
        fan_in, fan_out = _fans(shape)
        denom = {"fan_in": fan_in, "fan_out": fan_out,
                 "fan_avg": (fan_in + fan_out) / 2.0}[mode]
        variance = scale / max(1.0, denom)
        out = torch.empty(tuple(shape), dtype=torch.float32)
        if distribution == "uniform":
            lim = math.sqrt(3.0 * variance)
            out.uniform_(-lim, lim, generator=generator)
        elif distribution == "truncated_normal":
            std = math.sqrt(variance) / _TRUNC_STD
            torch.nn.init.trunc_normal_(out, 0.0, std, -2.0 * std,
                                        2.0 * std, generator=generator)
        else:
            out.normal_(0.0, math.sqrt(variance), generator=generator)
        return out.to(dtype)
    return init


def _constant(value: float):
    def init(generator, shape, dtype=torch.float32):
        return torch.full(tuple(shape), value, dtype=dtype)
    return init


def _normal(stddev: float):
    def init(generator, shape, dtype=torch.float32):
        out = torch.empty(tuple(shape), dtype=torch.float32)
        return out.normal_(0.0, stddev, generator=generator).to(dtype)
    return init


def _uniform(scale: float):
    """U[0, scale) — jax.nn.initializers.uniform's law."""
    def init(generator, shape, dtype=torch.float32):
        out = torch.empty(tuple(shape), dtype=torch.float32)
        return out.uniform_(0.0, scale, generator=generator).to(dtype)
    return init


_REGISTRY = {
    "glorot_uniform": _variance_scaling(1.0, "fan_avg", "uniform"),
    "glorot_normal": _variance_scaling(1.0, "fan_avg", "truncated_normal"),
    "xavier": _variance_scaling(1.0, "fan_avg", "uniform"),
    "he_uniform": _variance_scaling(2.0, "fan_in", "uniform"),
    "he_normal": _variance_scaling(2.0, "fan_in", "truncated_normal"),
    "lecun_uniform": _variance_scaling(1.0, "fan_in", "uniform"),
    "lecun_normal": _variance_scaling(1.0, "fan_in", "truncated_normal"),
    "zero": _constant(0.0),
    "zeros": _constant(0.0),
    "one": _constant(1.0),
    "ones": _constant(1.0),
    "normal": _normal(0.05),
    "uniform": _uniform(0.05),
}


def get(init: Union[str, Initializer]) -> Initializer:
    if callable(init):
        return init
    key = init.lower()
    if key not in _REGISTRY:
        raise ValueError(f"unknown initializer {init!r}; "
                         f"known: {sorted(_REGISTRY)}")
    return _REGISTRY[key]
