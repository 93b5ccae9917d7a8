"""Activation registry (Keras-name compatible), the same functions as the
JAX package's ``nn/activations.py``; ``softmax`` and ``log_softmax`` act
on the last axis, ``gelu`` is the tanh approximation (``jax.nn.gelu``'s
default)."""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F

ActivationFn = Callable[[torch.Tensor], torch.Tensor]


def hard_sigmoid(x):
    """Keras-semantics hard sigmoid: clip(0.2x + 0.5, 0, 1)."""
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


_REGISTRY = {
    "relu": torch.relu,
    "relu6": F.relu6,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "hard_sigmoid": hard_sigmoid,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "log_softmax": lambda x: torch.log_softmax(x, dim=-1),
    "softplus": F.softplus,
    "softsign": F.softsign,
    "elu": F.elu,
    "selu": F.selu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "swish": F.silu,
    "silu": F.silu,
    "leaky_relu": F.leaky_relu,
    "exp": torch.exp,
    "linear": lambda x: x,
    "identity": lambda x: x,
}


def get(act: Union[str, ActivationFn, None]) -> Optional[ActivationFn]:
    if act is None:
        return None
    if callable(act):
        return act
    key = act.lower()
    if key not in _REGISTRY:
        raise ValueError(f"unknown activation {act!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[key]
