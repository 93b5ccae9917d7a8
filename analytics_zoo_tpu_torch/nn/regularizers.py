"""Weight regularizers — L1/L2 penalties for a layer's ``w_regularizer`` /
``b_regularizer`` (the JAX package's ``nn/regularizers.py``).

A regularizer is ``fn(weights) -> scalar tensor``; these classes are the
named spellings.  ``KerasNet.regularization_loss`` sums them over the
layers and the Estimator adds the sum to the training objective.
"""

from __future__ import annotations

import torch


class Regularizer:
    def __call__(self, w):
        raise NotImplementedError


class L1(Regularizer):
    def __init__(self, l1: float = 0.01):
        self.l1 = float(l1)

    def __call__(self, w):
        return self.l1 * torch.sum(torch.abs(w))

    def __repr__(self):
        return f"L1(l1={self.l1})"


class L2(Regularizer):
    def __init__(self, l2: float = 0.01):
        self.l2 = float(l2)

    def __call__(self, w):
        return self.l2 * torch.sum(torch.square(w))

    def __repr__(self):
        return f"L2(l2={self.l2})"


class L1L2(Regularizer):
    def __init__(self, l1: float = 0.01, l2: float = 0.01):
        self.l1 = float(l1)
        self.l2 = float(l2)

    def __call__(self, w):
        return (self.l1 * torch.sum(torch.abs(w))
                + self.l2 * torch.sum(torch.square(w)))

    def __repr__(self):
        return f"L1L2(l1={self.l1}, l2={self.l2})"


def get(spec):
    """Lower a spec to a regularizer: None | callable | "l1" | "l2" |
    "l1l2" (Keras-style string lowering)."""
    if spec is None or callable(spec):
        return spec
    name = str(spec).lower()
    if name == "l1":
        return L1()
    if name == "l2":
        return L2()
    if name in ("l1l2", "l1_l2"):
        return L1L2()
    raise ValueError(f"unknown regularizer {spec!r}; known: l1, l2, l1l2")
