"""Merge layers over multiple inputs: concat, sum, mul, ave, max, min,
dot and cos, and the Keras-2 classes over them (the JAX package's
``nn/layers/merge.py``)."""

from __future__ import annotations

import torch

from analytics_zoo_tpu_torch.nn.module import StatelessLayer

MODES = ("concat", "sum", "mul", "ave", "average", "max", "min", "dot",
         "cos")


class Merge(StatelessLayer):
    """Merge a list of inputs. ``mode``: concat|sum|mul|ave|max|min|dot|cos
    (``dot`` and ``cos`` take two inputs and keep a last axis of 1)."""

    def __init__(self, mode: str = "sum", concat_axis: int = -1, **kw):
        super().__init__(**kw)
        self.mode = mode.lower()
        if self.mode not in MODES:
            raise ValueError(f"unknown merge mode {mode!r}; known: {MODES}")
        self.concat_axis = concat_axis

    def output_shape(self, *input_shapes):
        if self.mode in ("dot", "cos"):
            return tuple(input_shapes[0][:-1]) + (1,)
        if self.mode != "concat":
            return tuple(input_shapes[0])
        out = list(input_shapes[0])
        out[self.concat_axis] = sum(s[self.concat_axis] for s in input_shapes)
        return tuple(out)

    def forward(self, *inputs):
        m = self.mode
        if m == "concat":
            return torch.cat(inputs, dim=self.concat_axis)
        if m in ("dot", "cos"):
            a, b = inputs
            if m == "cos":
                a = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True)
                         + 1e-12)
                b = b / (torch.linalg.vector_norm(b, dim=-1, keepdim=True)
                         + 1e-12)
            return torch.sum(a * b, dim=-1, keepdim=True)
        step = {"sum": torch.add, "ave": torch.add, "average": torch.add,
                "mul": torch.mul, "max": torch.maximum,
                "min": torch.minimum}[m]
        out = inputs[0]
        for x in inputs[1:]:
            out = step(out, x)
        if m in ("ave", "average"):
            out = out / len(inputs)
        return out


def merge(inputs, mode="sum", concat_axis=-1, name=None):
    """Functional merge over autograd Variables."""
    return Merge(mode=mode, concat_axis=concat_axis, name=name)(*inputs)


class Concatenate(Merge):
    def __init__(self, axis: int = -1, **kw):
        super().__init__(mode="concat", concat_axis=axis, **kw)


class Add(Merge):
    def __init__(self, **kw):
        super().__init__(mode="sum", **kw)


class Multiply(Merge):
    def __init__(self, **kw):
        super().__init__(mode="mul", **kw)


class Average(Merge):
    def __init__(self, **kw):
        super().__init__(mode="ave", **kw)


class Maximum(Merge):
    def __init__(self, **kw):
        super().__init__(mode="max", **kw)


class Minimum(Merge):
    def __init__(self, **kw):
        super().__init__(mode="min", **kw)
