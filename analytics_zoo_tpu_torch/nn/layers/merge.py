"""Merge layers over multiple inputs: concat, sum, mul."""

from __future__ import annotations

import torch

from analytics_zoo_tpu_torch.nn.module import Layer

MODES = ("concat", "sum", "mul")


class Merge(Layer):
    """Merge a list of inputs. ``mode``: concat|sum|mul."""

    def __init__(self, mode: str = "sum", concat_axis: int = -1, **kw):
        super().__init__(**kw)
        self.mode = mode.lower()
        if self.mode not in MODES:
            raise ValueError(f"unknown merge mode {mode!r}; known: {MODES}")
        self.concat_axis = concat_axis

    def output_shape(self, *input_shapes):
        if self.mode != "concat":
            return tuple(input_shapes[0])
        out = list(input_shapes[0])
        out[self.concat_axis] = sum(s[self.concat_axis] for s in input_shapes)
        return tuple(out)

    def forward(self, *inputs):
        if self.mode == "concat":
            return torch.cat(inputs, dim=self.concat_axis)
        out = inputs[0]
        for x in inputs[1:]:
            out = out + x if self.mode == "sum" else out * x
        return out


def merge(inputs, mode="sum", concat_axis=-1, name=None):
    """Functional merge over autograd Variables."""
    return Merge(mode=mode, concat_axis=concat_axis, name=name)(*inputs)
