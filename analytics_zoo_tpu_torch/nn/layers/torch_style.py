"""Torch-style element and shape layers (the JAX package's
``nn/layers/torch_style.py``; reference
pyzoo/zoo/pipeline/api/keras/layers/torch.py and the Scala-only
Max.scala / Expand.scala / GetShape.scala).

Axis conventions follow the reference python API: ``dim`` is a 0-based
index over the FULL tensor (batch included); the batch dimension (dim 0)
cannot be selected, narrowed, squeezed or reduced; negative dims count
from the end.  ``CAdd``, ``CMul``, ``Mul`` and ``Scale`` hold leaves
named as the JAX trees name them.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

from analytics_zoo_tpu_torch.nn import regularizers as _reg
from analytics_zoo_tpu_torch.nn.layers.advanced_activations import (
    _Elementwise)
from analytics_zoo_tpu_torch.nn.module import StatelessLayer


def _norm_dim(dim: int, rank: int, what: str) -> int:
    d = dim + rank if dim < 0 else dim
    if not 0 <= d < rank:
        raise ValueError(f"{what}: dim {dim} out of range for rank {rank}")
    if d == 0:
        raise ValueError(f"{what}: cannot operate on the batch dimension")
    return d


# ---------------------------------------------------------------------------
# element-wise math (no parameters)
# ---------------------------------------------------------------------------

class Square(_Elementwise):
    """Element-wise ``x**2``."""

    def forward(self, x):
        return torch.square(x)


class Sqrt(_Elementwise):
    """Element-wise square root."""

    def forward(self, x):
        return torch.sqrt(x)


class Log(_Elementwise):
    """Element-wise natural log."""

    def forward(self, x):
        return torch.log(x)


class Exp(_Elementwise):
    """Element-wise exp."""

    def forward(self, x):
        return torch.exp(x)


class Negative(_Elementwise):
    """Element-wise negation."""

    def forward(self, x):
        return -x


class Identity(_Elementwise):
    """Pass-through."""

    def forward(self, x):
        return x


class Power(_Elementwise):
    """``f(x) = (shift + scale * x) ** power``."""

    def __init__(self, power, scale=1.0, shift=0.0, **kw):
        super().__init__(**kw)
        self.power = float(power)
        self.scale = float(scale)
        self.shift = float(shift)

    def forward(self, x):
        return torch.pow(self.shift + self.scale * x, self.power)


class AddConstant(_Elementwise):
    """Add a non-learnable scalar constant."""

    def __init__(self, constant, **kw):
        super().__init__(**kw)
        self.constant = float(constant)

    def forward(self, x):
        return x + self.constant


class MulConstant(_Elementwise):
    """Multiply by a non-learnable scalar constant."""

    def __init__(self, constant, **kw):
        super().__init__(**kw)
        self.constant = float(constant)

    def forward(self, x):
        return x * self.constant


# ---------------------------------------------------------------------------
# thresholding / shrinkage activations
# ---------------------------------------------------------------------------

class HardTanh(_Elementwise):
    """Clip to ``[min_value, max_value]``."""

    def __init__(self, min_value=-1.0, max_value=1.0, **kw):
        super().__init__(**kw)
        if max_value <= min_value:
            raise ValueError("HardTanh needs max_value > min_value")
        self.min_value = float(min_value)
        self.max_value = float(max_value)

    def forward(self, x):
        return torch.clamp(x, self.min_value, self.max_value)


class HardShrink(_Elementwise):
    """``x if |x| > value else 0``."""

    def __init__(self, value=0.5, **kw):
        super().__init__(**kw)
        self.value = float(value)

    def forward(self, x):
        return torch.where(torch.abs(x) > self.value, x, 0.0)


class SoftShrink(_Elementwise):
    """``x-v if x>v; x+v if x<-v; else 0``."""

    def __init__(self, value=0.5, **kw):
        super().__init__(**kw)
        self.value = float(value)

    def forward(self, x):
        v = self.value
        return torch.where(x > v, x - v, torch.where(x < -v, x + v, 0.0))


class Threshold(_Elementwise):
    """``x if x > th else v``."""

    def __init__(self, th=1e-6, v=0.0, **kw):
        super().__init__(**kw)
        self.th = float(th)
        self.v = float(v)

    def forward(self, x):
        return torch.where(x > self.th, x, self.v)


class BinaryThreshold(_Elementwise):
    """``0 where x < value, 1 elsewhere``."""

    def __init__(self, value=1e-6, **kw):
        super().__init__(**kw)
        self.value = float(value)

    def forward(self, x):
        return torch.where(x < self.value, 0.0, 1.0).to(x.dtype)


# ---------------------------------------------------------------------------
# learnable element-wise layers
# ---------------------------------------------------------------------------

class _Broadcast(StatelessLayer):
    """Leaves of ``size`` broadcast against the input, numpy's rules."""

    def __init__(self, size: Sequence[int], **kw):
        super().__init__(**kw)
        self.size = tuple(int(s) for s in size)

    def output_shape(self, input_shape):
        return tuple(torch.broadcast_shapes(tuple(input_shape), self.size))


class CAdd(_Broadcast):
    """Learnable bias (leaf ``bias``) of shape ``size`` added element-wise
    with broadcast."""

    def __init__(self, size: Sequence[int], b_regularizer=None, **kw):
        super().__init__(size, **kw)
        self.b_regularizer = _reg.get(b_regularizer)

    def build(self, generator, input_shape):
        self.set_leaf("bias", torch.zeros(self.size))

    def forward(self, x):
        return x + self.leaf("bias")

    def regularization_loss(self):
        if self.b_regularizer is None:
            return 0.0
        return self.b_regularizer(self.leaf("bias"))


class CMul(_Broadcast):
    """Learnable weight (leaf ``weight``) of shape ``size`` multiplied
    element-wise with broadcast."""

    def __init__(self, size: Sequence[int], W_regularizer=None, **kw):
        super().__init__(size, **kw)
        self.w_regularizer = _reg.get(W_regularizer)

    def build(self, generator, input_shape):
        self.set_leaf("weight", torch.ones(self.size))

    def forward(self, x):
        return x * self.leaf("weight")

    def regularization_loss(self):
        if self.w_regularizer is None:
            return 0.0
        return self.w_regularizer(self.leaf("weight"))


class Mul(_Elementwise):
    """A single learnable scalar factor (leaf ``weight``)."""

    def build(self, generator, input_shape):
        self.set_leaf("weight", torch.ones(()))

    def forward(self, x):
        return x * self.leaf("weight")


class Scale(_Broadcast):
    """CMul then CAdd with a shared ``size`` (leaves ``weight``,
    ``bias``)."""

    def build(self, generator, input_shape):
        self.set_leaf("weight", torch.ones(self.size))
        self.set_leaf("bias", torch.zeros(self.size))

    def forward(self, x):
        return x * self.leaf("weight") + self.leaf("bias")


# ---------------------------------------------------------------------------
# shape / indexing layers
# ---------------------------------------------------------------------------

class Select(StatelessLayer):
    """Select ``index`` along ``dim`` and drop that dimension.
    ``dim`` / ``index`` may be negative."""

    def __init__(self, dim: int, index: int, **kw):
        super().__init__(**kw)
        self.dim = int(dim)
        self.index = int(index)

    def forward(self, x):
        d = _norm_dim(self.dim, x.ndim, "Select")
        i = self.index + x.shape[d] if self.index < 0 else self.index
        if not 0 <= i < x.shape[d]:
            raise IndexError(
                f"Select: index {self.index} out of range for dim {d} "
                f"of size {x.shape[d]}")
        return x.select(d, i)


class Narrow(StatelessLayer):
    """Slice ``[offset, offset+length)`` along ``dim`` without reducing
    rank.  ``length=-1`` means to the end."""

    def __init__(self, dim: int, offset: int, length: int = 1, **kw):
        super().__init__(**kw)
        self.dim = int(dim)
        self.offset = int(offset)
        self.length = int(length)

    def forward(self, x):
        d = _norm_dim(self.dim, x.ndim, "Narrow")
        ofs = self.offset + x.shape[d] if self.offset < 0 else self.offset
        length = x.shape[d] - ofs if self.length == -1 else self.length
        if not (0 <= ofs and ofs + length <= x.shape[d] and length >= 0):
            raise IndexError(
                f"Narrow: [{self.offset}, {self.offset}+{self.length}) out "
                f"of range for dim {d} of size {x.shape[d]}")
        return x.narrow(d, ofs, length)


class Squeeze(StatelessLayer):
    """Drop singleton dim(s); never the batch dim.  ``dim=None`` drops
    every non-batch singleton dimension."""

    def __init__(self, dim: Union[int, Sequence[int], None] = None, **kw):
        super().__init__(**kw)
        if isinstance(dim, int):
            dim = (dim,)
        self.dim = tuple(dim) if dim is not None else None

    def forward(self, x):
        if self.dim is None:
            axes = tuple(d for d in range(1, x.ndim) if x.shape[d] == 1)
        else:
            axes = tuple(_norm_dim(d, x.ndim, "Squeeze") for d in self.dim)
            for d in axes:
                if x.shape[d] != 1:
                    raise ValueError(
                        f"Squeeze: dim {d} has size {x.shape[d]}, not 1")
        return x.squeeze(axes) if axes else x


class SelectTable(StatelessLayer):
    """Pick element ``index`` from a multi-input list."""

    def __init__(self, index: int, **kw):
        super().__init__(**kw)
        self.index = int(index)

    def forward(self, *inputs):
        return inputs[self.index]


class Max(StatelessLayer):
    """Max over ``dim``, keeping it as size 1 (reference Max.scala:39).
    ``return_value=False`` returns the int32 argmax instead."""

    def __init__(self, dim: int, return_value: bool = True, **kw):
        super().__init__(**kw)
        self.dim = int(dim)
        self.return_value = bool(return_value)

    def forward(self, x):
        d = _norm_dim(self.dim, x.ndim, "Max")
        if self.return_value:
            return torch.amax(x, dim=d, keepdim=True)
        return torch.argmax(x, dim=d, keepdim=True).to(torch.int32)


class Expand(StatelessLayer):
    """Broadcast singleton dims to ``tgt_sizes`` (the full shape with the
    batch dim; ``-1`` keeps a dim unchanged)."""

    def __init__(self, tgt_sizes: Sequence[int], **kw):
        super().__init__(**kw)
        self.tgt_sizes = tuple(int(s) for s in tgt_sizes)

    def forward(self, x):
        if len(self.tgt_sizes) != x.ndim:
            raise ValueError(
                f"Expand: tgt_sizes rank {len(self.tgt_sizes)} != input "
                f"rank {x.ndim} (include the batch dim; use -1 to keep)")
        target = tuple(x.shape[i] if t == -1 else t
                       for i, t in enumerate(self.tgt_sizes))
        return x.expand(target)


class GetShape(StatelessLayer):
    """The input's full shape as an int32 vector of length ``rank``, with
    no gradient.  Built from device fills, so a CUDA graph captures it
    (a host list copied to the card would not capture)."""

    def forward(self, x):
        return torch.stack([torch.full((), d, dtype=torch.int32,
                                       device=x.device) for d in x.shape])
