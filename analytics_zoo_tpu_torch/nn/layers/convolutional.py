"""Convolution layers: ``Convolution1D/2D/3D``, the atrous forms,
``SpaceToDepthStemConv`` and ``SeparableConvolution2D``, the JAX
package's ``nn/layers/convolutional.py`` (its first part).

Leaves keep the JAX package's shapes — a kernel is ``(*k, in, out)`` —
so ``params()``, archives and checkpoints match it; the layout change to
PyTorch's ``(out, in, *k)`` happens in the forward, as a view.  Inputs
are channels-last (``dim_ordering="tf"``, the default: (B, *S, C)) or
channels-first (``"th"``: (B, C, *S)).  A channels-last input is viewed
as channels-first without a copy (its memory is then PyTorch's
``channels_last`` format, which cuDNN convolves directly) and the output
viewed back.

``border_mode="same"`` is TensorFlow's: the output has ``ceil(n / s)``
positions and the total padding ``(out - 1) * s + (k - 1) * d + 1 - n``
is split with the smaller half before.  When the halves differ (the
7x7/s2 stem on 224 pads (2, 3)), the input is padded explicitly:
PyTorch's symmetric ``padding=`` would shift the output by a position.

Deconvolution2D, the locally connected layers, ZeroPadding, Cropping,
UpSampling, ResizeBilinear and ShareConvolution2D are not ported yet
(ROADMAP A8).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.nn import activations, initializers
from analytics_zoo_tpu_torch.nn import regularizers as _reg
from analytics_zoo_tpu_torch.nn.module import Layer

IntOrPair = Union[int, Sequence[int]]
DIM_ORDERINGS = ("tf", "th")
BORDER_MODES = ("valid", "same")
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _tuple(v: IntOrPair, n: int) -> Tuple[int, ...]:
    if isinstance(v, int):
        return (v,) * n
    t = tuple(int(a) for a in v)
    if len(t) != n:
        raise ValueError(f"expected {n} values, got {t}")
    return t


def check_orderings(dim_ordering: str, border_mode: str) -> None:
    if dim_ordering not in DIM_ORDERINGS:
        raise ValueError(f"dim_ordering must be one of {DIM_ORDERINGS}, "
                         f"got {dim_ordering!r}")
    if border_mode not in BORDER_MODES:
        raise ValueError(f"border_mode must be valid|same, got "
                         f"{border_mode!r}")


def channels_first(x: torch.Tensor, dim_ordering: str) -> torch.Tensor:
    """(B, *S, C) -> a (B, C, *S) view when ``dim_ordering`` is "tf"."""
    return x.movedim(-1, 1) if dim_ordering == "tf" else x


def channels_back(y: torch.Tensor, dim_ordering: str) -> torch.Tensor:
    return y.movedim(1, -1) if dim_ordering == "tf" else y


def same_pads(sizes: Sequence[int], kernel: Sequence[int],
              strides: Sequence[int],
              dilation: Sequence[int]) -> List[Tuple[int, int]]:
    """TensorFlow's SAME padding, (before, after) per spatial dim."""
    out = []
    for n, k, s, d in zip(sizes, kernel, strides, dilation):
        total = max((math.ceil(n / s) - 1) * s + (k - 1) * d + 1 - n, 0)
        out.append((total // 2, total - total // 2))
    return out


def pad_spatial(x: torch.Tensor, pads, value: float = 0.0) -> torch.Tensor:
    """Pad the trailing spatial dims of a channels-first ``x``."""
    flat = [p for pair in reversed(pads) for p in pair]
    return F.pad(x, flat, value=value) if any(flat) else x


def out_size(n: int, k: int, s: int, d: int, border_mode: str) -> int:
    if border_mode == "same":
        return math.ceil(n / s)
    return (n - (k - 1) * d - 1) // s + 1


def torch_kernel(w: torch.Tensor) -> torch.Tensor:
    """A ``(*k, in, out)`` kernel as PyTorch's ``(out, in, *k)`` (a
    view)."""
    s = w.ndim - 2
    return w.permute(s + 1, s, *range(s))


def conv(x, w, strides, dilation, border_mode, groups=1, bias=None):
    """Convolve channels-first ``x`` with a ``(*k, in / groups, out)``
    kernel (and add ``bias``), TensorFlow padding."""
    s = x.ndim - 2
    k = tuple(w.shape[:s])
    padding = 0
    if border_mode == "same":
        pads = same_pads(x.shape[2:], k, strides, dilation)
        if all(a == b for a, b in pads):
            padding = tuple(a for a, _ in pads)
        else:
            x = pad_spatial(x, pads)
    if bias is not None:
        bias = bias.to(x.dtype)
    return _CONV[s](x, torch_kernel(w).to(x.dtype), bias, strides, padding,
                    dilation, groups)


class ConvND(Layer):
    """Shared N-dimensional convolution: leaves ``kernel`` ``(*k, in,
    nb_filter)`` and ``bias`` (nb_filter,) when ``bias``."""

    spatial: int = 2

    def __init__(self, nb_filter: int, kernel_size: Sequence[int],
                 activation=None, border_mode: str = "valid",
                 subsample: IntOrPair = 1, dilation: IntOrPair = 1,
                 init="glorot_uniform", bias: bool = True,
                 dim_ordering: str = "tf", w_regularizer=None,
                 b_regularizer=None, dtype=torch.float32, **kw):
        super().__init__(**kw)
        check_orderings(dim_ordering, border_mode)
        self.nb_filter = nb_filter
        self.kernel_size = _tuple(kernel_size, self.spatial)
        self.activation = activations.get(activation)
        self.border_mode = border_mode
        self.strides = _tuple(subsample, self.spatial)
        self.dilation = _tuple(dilation, self.spatial)
        self.initializer = initializers.get(init)
        self.use_bias = bias
        self.dim_ordering = dim_ordering
        self.dtype = dtype
        self.w_regularizer = _reg.get(w_regularizer)
        self.b_regularizer = _reg.get(b_regularizer)

    def _in_channels(self, input_shape) -> int:
        return (input_shape[1] if self.dim_ordering == "th"
                else input_shape[-1])

    def build(self, generator, input_shape):
        in_ch = self._in_channels(input_shape)
        self.set_leaf("kernel", self.initializer(
            generator, self.kernel_size + (in_ch, self.nb_filter),
            self.dtype))
        if self.use_bias:
            self.set_leaf("bias", torch.zeros((self.nb_filter,),
                                              dtype=self.dtype))

    def output_shape(self, input_shape):
        th = self.dim_ordering == "th"
        sizes = input_shape[2:] if th else input_shape[1:-1]
        out = tuple(out_size(n, k, s, d, self.border_mode) for n, k, s, d
                    in zip(sizes, self.kernel_size, self.strides,
                           self.dilation))
        if th:
            return (input_shape[0], self.nb_filter) + out
        return (input_shape[0],) + out + (self.nb_filter,)

    def _convolve(self, x, bias):
        return conv(x, self.leaf("kernel"), self.strides, self.dilation,
                    self.border_mode, bias=bias)

    def forward(self, x):
        y = self._convolve(channels_first(x, self.dim_ordering),
                           self.leaf("bias") if self.use_bias else None)
        if self.activation is not None:
            y = self.activation(y)
        return channels_back(y, self.dim_ordering)

    def regularization_loss(self):
        loss = 0.0
        if self.w_regularizer is not None:
            loss = loss + self.w_regularizer(self.leaf("kernel"))
        if self.b_regularizer is not None and self.use_bias:
            loss = loss + self.b_regularizer(self.leaf("bias"))
        return loss


class Convolution1D(ConvND):
    """1-D convolution over (B, L, C)."""

    spatial = 1

    def __init__(self, nb_filter: int, filter_length: int, **kw):
        super().__init__(nb_filter, (filter_length,), **kw)


class Convolution2D(ConvND):
    """2-D convolution."""

    spatial = 2

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int, **kw):
        super().__init__(nb_filter, (nb_row, nb_col), **kw)


class Convolution3D(ConvND):
    """3-D convolution."""

    spatial = 3

    def __init__(self, nb_filter: int, kernel_dim1: int, kernel_dim2: int,
                 kernel_dim3: int, **kw):
        super().__init__(nb_filter, (kernel_dim1, kernel_dim2, kernel_dim3),
                         **kw)


class AtrousConvolution1D(Convolution1D):
    """Dilated 1-D convolution."""

    def __init__(self, nb_filter: int, filter_length: int,
                 atrous_rate: int = 1, **kw):
        kw.setdefault("dilation", atrous_rate)
        super().__init__(nb_filter, filter_length, **kw)


class AtrousConvolution2D(Convolution2D):
    """Dilated 2-D convolution."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 atrous_rate: IntOrPair = (1, 1), **kw):
        kw.setdefault("dilation", atrous_rate)
        super().__init__(nb_filter, nb_row, nb_col, **kw)


class SpaceToDepthStemConv(Convolution2D):
    """The 7x7/stride-2 SAME stem convolution, with the leaf and the
    outputs of ``Convolution2D(O, 7, 7, subsample=2,
    border_mode="same")``.

    It computes the JAX package's way: a 4x4/stride-1 VALID convolution
    over a space-to-depth(2) transform of the input (the kernel padded to
    8x8 at the top and left, each 2x2 phase folded into channels), which
    on a TPU keeps 12 input channels on the MXU instead of 3.  On an H100
    cuDNN also runs it faster than the plain 7x7/stride-2 convolution in
    ResNet-50's bf16 training step (``chip_smoke.py`` times the two); an
    odd-sized input takes the plain convolution, as in the JAX layer."""

    def __init__(self, nb_filter: int, **kw):
        kw.setdefault("border_mode", "same")
        kw.setdefault("subsample", (2, 2))
        super().__init__(nb_filter, 7, 7, **kw)
        if (self.strides != (2, 2) or self.kernel_size != (7, 7)
                or self.border_mode != "same"
                or self.dilation != (1, 1)):
            raise ValueError(
                "SpaceToDepthStemConv is exactly the 7x7/stride-2/SAME "
                "undilated stem; use Convolution2D for anything else")

    def _convolve(self, x, bias):
        b, c, h, wd = x.shape
        if h % 2 or wd % 2:
            return super()._convolve(x, bias)
        w = self.leaf("kernel")                          # (7, 7, C, O)
        o = w.shape[-1]
        # w2[a, b, (u, v, c), o] = w8[2a+u, 2b+v, c, o]
        w8 = F.pad(w, (0, 0, 0, 0, 1, 0, 1, 0))
        w2 = (w8.reshape(4, 2, 4, 2, c, o).permute(0, 2, 1, 3, 4, 5)
              .reshape(4, 4, 4 * c, o))
        # SAME padding for k=8/s=2 after the +1 kernel shift is (3, 3);
        # x2[b, i, j, (u, v, c)] = xp[b, 2i+u, 2j+v, c], built channels-
        # last (an NCHW-contiguous x2 would turn every later layer's
        # memory format, and cuDNN's convolutions, to NCHW)
        xp = F.pad(x.permute(0, 2, 3, 1), (0, 0, 3, 3, 3, 3))
        hp, wp = h + 6, wd + 6
        x2 = (xp.reshape(b, hp // 2, 2, wp // 2, 2, c)
              .permute(0, 1, 3, 2, 4, 5).reshape(b, hp // 2, wp // 2, 4 * c))
        return conv(x2.permute(0, 3, 1, 2), w2, (1, 1), (1, 1), "valid",
                    bias=bias)


class SeparableConvolution2D(Layer):
    """Depthwise convolution (``depth_multiplier`` filters per input
    channel) then a 1x1 pointwise one: leaves ``depthwise`` (kh, kw, 1,
    in * depth_multiplier), ``pointwise`` (1, 1, in * depth_multiplier,
    nb_filter) and ``bias``."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation=None, border_mode: str = "valid",
                 subsample: IntOrPair = (1, 1), depth_multiplier: int = 1,
                 init="glorot_uniform", bias: bool = True,
                 dim_ordering: str = "tf", dtype=torch.float32, **kw):
        super().__init__(**kw)
        check_orderings(dim_ordering, border_mode)
        self.nb_filter = nb_filter
        self.kernel_size = (nb_row, nb_col)
        self.activation = activations.get(activation)
        self.border_mode = border_mode
        self.strides = _tuple(subsample, 2)
        self.depth_multiplier = depth_multiplier
        self.initializer = initializers.get(init)
        self.use_bias = bias
        self.dim_ordering = dim_ordering
        self.dtype = dtype

    def build(self, generator, input_shape):
        in_ch = (input_shape[1] if self.dim_ordering == "th"
                 else input_shape[-1])
        mid = in_ch * self.depth_multiplier
        self.set_leaf("depthwise", self.initializer(
            generator, self.kernel_size + (1, mid), self.dtype))
        self.set_leaf("pointwise", self.initializer(
            generator, (1, 1, mid, self.nb_filter), self.dtype))
        if self.use_bias:
            self.set_leaf("bias", torch.zeros((self.nb_filter,),
                                              dtype=self.dtype))

    def output_shape(self, input_shape):
        th = self.dim_ordering == "th"
        sizes = input_shape[2:] if th else input_shape[1:-1]
        out = tuple(out_size(n, k, s, 1, self.border_mode) for n, k, s
                    in zip(sizes, self.kernel_size, self.strides))
        if th:
            return (input_shape[0], self.nb_filter) + out
        return (input_shape[0],) + out + (self.nb_filter,)

    def forward(self, x):
        xc = channels_first(x, self.dim_ordering)
        y = conv(xc, self.leaf("depthwise"), self.strides, (1, 1),
                 self.border_mode, groups=xc.shape[1])
        y = conv(y, self.leaf("pointwise"), (1, 1), (1, 1), "valid",
                 bias=self.leaf("bias") if self.use_bias else None)
        if self.activation is not None:
            y = self.activation(y)
        return channels_back(y, self.dim_ordering)
