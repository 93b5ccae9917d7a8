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

The rest of the JAX module follows: ``Deconvolution2D`` (``lax.conv_transpose``
without a kernel flip: a convolution over the input dilated by the
strides, padded as ``lax`` pads a transpose), the locally connected
layers (patches times a weight per output position), ZeroPadding,
Cropping, UpSampling, ``ResizeBilinear`` (``jax.image.resize``'s
half-pixel, antialiased-when-shrinking bilinear, or corner-aligned) and
``ShareConvolution2D``.
"""

from __future__ import annotations

import functools
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


def transpose_pads(k: int, s: int, border_mode: str) -> Tuple[int, int]:
    """``lax.conv_transpose``'s padding of the stride-dilated input,
    (before, after), for one spatial dim."""
    if border_mode == "same":
        total = k + s - 2
        before = k - 1 if s > k - 1 else math.ceil(total / 2)
    else:
        total = k + s - 2 + max(k - s, 0)
        before = k - 1
    return before, total - before


def _act(layer, y):
    return layer.activation(y) if layer.activation is not None else y


class Deconvolution2D(Layer):
    """Transposed 2-D convolution, ``lax.conv_transpose`` with
    ``transpose_kernel=False``: leaves ``kernel`` (kh, kw, in, nb_filter)
    and ``bias``.  The input, dilated by the strides (zeros between its
    rows and columns) and padded as ``lax`` pads a transpose, is
    cross-correlated with the kernel as it stands; the output has ``n *
    s`` positions ("same") or ``n * s + max(k - s, 0)`` ("valid")."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation=None, subsample: IntOrPair = (1, 1),
                 border_mode: str = "valid", init="glorot_uniform",
                 bias: bool = True, dim_ordering: str = "tf",
                 dtype=torch.float32, **kw):
        super().__init__(**kw)
        check_orderings(dim_ordering, border_mode)
        self.nb_filter = nb_filter
        self.kernel_size = (nb_row, nb_col)
        self.activation = activations.get(activation)
        self.strides = _tuple(subsample, 2)
        self.border_mode = border_mode
        self.initializer = initializers.get(init)
        self.use_bias = bias
        self.dim_ordering = dim_ordering
        self.dtype = dtype

    def build(self, generator, input_shape):
        in_ch = (input_shape[1] if self.dim_ordering == "th"
                 else input_shape[-1])
        self.set_leaf("kernel", self.initializer(
            generator, self.kernel_size + (in_ch, self.nb_filter),
            self.dtype))
        if self.use_bias:
            self.set_leaf("bias", torch.zeros((self.nb_filter,),
                                              dtype=self.dtype))

    def output_shape(self, input_shape):
        th = self.dim_ordering == "th"
        sizes = input_shape[2:] if th else input_shape[1:-1]
        out = tuple(n * s + (max(k - s, 0) if self.border_mode == "valid"
                             else 0)
                    for n, k, s in zip(sizes, self.kernel_size,
                                       self.strides))
        if th:
            return (input_shape[0], self.nb_filter) + out
        return (input_shape[0],) + out + (self.nb_filter,)

    def forward(self, x):
        xc = channels_first(x, self.dim_ordering)
        b, c, h, w = xc.shape
        sh, sw = self.strides
        if (sh, sw) != (1, 1):
            dil = xc.new_zeros((b, c, (h - 1) * sh + 1, (w - 1) * sw + 1))
            dil[:, :, ::sh, ::sw] = xc
            xc = dil
        pads = [transpose_pads(k, s, self.border_mode)
                for k, s in zip(self.kernel_size, self.strides)]
        y = conv(pad_spatial(xc, pads), self.leaf("kernel"), (1, 1), (1, 1),
                 "valid",
                 bias=self.leaf("bias") if self.use_bias else None)
        return channels_back(_act(self, y), self.dim_ordering)


class LocallyConnected1D(Layer):
    """A 1-D convolution with a weight per output position: leaves
    ``kernel`` (out_len, filter_length * in, nb_filter) and ``bias``
    (out_len, nb_filter).  Patches (B, out_len, filter_length * in),
    position-major, times each position's weight (one batched matmul)."""

    def __init__(self, nb_filter: int, filter_length: int, activation=None,
                 subsample_length: int = 1, border_mode: str = "valid",
                 init="glorot_uniform", bias: bool = True,
                 dtype=torch.float32, **kw):
        super().__init__(**kw)
        if border_mode != "valid":
            raise ValueError(
                "LocallyConnected1D supports only border_mode='valid'")
        self.nb_filter = nb_filter
        self.filter_length = filter_length
        self.activation = activations.get(activation)
        self.stride = subsample_length
        self.initializer = initializers.get(init)
        self.use_bias = bias
        self.dtype = dtype

    def _out_len(self, length: int) -> int:
        return (length - self.filter_length) // self.stride + 1

    def build(self, generator, input_shape):
        _, length, in_ch = input_shape
        out_len = self._out_len(length)
        self.set_leaf("kernel", self.initializer(
            generator, (out_len, self.filter_length * in_ch,
                        self.nb_filter), self.dtype))
        if self.use_bias:
            self.set_leaf("bias", torch.zeros((out_len, self.nb_filter),
                                              dtype=self.dtype))

    def output_shape(self, input_shape):
        return (input_shape[0], self._out_len(input_shape[1]),
                self.nb_filter)

    def forward(self, x):
        b, length, _ = x.shape
        out_len = self._out_len(length)
        idx = (torch.arange(out_len, device=x.device)[:, None] * self.stride
               + torch.arange(self.filter_length, device=x.device)[None])
        patches = x[:, idx, :].reshape(b, out_len, -1)
        kernel = self.leaf("kernel").to(x.dtype)
        y = torch.einsum("bok,okf->bof", patches, kernel)
        if self.use_bias:
            y = y + self.leaf("bias").to(x.dtype)
        return _act(self, y)


class LocallyConnected2D(Layer):
    """A 2-D convolution with a weight per output position: leaves
    ``kernel`` (oh * ow, kh * kw * in, nb_filter) and ``bias`` (oh, ow,
    nb_filter); patches flattened (kh, kw, in), row-major positions."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation=None, subsample: IntOrPair = (1, 1),
                 border_mode: str = "valid", init="glorot_uniform",
                 bias: bool = True, dim_ordering: str = "tf",
                 dtype=torch.float32, **kw):
        super().__init__(**kw)
        if border_mode != "valid":
            raise ValueError(
                "LocallyConnected2D supports only border_mode='valid'")
        check_orderings(dim_ordering, border_mode)
        self.nb_filter = nb_filter
        self.kernel_size = (nb_row, nb_col)
        self.activation = activations.get(activation)
        self.strides = _tuple(subsample, 2)
        self.initializer = initializers.get(init)
        self.use_bias = bias
        self.dim_ordering = dim_ordering
        self.dtype = dtype

    def _out_hw(self, h: int, w: int) -> Tuple[int, int]:
        (kh, kw_), (sh, sw) = self.kernel_size, self.strides
        return (h - kh) // sh + 1, (w - kw_) // sw + 1

    def _hwc(self, input_shape):
        if self.dim_ordering == "th":
            _, c, h, w = input_shape
        else:
            _, h, w, c = input_shape
        return h, w, c

    def build(self, generator, input_shape):
        h, w, in_ch = self._hwc(input_shape)
        oh, ow = self._out_hw(h, w)
        kh, kw_ = self.kernel_size
        self.set_leaf("kernel", self.initializer(
            generator, (oh * ow, kh * kw_ * in_ch, self.nb_filter),
            self.dtype))
        if self.use_bias:
            self.set_leaf("bias", torch.zeros((oh, ow, self.nb_filter),
                                              dtype=self.dtype))

    def output_shape(self, input_shape):
        h, w, _ = self._hwc(input_shape)
        oh, ow = self._out_hw(h, w)
        if self.dim_ordering == "th":
            return (input_shape[0], self.nb_filter, oh, ow)
        return (input_shape[0], oh, ow, self.nb_filter)

    def forward(self, x):
        x = channels_first(x, self.dim_ordering).movedim(1, -1)
        b, h, w, c = x.shape
        (kh, kw_), (sh, sw) = self.kernel_size, self.strides
        oh, ow = self._out_hw(h, w)
        ar = functools.partial(torch.arange, device=x.device)
        ridx = ar(oh)[:, None] * sh + ar(kh)[None]
        cidx = ar(ow)[:, None] * sw + ar(kw_)[None]
        # (B, oh, kh, W, C) -> (B, oh, kh, ow, kw, C) -> positions
        patches = x[:, ridx][:, :, :, cidx].permute(0, 1, 3, 2, 4, 5)
        patches = patches.reshape(b, oh * ow, kh * kw_ * c)
        y = torch.einsum("bok,okf->bof", patches,
                         self.leaf("kernel").to(x.dtype))
        y = y.reshape(b, oh, ow, self.nb_filter)
        if self.use_bias:
            y = y + self.leaf("bias").to(x.dtype)
        y = _act(self, y)
        return y if self.dim_ordering == "tf" else y.movedim(-1, 1)


class ZeroPaddingND(Layer):
    """Zero padding of the spatial dims: ``padding`` holds an int or a
    (before, after) pair per dim."""

    spatial = 2

    def __init__(self, padding, dim_ordering: str = "tf", **kw):
        super().__init__(**kw)
        check_orderings(dim_ordering, "valid")
        self.padding = [(p, p) if isinstance(p, int) else tuple(p)
                        for p in padding]
        self.dim_ordering = dim_ordering

    def output_shape(self, input_shape):
        out = list(input_shape)
        first = 2 if self.dim_ordering == "th" else 1
        for i, (a, b) in enumerate(self.padding):
            out[first + i] += a + b
        return tuple(out)

    def forward(self, x):
        y = pad_spatial(channels_first(x, self.dim_ordering), self.padding)
        return channels_back(y, self.dim_ordering)


class ZeroPadding1D(ZeroPaddingND):
    spatial = 1

    def __init__(self, padding: int = 1, **kw):
        super().__init__([padding], **kw)


class ZeroPadding2D(ZeroPaddingND):
    spatial = 2

    def __init__(self, padding: IntOrPair = (1, 1), **kw):
        super().__init__(list(_tuple(padding, 2)), **kw)


class ZeroPadding3D(ZeroPaddingND):
    spatial = 3

    def __init__(self, padding: IntOrPair = (1, 1, 1), **kw):
        super().__init__(list(_tuple(padding, 3)), **kw)


class CroppingND(Layer):
    """Crop (before, after) positions off each spatial dim.  As in the
    JAX layer, a dim whose ``size - after`` is 0 keeps everything from
    ``before`` on (Python's ``slice(before, 0 or None)``)."""

    spatial = 2

    def __init__(self, cropping, dim_ordering: str = "tf", **kw):
        super().__init__(**kw)
        check_orderings(dim_ordering, "valid")
        self.cropping = [tuple(c) for c in cropping]
        self.dim_ordering = dim_ordering

    def _slices(self, sizes):
        return [slice(lo, n - hi or None) for n, (lo, hi)
                in zip(sizes, self.cropping)]

    def output_shape(self, input_shape):
        out = list(input_shape)
        first = 2 if self.dim_ordering == "th" else 1
        for i, sl in enumerate(self._slices(input_shape[first:])):
            out[first + i] = len(range(*sl.indices(out[first + i])))
        return tuple(out)

    def forward(self, x):
        xc = channels_first(x, self.dim_ordering)
        y = xc[(slice(None), slice(None)) + tuple(self._slices(
            xc.shape[2:]))]
        return channels_back(y, self.dim_ordering)


class Cropping1D(CroppingND):
    spatial = 1

    def __init__(self, cropping=(1, 1), **kw):
        super().__init__([tuple(cropping)], **kw)


class Cropping2D(CroppingND):
    spatial = 2

    def __init__(self, heightCrop=(0, 0), widthCrop=(0, 0), **kw):
        super().__init__([tuple(heightCrop), tuple(widthCrop)], **kw)


class Cropping3D(CroppingND):
    spatial = 3

    def __init__(self, dim1Crop=(1, 1), dim2Crop=(1, 1), dim3Crop=(1, 1),
                 **kw):
        super().__init__([tuple(dim1Crop), tuple(dim2Crop),
                          tuple(dim3Crop)], **kw)


class UpSamplingND(Layer):
    """Repeat each spatial position ``size`` times along its dim."""

    spatial = 2

    def __init__(self, size, dim_ordering: str = "tf", **kw):
        super().__init__(**kw)
        check_orderings(dim_ordering, "valid")
        self.size = tuple(size)
        self.dim_ordering = dim_ordering

    def output_shape(self, input_shape):
        out = list(input_shape)
        first = 2 if self.dim_ordering == "th" else 1
        for i, s in enumerate(self.size):
            out[first + i] *= s
        return tuple(out)

    def forward(self, x):
        y = channels_first(x, self.dim_ordering)
        for axis, s in enumerate(self.size, start=2):
            y = torch.repeat_interleave(y, s, dim=axis)
        return channels_back(y, self.dim_ordering)


class UpSampling1D(UpSamplingND):
    spatial = 1

    def __init__(self, length: int = 2, **kw):
        super().__init__((length,), **kw)


class UpSampling2D(UpSamplingND):
    spatial = 2

    def __init__(self, size: IntOrPair = (2, 2), **kw):
        super().__init__(_tuple(size, 2), **kw)


class UpSampling3D(UpSamplingND):
    spatial = 3

    def __init__(self, size: IntOrPair = (2, 2, 2), **kw):
        super().__init__(_tuple(size, 3), **kw)


# Keras-2 names
Conv1D = Convolution1D
Conv2D = Convolution2D
Conv3D = Convolution3D


class ResizeBilinear(Layer):
    """Bilinear resize of the spatial dims to (output_height,
    output_width).  ``align_corners=False`` is ``jax.image.resize(...,
    "bilinear")``: half-pixel centres, and a triangle filter widened by
    the scale (antialiasing) along a dim that shrinks, which is
    ``F.interpolate(..., antialias=True)``; a dim that grows takes the
    plain half-pixel bilinear.  ``align_corners=True`` maps the corner
    pixels onto each other (the BigDL / TF-v1 convention)."""

    def __init__(self, output_height: int, output_width: int,
                 align_corners: bool = False, dim_ordering: str = "tf",
                 **kw):
        super().__init__(**kw)
        check_orderings(dim_ordering, "valid")
        self.output_height = output_height
        self.output_width = output_width
        self.align_corners = align_corners
        self.dim_ordering = dim_ordering

    def output_shape(self, input_shape):
        if self.dim_ordering == "th":
            return tuple(input_shape[:2]) + (self.output_height,
                                             self.output_width)
        return (input_shape[0], self.output_height, self.output_width,
                input_shape[-1])

    def forward(self, x):
        xc = channels_first(x, self.dim_ordering)
        ih, iw = xc.shape[2:]
        oh, ow = self.output_height, self.output_width
        if not self.align_corners:
            y = xc
            # one dim at a time: each takes its own filter width
            if oh != ih:
                y = F.interpolate(y, size=(oh, iw), mode="bilinear",
                                  align_corners=False, antialias=oh < ih)
            if ow != iw:
                y = F.interpolate(y, size=(oh, ow), mode="bilinear",
                                  align_corners=False, antialias=ow < iw)
            return channels_back(y, self.dim_ordering)
        ys = torch.linspace(0.0, ih - 1.0, oh, device=xc.device)
        xs = torch.linspace(0.0, iw - 1.0, ow, device=xc.device)
        y0 = torch.floor(ys).long().clamp(0, ih - 1)
        x0 = torch.floor(xs).long().clamp(0, iw - 1)
        y1 = (y0 + 1).clamp(max=ih - 1)
        x1 = (x0 + 1).clamp(max=iw - 1)
        wy = (ys - y0).reshape(1, 1, oh, 1).to(xc.dtype)
        wx = (xs - x0).reshape(1, 1, 1, ow).to(xc.dtype)

        def g(yy, xx):
            return xc[:, :, yy][:, :, :, xx]

        y = ((1 - wy) * (1 - wx) * g(y0, x0) + (1 - wy) * wx * g(y0, x1)
             + wy * (1 - wx) * g(y1, x0) + wy * wx * g(y1, x1))
        return channels_back(y, self.dim_ordering)


class ShareConvolution2D(Convolution2D):
    """The JAX package's name for a plain ``Convolution2D`` (the
    reference's ShareConvolution2D shared JVM workspace buffers; PyTorch's
    caching allocator owns buffer reuse)."""
