"""Keras-2 style layer surface (the JAX package's ``nn/keras2.py``;
reference ``pipeline/api/keras2/layers/``): the Keras-1 layers under
Keras-2 argument names (units / filters / kernel_size / strides / padding
instead of output_dim / nb_filter / nb_row / subsample / border_mode).
Each class is a constructor adapter over the one implementation, with the
same leaves, so weights move freely between the two surfaces.
"""

from __future__ import annotations

from typing import Optional

# ``merge`` the module is shadowed by the function that nn.layers
# exports, so the merge classes are imported by name
from analytics_zoo_tpu_torch.nn.layers import advanced_activations as _aa
from analytics_zoo_tpu_torch.nn.layers import convolutional as _cv
from analytics_zoo_tpu_torch.nn.layers import core as _core
from analytics_zoo_tpu_torch.nn.layers import embedding as _emb
from analytics_zoo_tpu_torch.nn.layers import normalization as _nm
from analytics_zoo_tpu_torch.nn.layers import pooling as _pl
from analytics_zoo_tpu_torch.nn.layers import recurrent as _rc
from analytics_zoo_tpu_torch.nn.layers.convolutional import _tuple
from analytics_zoo_tpu_torch.nn.layers.merge import (  # noqa: F401
    Add, Average, Concatenate, Maximum, Minimum, Multiply)


def _pair(v):
    return _tuple(v, 2)


class Dense(_core.Dense):
    def __init__(self, units: int, activation=None, use_bias: bool = True,
                 kernel_initializer="glorot_uniform",
                 kernel_regularizer=None, bias_regularizer=None, **kw):
        super().__init__(units, activation=activation, use_bias=use_bias,
                         init=kernel_initializer,
                         w_regularizer=kernel_regularizer,
                         b_regularizer=bias_regularizer, **kw)


class Conv1D(_cv.Convolution1D):
    def __init__(self, filters: int, kernel_size: int, strides: int = 1,
                 padding: str = "valid", activation=None,
                 dilation_rate: int = 1, use_bias: bool = True,
                 kernel_initializer="glorot_uniform",
                 kernel_regularizer=None, bias_regularizer=None, **kw):
        super().__init__(filters, kernel_size, subsample=strides,
                         border_mode=padding, activation=activation,
                         dilation=dilation_rate, bias=use_bias,
                         init=kernel_initializer,
                         w_regularizer=kernel_regularizer,
                         b_regularizer=bias_regularizer, **kw)


class Conv2D(_cv.Convolution2D):
    def __init__(self, filters: int, kernel_size, strides=1,
                 padding: str = "valid", activation=None, dilation_rate=1,
                 use_bias: bool = True,
                 kernel_initializer="glorot_uniform",
                 kernel_regularizer=None, bias_regularizer=None, **kw):
        kh, kw_ = _pair(kernel_size)
        super().__init__(filters, kh, kw_, subsample=_pair(strides),
                         border_mode=padding, activation=activation,
                         dilation=_pair(dilation_rate), bias=use_bias,
                         init=kernel_initializer,
                         w_regularizer=kernel_regularizer,
                         b_regularizer=bias_regularizer, **kw)


class Conv3D(_cv.Convolution3D):
    def __init__(self, filters: int, kernel_size, strides=1,
                 padding: str = "valid", activation=None,
                 use_bias: bool = True, **kw):
        ks = (kernel_size,) * 3 if isinstance(kernel_size, int) \
            else tuple(kernel_size)
        st = (strides,) * 3 if isinstance(strides, int) else tuple(strides)
        super().__init__(filters, *ks, subsample=st, border_mode=padding,
                         activation=activation, bias=use_bias, **kw)


class Conv2DTranspose(_cv.Deconvolution2D):
    def __init__(self, filters: int, kernel_size, strides=1,
                 padding: str = "valid", activation=None,
                 use_bias: bool = True, **kw):
        kh, kw_ = _pair(kernel_size)
        super().__init__(filters, kh, kw_, subsample=_pair(strides),
                         border_mode=padding, activation=activation,
                         bias=use_bias, **kw)


class SeparableConv2D(_cv.SeparableConvolution2D):
    def __init__(self, filters: int, kernel_size, strides=1,
                 padding: str = "valid", depth_multiplier: int = 1,
                 activation=None, use_bias: bool = True, **kw):
        kh, kw_ = _pair(kernel_size)
        super().__init__(filters, kh, kw_, subsample=_pair(strides),
                         border_mode=padding,
                         depth_multiplier=depth_multiplier,
                         activation=activation, bias=use_bias, **kw)


class MaxPooling1D(_pl.MaxPooling1D):
    def __init__(self, pool_size: int = 2, strides: Optional[int] = None,
                 padding: str = "valid", **kw):
        super().__init__(pool_length=pool_size, stride=strides,
                         border_mode=padding, **kw)


class MaxPooling2D(_pl.MaxPooling2D):
    def __init__(self, pool_size=(2, 2), strides=None,
                 padding: str = "valid", **kw):
        super().__init__(_pair(pool_size),
                         strides=None if strides is None else _pair(strides),
                         border_mode=padding, **kw)


class AveragePooling1D(_pl.AveragePooling1D):
    def __init__(self, pool_size: int = 2, strides: Optional[int] = None,
                 padding: str = "valid", **kw):
        super().__init__(pool_length=pool_size, stride=strides,
                         border_mode=padding, **kw)


class AveragePooling2D(_pl.AveragePooling2D):
    def __init__(self, pool_size=(2, 2), strides=None,
                 padding: str = "valid", **kw):
        super().__init__(_pair(pool_size),
                         strides=None if strides is None else _pair(strides),
                         border_mode=padding, **kw)


class Embedding(_emb.Embedding):
    def __init__(self, input_dim: int, output_dim: int,
                 embeddings_initializer="uniform", **kw):
        super().__init__(input_dim, output_dim,
                         init=embeddings_initializer, **kw)


class BatchNormalization(_nm.BatchNormalization):
    def __init__(self, momentum: float = 0.99, epsilon: float = 1e-3,
                 center: bool = True, scale: bool = True, **kw):
        super().__init__(momentum=momentum, epsilon=epsilon, center=center,
                         scale=scale, **kw)


class LSTM(_rc.LSTM):
    def __init__(self, units: int, activation="tanh",
                 recurrent_activation="hard_sigmoid",
                 return_sequences: bool = False,
                 go_backwards: bool = False, **kw):
        super().__init__(units, activation=activation,
                         inner_activation=recurrent_activation,
                         return_sequences=return_sequences,
                         go_backwards=go_backwards, **kw)


class GRU(_rc.GRU):
    def __init__(self, units: int, activation="tanh",
                 recurrent_activation="hard_sigmoid",
                 return_sequences: bool = False,
                 go_backwards: bool = False, **kw):
        super().__init__(units, activation=activation,
                         inner_activation=recurrent_activation,
                         return_sequences=return_sequences,
                         go_backwards=go_backwards, **kw)


class SimpleRNN(_rc.SimpleRNN):
    def __init__(self, units: int, activation="tanh",
                 return_sequences: bool = False, **kw):
        super().__init__(units, activation=activation,
                         return_sequences=return_sequences, **kw)


class LeakyReLU(_aa.LeakyReLU):
    def __init__(self, alpha: float = 0.3, **kw):
        super().__init__(alpha, **kw)


# identical-signature layers re-exported for a complete keras2 namespace
Activation = _core.Activation
Dropout = _core.Dropout
Flatten = _core.Flatten
Reshape = _core.Reshape
Permute = _core.Permute
RepeatVector = _core.RepeatVector
GlobalMaxPooling1D = _pl.GlobalMaxPooling1D
GlobalMaxPooling2D = _pl.GlobalMaxPooling2D
GlobalAveragePooling1D = _pl.GlobalAveragePooling1D
GlobalAveragePooling2D = _pl.GlobalAveragePooling2D
# (Add/Maximum/Minimum/Average/Multiply/Concatenate imported above)

__all__ = [
    "Dense", "Conv1D", "Conv2D", "Conv3D", "Conv2DTranspose",
    "SeparableConv2D", "MaxPooling1D", "MaxPooling2D", "AveragePooling1D",
    "AveragePooling2D", "Embedding", "BatchNormalization", "LSTM", "GRU",
    "SimpleRNN", "LeakyReLU", "Activation", "Dropout", "Flatten",
    "Reshape", "Permute", "RepeatVector", "GlobalMaxPooling1D",
    "GlobalMaxPooling2D", "GlobalAveragePooling1D",
    "GlobalAveragePooling2D", "Add", "Maximum", "Minimum", "Average",
    "Multiply", "Concatenate",
]
