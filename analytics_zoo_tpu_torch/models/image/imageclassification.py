"""Image classification: ResNet-50, Inception-v1, MobileNet and VGG-16
builders and ``ImageClassifier``, the JAX package's
``models/image/imageclassification.py``.

Every builder makes the JAX package's graph in its order, so the layer
names (given, or auto-named in the same sequence) and every leaf match
its parameter and state trees.  Nets are channels-last (NHWC).  A
builder returns a built ``Model`` whose weights are drawn on the CPU
from ``generator`` (default seeded from ``ZooConfig.seed``); ``compile``
moves them to its device.

``ImageClassifier.preprocessing`` is the architecture's host chain
(``data/image.py``: aspect scale, centre crop, channel normalisation),
and ``predict_image_set`` classifies an ``ImageSet`` through it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from analytics_zoo_tpu_torch.core.context import get_zoo_context
from analytics_zoo_tpu_torch.models.common import ZooModel, register_model
from analytics_zoo_tpu_torch.nn import Input, Model
from analytics_zoo_tpu_torch.nn.layers.convolutional import (
    Convolution2D, SeparableConvolution2D, SpaceToDepthStemConv)
from analytics_zoo_tpu_torch.nn.layers.core import (Activation, Dense,
                                                    Dropout, Flatten)
from analytics_zoo_tpu_torch.nn.layers.merge import merge
from analytics_zoo_tpu_torch.nn.layers.normalization import \
    BatchNormalization
from analytics_zoo_tpu_torch.nn.layers.pooling import (GlobalAveragePooling2D,
                                                       MaxPooling2D)


def _built(inp, out, name, generator) -> Model:
    model = Model(inp, out, name=name)
    if generator is None:
        generator = torch.Generator().manual_seed(
            get_zoo_context().config.seed)
    model.build(generator)
    return model


def _conv_bn(x, filters, k, strides=1, activation="relu", name=None,
             border_mode="same", bn_stats_fraction=1.0, bn_momentum=0.99):
    x = Convolution2D(filters, k, k, subsample=(strides, strides),
                      border_mode=border_mode, bias=False,
                      name=None if name is None else f"{name}_conv")(x)
    x = BatchNormalization(name=None if name is None else f"{name}_bn",
                           stats_fraction=bn_stats_fraction,
                           momentum=bn_momentum)(x)
    if activation:
        x = Activation(activation)(x)
    return x


# ---------------------------------------------------------------- ResNet --

def _bottleneck(x, filters, strides=1, downsample=False, name="",
                bn_stats_fraction=1.0, bn_momentum=0.99):
    shortcut = x
    if downsample:
        shortcut = Convolution2D(filters * 4, 1, 1,
                                 subsample=(strides, strides),
                                 border_mode="same", bias=False,
                                 name=f"{name}_proj")(x)
        shortcut = BatchNormalization(
            name=f"{name}_proj_bn", momentum=bn_momentum,
            stats_fraction=bn_stats_fraction)(shortcut)
    y = _conv_bn(x, filters, 1, strides=strides, name=f"{name}_a",
                 bn_stats_fraction=bn_stats_fraction,
                 bn_momentum=bn_momentum)
    y = _conv_bn(y, filters, 3, name=f"{name}_b",
                 bn_stats_fraction=bn_stats_fraction,
                 bn_momentum=bn_momentum)
    y = Convolution2D(filters * 4, 1, 1, border_mode="same", bias=False,
                      name=f"{name}_c_conv")(y)
    y = BatchNormalization(name=f"{name}_c_bn", momentum=bn_momentum,
                           stats_fraction=bn_stats_fraction)(y)
    out = merge([y, shortcut], mode="sum")
    return Activation("relu")(out)


def resnet50(class_num: int = 1000,
             input_shape: Sequence[int] = (224, 224, 3),
             space_to_depth_stem: bool = True,
             bn_stats_fraction: float = 1.0,
             bn_momentum: float = 0.99,
             generator: Optional[torch.Generator] = None) -> Model:
    """ResNet-50 (bottlenecks [3, 4, 6, 3] at widths 64-2048; ImageNet's
    25.6 M parameters at 1000 classes).  ``space_to_depth_stem`` makes the
    stem a ``SpaceToDepthStemConv`` on even inputs, as the JAX builder
    does (the same leaf and outputs as the plain 7x7/s2 convolution)."""
    inp = Input(shape=tuple(input_shape), name="input")
    if space_to_depth_stem and input_shape[0] % 2 == 0 \
            and input_shape[1] % 2 == 0:
        x = SpaceToDepthStemConv(64, bias=False, name="stem_conv")(inp)
    else:
        x = Convolution2D(64, 7, 7, subsample=(2, 2), border_mode="same",
                          bias=False, name="stem_conv")(inp)
    x = BatchNormalization(name="stem_bn", momentum=bn_momentum,
                           stats_fraction=bn_stats_fraction)(x)
    x = Activation("relu")(x)
    x = MaxPooling2D((3, 3), strides=(2, 2), border_mode="same")(x)
    for stage, (blocks, filters) in enumerate(
            [(3, 64), (4, 128), (6, 256), (3, 512)]):
        for b in range(blocks):
            strides = 2 if (b == 0 and stage > 0) else 1
            x = _bottleneck(x, filters, strides=strides, downsample=(b == 0),
                            name=f"s{stage}b{b}",
                            bn_stats_fraction=bn_stats_fraction,
                            bn_momentum=bn_momentum)
    x = GlobalAveragePooling2D()(x)
    x = Dense(class_num, name="fc")(x)
    return _built(inp, x, "resnet50", generator)


# ------------------------------------------------------------- Inception --

def _inception_block(x, c1, c3r, c3, c5r, c5, pp, name=""):
    b1 = _conv_bn(x, c1, 1, name=f"{name}_1x1")
    b3 = _conv_bn(x, c3r, 1, name=f"{name}_3x3r")
    b3 = _conv_bn(b3, c3, 3, name=f"{name}_3x3")
    b5 = _conv_bn(x, c5r, 1, name=f"{name}_5x5r")
    b5 = _conv_bn(b5, c5, 5, name=f"{name}_5x5")
    bp = MaxPooling2D((3, 3), strides=(1, 1), border_mode="same")(x)
    bp = _conv_bn(bp, pp, 1, name=f"{name}_pool")
    return merge([b1, b3, b5, bp], mode="concat", concat_axis=-1)


def inception_v1(class_num: int = 1000,
                 input_shape: Sequence[int] = (224, 224, 3),
                 generator: Optional[torch.Generator] = None) -> Model:
    """GoogLeNet / Inception-v1, the BN variant."""
    inp = Input(shape=tuple(input_shape), name="input")
    x = _conv_bn(inp, 64, 7, strides=2, name="stem1")
    x = MaxPooling2D((3, 3), strides=(2, 2), border_mode="same")(x)
    x = _conv_bn(x, 64, 1, name="stem2")
    x = _conv_bn(x, 192, 3, name="stem3")
    x = MaxPooling2D((3, 3), strides=(2, 2), border_mode="same")(x)
    x = _inception_block(x, 64, 96, 128, 16, 32, 32, name="3a")
    x = _inception_block(x, 128, 128, 192, 32, 96, 64, name="3b")
    x = MaxPooling2D((3, 3), strides=(2, 2), border_mode="same")(x)
    x = _inception_block(x, 192, 96, 208, 16, 48, 64, name="4a")
    x = _inception_block(x, 160, 112, 224, 24, 64, 64, name="4b")
    x = _inception_block(x, 128, 128, 256, 24, 64, 64, name="4c")
    x = _inception_block(x, 112, 144, 288, 32, 64, 64, name="4d")
    x = _inception_block(x, 256, 160, 320, 32, 128, 128, name="4e")
    x = MaxPooling2D((3, 3), strides=(2, 2), border_mode="same")(x)
    x = _inception_block(x, 256, 160, 320, 32, 128, 128, name="5a")
    x = _inception_block(x, 384, 192, 384, 48, 128, 128, name="5b")
    x = GlobalAveragePooling2D()(x)
    x = Dropout(0.4)(x)
    x = Dense(class_num, name="fc")(x)
    return _built(inp, x, "inception_v1", generator)


# -------------------------------------------------------------- MobileNet --

def mobilenet(class_num: int = 1000,
              input_shape: Sequence[int] = (224, 224, 3),
              alpha: float = 1.0,
              generator: Optional[torch.Generator] = None) -> Model:
    """MobileNet-v1 over separable convolutions."""
    def c(f):
        return max(8, int(f * alpha))

    inp = Input(shape=tuple(input_shape), name="input")
    x = _conv_bn(inp, c(32), 3, strides=2, name="stem")
    cfg = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
           (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
           (1024, 1)]
    for i, (f, s) in enumerate(cfg):
        x = SeparableConvolution2D(c(f), 3, 3, subsample=(s, s),
                                   border_mode="same", bias=False,
                                   name=f"sep{i}")(x)
        x = BatchNormalization(name=f"sep{i}_bn")(x)
        x = Activation("relu")(x)
    x = GlobalAveragePooling2D()(x)
    x = Dense(class_num, name="fc")(x)
    return _built(inp, x, "mobilenet", generator)


# ------------------------------------------------------------------- VGG --

def vgg16(class_num: int = 1000,
          input_shape: Sequence[int] = (224, 224, 3),
          generator: Optional[torch.Generator] = None) -> Model:
    """VGG-16."""
    inp = Input(shape=tuple(input_shape), name="input")
    x = inp
    for block, (reps, f) in enumerate(
            [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]):
        for r in range(reps):
            x = Convolution2D(f, 3, 3, border_mode="same", activation="relu",
                              name=f"b{block}c{r}")(x)
        x = MaxPooling2D((2, 2))(x)
    x = Flatten()(x)
    x = Dense(4096, activation="relu")(x)
    x = Dropout(0.5)(x)
    x = Dense(4096, activation="relu")(x)
    x = Dropout(0.5)(x)
    x = Dense(class_num, name="fc")(x)
    return _built(inp, x, "vgg16", generator)


_BUILDERS = {
    "resnet-50": resnet50,
    "inception-v1": inception_v1,
    "mobilenet": mobilenet,
    "vgg-16": vgg16,
}

# Per-model preprocessing configs (mean/std and crop size per
# architecture), the JAX package's
PREPROCESS_CONFIG = {
    "resnet-50": {"size": 224, "mean": (123.68, 116.779, 103.939),
                  "std": (1.0, 1.0, 1.0)},
    "inception-v1": {"size": 224, "mean": (123.68, 116.779, 103.939),
                     "std": (1.0, 1.0, 1.0)},
    "mobilenet": {"size": 224, "mean": (123.68, 116.78, 103.94),
                  "std": (58.624, 57.344, 57.6)},
    "vgg-16": {"size": 224, "mean": (123.68, 116.779, 103.939),
               "std": (1.0, 1.0, 1.0)},
}


@register_model
class ImageClassifier(ZooModel):
    """Built-in image-classification model: one of ``_BUILDERS`` by name,
    weights on ``device`` (default ``cuda``)."""

    def __init__(self, model_name: str = "resnet-50", class_num: int = 1000,
                 input_shape: Optional[Sequence[int]] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device=device, generator=generator)
        if model_name not in _BUILDERS:
            raise ValueError(f"unknown model {model_name}; "
                             f"available: {sorted(_BUILDERS)}")
        self.model_name = model_name
        self.class_num = class_num
        cfg = PREPROCESS_CONFIG[model_name]
        self.input_shape = tuple(input_shape or (cfg["size"], cfg["size"], 3))
        self.model = _BUILDERS[model_name](
            class_num, self.input_shape,
            generator=self.generator).to(self.device)

    def config(self):
        return {"model_name": self.model_name, "class_num": self.class_num,
                "input_shape": list(self.input_shape)}

    def preprocessing(self):
        """The architecture's inference preprocessing chain."""
        from analytics_zoo_tpu_torch.data.image import (
            ImageAspectScale, ImageCenterCrop, ImageChannelNormalize,
            ImageSetToSample)

        cfg = PREPROCESS_CONFIG[self.model_name]
        size = self.input_shape[0]
        return (ImageAspectScale(int(size * 256 / 224))
                | ImageCenterCrop(size, size)
                | ImageChannelNormalize(*cfg["mean"], *cfg["std"])
                | ImageSetToSample())

    def predict_image_set(self, image_set, batch_size: int = 32,
                          top_k: int = 1) -> np.ndarray:
        """Classify an ImageSet -> (N, top_k) class indices (0-based),
        through ``preprocessing`` and ``predict`` (which needs
        ``compile``, as in the JAX package)."""
        ims = image_set.transform(self.preprocessing())
        x, _ = ims.to_arrays()
        logits = self.model.predict(x, batch_size=batch_size)
        return np.argsort(-logits, axis=-1)[:, :top_k]
