"""SSD object detector: a VGG-style trunk, six feature maps with (loc,
conf) convolution heads, the priors, and decode plus per-class NMS — the
JAX package's ``models/objectdetection/ssd.py``.

The net is channels-last (NHWC), built in the JAX function's order, so
its layer names and leaves match the JAX tree.  Each head's output is
flattened from its logical NHWC view to (B, H * W * k, 4 | C), in (row,
column, anchor) order, the order ``generate_priors`` lists the priors
in (a reshape of the logical view, whatever the memory format).

Target assignment (``SSDTargetAssigner``) runs on the device over a
whole batch.  ``ObjectDetector.detect`` runs one program per batch
signature — the forward, decode, softmax and the per-class NMS of
``nms.class_nms_batch`` — captured as one CUDA graph on the card
(``core/graphs.py``), as the JAX package jits its post-processing; a
ragged last batch is padded to the batch size and its padding rows
dropped.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.core import graphs
from analytics_zoo_tpu_torch.models.common import ZooModel, register_model
from analytics_zoo_tpu_torch.models.objectdetection.bbox import (
    as_tensor, decode_boxes, generate_priors, match_priors_batch)
from analytics_zoo_tpu_torch.models.objectdetection.loss import MultiBoxLoss
from analytics_zoo_tpu_torch.models.objectdetection.nms import class_nms_batch
from analytics_zoo_tpu_torch.nn import Input, Model
from analytics_zoo_tpu_torch.nn.layers.convolutional import Convolution2D
from analytics_zoo_tpu_torch.nn.layers.core import Activation, Lambda
from analytics_zoo_tpu_torch.nn.layers.merge import merge
from analytics_zoo_tpu_torch.nn.layers.normalization import BatchNormalization
from analytics_zoo_tpu_torch.nn.layers.pooling import MaxPooling2D

# SSD-300 (Liu et al. 2016): the feature pyramid and prior sizes
SSD300_CONFIG = {
    "image_size": 300,
    "feature_sizes": (38, 19, 10, 5, 3, 1),
    "min_sizes": (30, 60, 111, 162, 213, 264),
    "max_sizes": (60, 111, 162, 213, 264, 315),
    "aspect_ratios": ((2,), (2, 3), (2, 3), (2, 3), (2,), (2,)),
}


def _anchors_per_cell(ars: Sequence[float]) -> int:
    return 2 + 2 * len(ars)


def _conv_block(x, filters, k, name, strides=1, padding="same"):
    x = Convolution2D(filters, k, k, subsample=(strides, strides),
                      border_mode=padding, bias=False,
                      name=f"{name}_conv")(x)
    x = BatchNormalization(name=f"{name}_bn")(x)
    return Activation("relu")(x)


def build_ssd(class_num: int, config=SSD300_CONFIG,
              width_mult: float = 1.0) -> Tuple[Model, np.ndarray]:
    """The SSD graph (unbuilt) and its priors: a Model mapping images
    (B, S, S, 3) to [loc (B, P, 4), conf (B, P, class_num)].
    ``width_mult`` scales the channel widths (at least 8)."""
    S = config["image_size"]
    fsizes = config["feature_sizes"]
    ars = config["aspect_ratios"]

    def c(f):
        return max(8, int(f * width_mult))

    inp = Input(shape=(S, S, 3), name="image")
    x = inp
    feats = []
    sizes = []  # each feature map's spatial size, tracked as built
    s = S
    # the trunk down to 38x38: three stride-2 stages (TF-SAME pools, so
    # 75 -> 38)
    for i, f in enumerate((64, 128, 256)):
        x = _conv_block(x, c(f), 3, f"stage{i}a")
        x = _conv_block(x, c(f), 3, f"stage{i}b")
        x = MaxPooling2D((2, 2), border_mode="same")(x)
        s = -(-s // 2)
    x = _conv_block(x, c(512), 3, "conv4")
    feats.append(x)
    sizes.append(s)                                     # 38
    x = MaxPooling2D((2, 2), border_mode="same")(x)
    s = -(-s // 2)
    x = _conv_block(x, c(512), 3, "conv5")
    feats.append(x)
    sizes.append(s)                                     # 19
    x = _conv_block(x, c(256), 1, "conv6r")
    x = _conv_block(x, c(512), 3, "conv6", strides=2)
    s = -(-s // 2)
    feats.append(x)
    sizes.append(s)                                     # 10
    x = _conv_block(x, c(128), 1, "conv7r")
    x = _conv_block(x, c(256), 3, "conv7", strides=2)
    s = -(-s // 2)
    feats.append(x)
    sizes.append(s)                                     # 5
    x = _conv_block(x, c(128), 1, "conv8r")
    x = _conv_block(x, c(256), 3, "conv8", strides=2)
    s = -(-s // 2)
    feats.append(x)
    sizes.append(s)                                     # 3
    x = _conv_block(x, c(128), 1, "conv9r")
    if s == 3:
        # SSD300's tail: a 3x3 VALID stride-1 convolution maps 3x3 to
        # 1x1; other sizes keep the stride-2 SAME tail (ceil(s / 2))
        x = _conv_block(x, c(256), 3, "conv9", strides=1, padding="valid")
        s = s - 2
    else:
        x = _conv_block(x, c(256), 3, "conv9", strides=2)
        s = -(-s // 2)
    feats.append(x)
    sizes.append(s)                                     # 1

    if tuple(sizes) != tuple(fsizes):
        raise ValueError(
            f"SSD trunk produces feature maps {tuple(sizes)} but config "
            f"declares feature_sizes={tuple(fsizes)}; priors would not "
            "match the head outputs")

    locs, confs = [], []
    for i, (feat, ar) in enumerate(zip(feats, ars)):
        k = _anchors_per_cell(ar)
        loc = Convolution2D(k * 4, 3, 3, border_mode="same",
                            name=f"loc{i}")(feat)
        conf = Convolution2D(k * class_num, 3, 3, border_mode="same",
                             name=f"conf{i}")(feat)
        locs.append(Lambda(lambda t: t.reshape(t.shape[0], -1, 4),
                           name=f"loc_flat{i}")(loc))
        confs.append(Lambda(
            lambda t, _c=class_num: t.reshape(t.shape[0], -1, _c),
            name=f"conf_flat{i}")(conf))
    loc_all = merge(locs, mode="concat", concat_axis=1)
    conf_all = merge(confs, mode="concat", concat_axis=1)
    model = Model(inp, [loc_all, conf_all], name="ssd")

    priors = generate_priors(fsizes, S, config["min_sizes"],
                             config["max_sizes"], ars)
    head_priors = sum(sz * sz * _anchors_per_cell(ar)
                      for sz, ar in zip(sizes, ars))
    if head_priors != priors.shape[0]:
        raise ValueError(f"head prior count {head_priors} != generated "
                         f"priors {priors.shape[0]}")
    return model, priors


class SSDTargetAssigner:
    """Padded (gt_boxes, gt_labels) batches -> per-prior targets, on
    ``device`` (default ``cuda``) over the whole batch."""

    def __init__(self, priors: np.ndarray, iou_threshold: float = 0.5,
                 device=None):
        self.priors = as_tensor(priors, device)
        self.iou_threshold = iou_threshold

    def __call__(self, gt_boxes, gt_labels):
        """(B, G, 4), (B, G) -> (B, P, 5) [loc targets | class target]: a
        numpy array for array inputs, as the JAX assigner answers, a
        tensor on the priors' device for tensor inputs."""
        host = not isinstance(gt_boxes, torch.Tensor)
        dev = self.priors.device
        boxes = as_tensor(gt_boxes, dev).to(dev)
        labels = torch.as_tensor(gt_labels).to(dev, torch.int64)
        loc, cls = match_priors_batch(boxes, labels, self.priors,
                                      self.iou_threshold)
        out = torch.cat([loc, cls[..., None].to(torch.float32)], dim=-1)
        return out.cpu().numpy() if host else out


class _DetectProgram:
    """One batch signature of ``detect``: static input rows, and the
    forward, decode, softmax and class NMS over them as one
    ``StepGraph``."""

    def __init__(self, det: "ObjectDetector", batch: int, shape, dtype,
                 thresholds):
        est = det.model.estimator
        self.static = torch.empty((batch,) + tuple(shape), dtype=dtype,
                                  device=est.device)
        priors = det.priors_t
        score_t, nms_t, max_det = thresholds

        def fn():
            with torch.no_grad():
                loc, conf = est._eval_forward([self.static])
                boxes = decode_boxes(loc, priors)
                probs = torch.softmax(conf, dim=-1)
                return class_nms_batch(boxes, probs, iou_threshold=nms_t,
                                       score_threshold=score_t,
                                       max_total=max_det)

        self.graph = graphs.StepGraph(fn, est.device,
                                      name=f"detect (batch {batch})")

    def run(self, rows: torch.Tensor):
        if self.static.is_cuda and not rows.is_cuda:
            rows = rows.pin_memory()
        self.static.copy_(rows, non_blocking=True)
        return self.graph()


@register_model
class ObjectDetector(ZooModel):
    """SSD detector with its post-processing: ``detect`` answers per
    image (boxes, scores, labels).  Weights on ``device`` (default
    ``cuda``), drawn from ``generator`` (default seeded from
    ``ZooConfig.seed``)."""

    def __init__(self, class_num: int, config=None, width_mult: float = 1.0,
                 iou_threshold: float = 0.5, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device=device, generator=generator)
        self.class_num = class_num
        self.config_dict = dict(config or SSD300_CONFIG)
        self.width_mult = width_mult
        self.iou_threshold = iou_threshold
        cfg = dict(self.config_dict)
        cfg["feature_sizes"] = tuple(cfg["feature_sizes"])
        cfg["min_sizes"] = tuple(cfg["min_sizes"])
        cfg["max_sizes"] = tuple(cfg["max_sizes"])
        cfg["aspect_ratios"] = tuple(tuple(a) for a in cfg["aspect_ratios"])
        net, self.priors = build_ssd(class_num, cfg, width_mult)
        self._finish(net)
        self.priors_t = as_tensor(self.priors, self.device)
        self.assigner = SSDTargetAssigner(self.priors, iou_threshold,
                                          device=self.device)
        self._detect_programs: Dict[tuple, _DetectProgram] = {}
        self._detect_key = None

    def config(self):
        cd = self.config_dict
        return {"class_num": self.class_num,
                "config": {k: (list(v) if isinstance(v, (tuple, list))
                               else v) for k, v in cd.items()},
                "width_mult": self.width_mult,
                "iou_threshold": self.iou_threshold}

    def loss(self, neg_pos_ratio: float = 3.0) -> MultiBoxLoss:
        return MultiBoxLoss(neg_pos_ratio=neg_pos_ratio)

    def fit_detection(self, images, gt_boxes, gt_labels, **fit_kw):
        """Train: per-prior targets assigned on the device, then ``fit``
        (numpy inputs take the host path; tensors on the device, the
        resident one)."""
        targets = self.assigner(gt_boxes, gt_labels)
        return self.model.fit(images, targets, **fit_kw)

    def _detect_program(self, batch: int, rows, thresholds
                        ) -> _DetectProgram:
        """The program of this signature, kept while the estimator whose
        forward it runs and the tensors it reads (parameters, BN state)
        stay."""
        est = self.model.estimator
        key = (id(est), tuple(p.data_ptr() for p in self.model.parameters()),
               tuple(t.data_ptr() for t in self.model.buffers()))
        if key != self._detect_key:
            self._detect_programs.clear()
            self._detect_key = key
        sig = (batch, tuple(rows.shape[1:]), rows.dtype, thresholds)
        prog = self._detect_programs.get(sig)
        if prog is None:
            prog = _DetectProgram(self, batch, rows.shape[1:], rows.dtype,
                                  thresholds)
            self._detect_programs[sig] = prog
        return prog

    def detect(self, images, batch_size: int = 8,
               score_threshold: float = 0.3, nms_threshold: float = 0.45,
               max_detections: int = 100):
        """Forward, decode and per-class NMS -> a list of (boxes (D, 4),
        scores (D,), labels (D,)) numpy arrays per image, the detections
        that scored above 0."""
        est = self.model.estimator
        if isinstance(images, torch.Tensor):
            images = images.to(torch.float32)
        else:
            images = torch.from_numpy(np.ascontiguousarray(
                np.asarray(images, np.float32)))
        est._ensure_built([images])
        self.model.train(False)
        thresholds = (float(score_threshold), float(nms_threshold),
                      int(max_detections))
        out = []
        n = int(images.shape[0])
        for s in range(0, n, batch_size):
            rows = est._padded(images, slice(s, min(s + batch_size, n)),
                               batch_size)
            prog = self._detect_program(batch_size, rows, thresholds)
            b, sc, lb = prog.run(rows)
            b, sc, lb = b.cpu().numpy(), sc.cpu().numpy(), lb.cpu().numpy()
            for i in range(min(batch_size, n - s)):
                keep = sc[i] > 0
                out.append((b[i][keep], sc[i][keep], lb[i][keep]))
        return out
