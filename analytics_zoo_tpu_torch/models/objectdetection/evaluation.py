"""Detection evaluation: VOC-style mean average precision, copied from
the JAX package's ``models/objectdetection/evaluation.py``.

Host-side numpy (evaluation is not a hot path): greedy matching of
score-ranked detections to ground truth at an IoU threshold, AP by either
11-point interpolation (VOC2007) or the continuous area method.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def _iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * \
        np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * \
        np.clip(b[:, 3] - b[:, 1], 0, None)
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)


def average_precision(recalls: np.ndarray, precisions: np.ndarray,
                      use_07_metric: bool = False) -> float:
    """AP from a PR curve (reference MeanAveragePrecision.computeAP)."""
    if use_07_metric:
        ap = 0.0
        for t in np.linspace(0, 1, 11):
            mask = recalls >= t
            ap += (precisions[mask].max() if mask.any() else 0.0) / 11.0
        return float(ap)
    mrec = np.concatenate([[0.0], recalls, [1.0]])
    mpre = np.concatenate([[0.0], precisions, [0.0]])
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    idx = np.nonzero(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


class MeanAveragePrecision:
    """Accumulate per-image detections and compute mAP
    (reference MeanAveragePrecision.scala; PascalVocEvaluator drives it
    per-class over the VOC val set)."""

    def __init__(self, num_classes: int, iou_threshold: float = 0.5,
                 use_07_metric: bool = False):
        self.num_classes = num_classes
        self.iou_threshold = iou_threshold
        self.use_07 = use_07_metric
        # per class: list of (score, is_tp); gt counts
        self._dets: Dict[int, List[Tuple[float, bool]]] = \
            {c: [] for c in range(1, num_classes + 1)}
        self._gt_count = {c: 0 for c in range(1, num_classes + 1)}

    def add(self, det_boxes, det_scores, det_labels,
            gt_boxes, gt_labels) -> None:
        det_boxes = np.asarray(det_boxes, np.float32).reshape(-1, 4)
        det_scores = np.asarray(det_scores, np.float32).ravel()
        det_labels = np.asarray(det_labels).ravel()
        gt_boxes = np.asarray(gt_boxes, np.float32).reshape(-1, 4)
        gt_labels = np.asarray(gt_labels).ravel()
        for c in range(1, self.num_classes + 1):
            gt_c = gt_boxes[gt_labels == c]
            self._gt_count[c] += len(gt_c)
            sel = det_labels == c
            boxes_c = det_boxes[sel]
            scores_c = det_scores[sel]
            order = np.argsort(-scores_c)
            matched = np.zeros(len(gt_c), bool)
            for i in order:
                if len(gt_c) == 0:
                    self._dets[c].append((float(scores_c[i]), False))
                    continue
                ious = _iou_np(boxes_c[i:i + 1], gt_c)[0]
                j = int(np.argmax(ious))
                if ious[j] >= self.iou_threshold and not matched[j]:
                    matched[j] = True
                    self._dets[c].append((float(scores_c[i]), True))
                else:
                    self._dets[c].append((float(scores_c[i]), False))

    def per_class_ap(self) -> Dict[int, float]:
        aps = {}
        for c, dets in self._dets.items():
            npos = self._gt_count[c]
            if npos == 0:
                continue
            if not dets:
                aps[c] = 0.0
                continue
            dets_sorted = sorted(dets, key=lambda t: -t[0])
            tps = np.asarray([tp for _, tp in dets_sorted], np.float32)
            fps = 1.0 - tps
            tp_cum = np.cumsum(tps)
            fp_cum = np.cumsum(fps)
            recalls = tp_cum / npos
            precisions = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
            aps[c] = average_precision(recalls, precisions, self.use_07)
        return aps

    def result(self) -> float:
        aps = self.per_class_ap()
        return float(np.mean(list(aps.values()))) if aps else 0.0


class PascalVocEvaluator(MeanAveragePrecision):
    """VOC-2007 protocol (11-point AP) over the 20 VOC classes
    (reference PascalVocEvaluator.scala)."""

    CLASSES = ("aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
               "car", "cat", "chair", "cow", "diningtable", "dog", "horse",
               "motorbike", "person", "pottedplant", "sheep", "sofa",
               "train", "tvmonitor")

    def __init__(self, iou_threshold: float = 0.5):
        super().__init__(num_classes=len(self.CLASSES),
                         iou_threshold=iou_threshold, use_07_metric=True)

    def summary(self) -> Dict[str, float]:
        aps = self.per_class_ap()
        out = {self.CLASSES[c - 1]: ap for c, ap in aps.items()}
        out["mAP"] = self.result()
        return out
