"""Evaluation metrics, the JAX package's ``nn/metrics.py`` in PyTorch.

A metric is a pair of functions, so evaluation sums statistics on the
device batch by batch and reads them back once:

    update(y_true, y_pred, mask=None) -> {name: tensor}   (summable)
    finalize(stats)                   -> scalar tensor

``mask`` is the JAX package's: a (B,) 0/1 float that excludes the rows
padded onto a short last batch.  ``AUC`` keeps a fixed-resolution TP/FP
histogram over thresholds, so its statistics sum across batches too.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Union

import torch


def _tensor(y, like):
    return torch.as_tensor(y, device=like.device)


def _count(n, like):
    """A float count on ``like``'s device, made there (no host copy)."""
    return torch.full((), float(n), dtype=torch.float32, device=like.device)


def _mask(mask, rows: int, like):
    """``mask`` as f32 on ``like``'s device, or all ones."""
    if mask is None:
        return torch.ones((rows,), dtype=torch.float32, device=like.device)
    return torch.as_tensor(mask, device=like.device).to(torch.float32)


class Metric:
    name = "metric"

    def update(self, y_true, y_pred, mask=None) -> Dict[str, Any]:
        """``mask`` (B,) float 0/1 excludes padded rows."""
        raise NotImplementedError

    def finalize(self, stats) -> torch.Tensor:
        raise NotImplementedError


class Accuracy(Metric):
    """Top-1 accuracy with auto input handling: integer labels vs class
    scores, one-hot targets vs class scores, or binary labels vs a single
    probability (threshold 0.5)."""

    name = "accuracy"

    def __init__(self, zero_based_label: bool = True):
        self.zero_based = zero_based_label

    def update(self, y_true, y_pred, mask=None):
        y_true = _tensor(y_true, y_pred)
        if y_pred.ndim >= 2 and y_pred.shape[-1] > 1:
            pred = torch.argmax(y_pred, dim=-1)
            labels = y_true.to(torch.int64).reshape(y_true.shape[0], -1)[:, 0]
            if not self.zero_based:
                labels = labels - 1
            if y_true.ndim >= 2 and y_true.shape[-1] == y_pred.shape[-1]:
                labels = torch.argmax(y_true, dim=-1)   # one-hot targets
        else:
            pred = (y_pred.reshape(y_pred.shape[0], -1)[:, 0] > 0.5).to(
                torch.int64)
            labels = y_true.reshape(y_true.shape[0], -1)[:, 0].to(torch.int64)
        m = _mask(mask, pred.shape[0], y_pred)
        correct = torch.sum((pred == labels).to(torch.float32) * m)
        return {"correct": correct, "total": torch.sum(m)}

    def finalize(self, stats):
        return stats["correct"] / torch.clamp(stats["total"], min=1.0)


class BinaryAccuracy(Accuracy):
    name = "binary_accuracy"


class CategoricalAccuracy(Accuracy):
    name = "categorical_accuracy"


class SparseCategoricalAccuracy(Accuracy):
    name = "sparse_categorical_accuracy"


class Top5Accuracy(Metric):
    """Share of rows whose label is among the five highest scores
    (ImageNet's metric); 1-based labels with ``zero_based_label=False``."""

    name = "top5_accuracy"

    def __init__(self, zero_based_label: bool = True):
        self.zero_based = zero_based_label

    def update(self, y_true, y_pred, mask=None):
        y_true = _tensor(y_true, y_pred)
        labels = y_true.to(torch.int64).reshape(y_true.shape[0], -1)[:, 0]
        if not self.zero_based:
            labels = labels - 1
        top5 = torch.topk(y_pred, 5, dim=-1).indices
        hit = torch.any(top5 == labels[:, None], dim=-1)
        m = _mask(mask, labels.shape[0], y_pred)
        return {"correct": torch.sum(hit.to(torch.float32) * m),
                "total": torch.sum(m)}

    def finalize(self, stats):
        return stats["correct"] / torch.clamp(stats["total"], min=1.0)


class MAE(Metric):
    name = "mae"

    def update(self, y_true, y_pred, mask=None):
        y_true = _tensor(y_true, y_pred).to(y_pred.dtype)
        err = torch.abs(y_pred - y_true).reshape(y_true.shape[0], -1)
        m = _mask(mask, err.shape[0], y_pred)
        return {"abs_sum": torch.sum(err * m[:, None]),
                "total": torch.sum(m) * err.shape[1]}

    def finalize(self, stats):
        return stats["abs_sum"] / torch.clamp(stats["total"], min=1.0)


class Loss(Metric):
    """Wraps the model loss as a metric for eval reporting."""

    name = "loss"

    def __init__(self, loss_fn):
        from analytics_zoo_tpu_torch.nn import objectives

        self.loss_fn = objectives.get(loss_fn)

    def update(self, y_true, y_pred, mask=None):
        n = float(y_pred.shape[0])
        return {"loss_sum": self.loss_fn(y_true, y_pred) * n,
                "total": _count(n, y_pred)}

    def finalize(self, stats):
        return stats["loss_sum"] / torch.clamp(stats["total"], min=1.0)


class AUC(Metric):
    """Area under the ROC curve from a threshold histogram: the JAX
    package's ``num_thresholds`` points of ``linspace(0, 1)``, a score
    counted positive at a threshold when ``>=`` it, and the trapezoid
    over the descending false-positive rates.  The counts are f32 sums,
    exact while a threshold's count stays below 2^24 rows."""

    name = "auc"

    def __init__(self, num_thresholds: int = 200):
        self.num_thresholds = num_thresholds

    def update(self, y_true, y_pred, mask=None):
        y_true = _tensor(y_true, y_pred)
        scores = y_pred.reshape(y_pred.shape[0], -1)[:, 0]
        labels = y_true.reshape(y_true.shape[0], -1)[:, 0].to(torch.float32)
        m = _mask(mask, labels.shape[0], y_pred)
        thresholds = torch.linspace(0.0, 1.0, self.num_thresholds,
                                    device=y_pred.device)
        pred_pos = ((scores[None, :] >= thresholds[:, None]).to(
            torch.float32) * m[None, :])
        tp = torch.sum(pred_pos * labels[None, :], dim=1)
        fp = torch.sum(pred_pos * (1.0 - labels)[None, :], dim=1)
        pos = torch.sum(labels * m)
        return {"tp": tp, "fp": fp, "pos": pos, "neg": torch.sum(m) - pos}

    def finalize(self, stats):
        tpr = stats["tp"] / torch.clamp(stats["pos"], min=1.0)
        fpr = stats["fp"] / torch.clamp(stats["neg"], min=1.0)
        # thresholds ascend, so fpr and tpr descend
        return torch.sum((fpr[:-1] - fpr[1:]) * (tpr[:-1] + tpr[1:]) / 2.0)


_REGISTRY: Dict[str, Callable[[], Metric]] = {
    "accuracy": Accuracy,
    "acc": Accuracy,
    "binary_accuracy": BinaryAccuracy,
    "categorical_accuracy": CategoricalAccuracy,
    "sparse_categorical_accuracy": SparseCategoricalAccuracy,
    "top5accuracy": Top5Accuracy,
    "top5_accuracy": Top5Accuracy,
    "mae": MAE,
    "auc": AUC,
}


def get(metric: Union[str, Metric]) -> Metric:
    if isinstance(metric, Metric):
        return metric
    key = metric.lower()
    if key not in _REGISTRY:
        raise ValueError(f"unknown metric {metric!r}; "
                         f"known: {sorted(_REGISTRY)}")
    return _REGISTRY[key]()
