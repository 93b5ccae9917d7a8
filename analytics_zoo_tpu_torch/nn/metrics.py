"""Evaluation metrics, the JAX package's ``nn/metrics.py`` in PyTorch.

A metric is a pair of functions, so evaluation sums statistics on the
device batch by batch and reads them back once:

    update(y_true, y_pred) -> {name: tensor}   (summable across batches)
    finalize(stats)        -> scalar tensor

``AUC`` is not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Union

import torch


def _tensor(y, like):
    return torch.as_tensor(y, device=like.device)


def _count(n, like):
    """A float count on ``like``'s device, made there (no host copy)."""
    return torch.full((), float(n), dtype=torch.float32, device=like.device)


class Metric:
    name = "metric"

    def update(self, y_true, y_pred) -> Dict[str, Any]:
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

    def update(self, y_true, y_pred):
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
        correct = torch.sum((pred == labels).to(torch.float32))
        return {"correct": correct, "total": _count(pred.shape[0], y_pred)}

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

    def update(self, y_true, y_pred):
        y_true = _tensor(y_true, y_pred)
        labels = y_true.to(torch.int64).reshape(y_true.shape[0], -1)[:, 0]
        if not self.zero_based:
            labels = labels - 1
        top5 = torch.topk(y_pred, 5, dim=-1).indices
        hit = torch.any(top5 == labels[:, None], dim=-1)
        return {"correct": torch.sum(hit.to(torch.float32)),
                "total": _count(labels.shape[0], y_pred)}

    def finalize(self, stats):
        return stats["correct"] / torch.clamp(stats["total"], min=1.0)


class MAE(Metric):
    name = "mae"

    def update(self, y_true, y_pred):
        y_true = _tensor(y_true, y_pred).to(y_pred.dtype)
        err = torch.abs(y_pred - y_true).reshape(y_true.shape[0], -1)
        return {"abs_sum": torch.sum(err),
                "total": _count(err.numel(), y_pred)}

    def finalize(self, stats):
        return stats["abs_sum"] / torch.clamp(stats["total"], min=1.0)


class Loss(Metric):
    """Wraps the model loss as a metric for eval reporting."""

    name = "loss"

    def __init__(self, loss_fn):
        from analytics_zoo_tpu_torch.nn import objectives

        self.loss_fn = objectives.get(loss_fn)

    def update(self, y_true, y_pred):
        n = float(y_pred.shape[0])
        return {"loss_sum": self.loss_fn(y_true, y_pred) * n,
                "total": _count(n, y_pred)}

    def finalize(self, stats):
        return stats["loss_sum"] / torch.clamp(stats["total"], min=1.0)


_REGISTRY: Dict[str, Callable[[], Metric]] = {
    "accuracy": Accuracy,
    "acc": Accuracy,
    "binary_accuracy": BinaryAccuracy,
    "categorical_accuracy": CategoricalAccuracy,
    "sparse_categorical_accuracy": SparseCategoricalAccuracy,
    "top5accuracy": Top5Accuracy,
    "top5_accuracy": Top5Accuracy,
    "mae": MAE,
}


def get(metric: Union[str, Metric]) -> Metric:
    if isinstance(metric, Metric):
        return metric
    key = metric.lower()
    if key not in _REGISTRY:
        raise ValueError(f"unknown metric {metric!r}; "
                         f"known: {sorted(_REGISTRY)}")
    return _REGISTRY[key]()
