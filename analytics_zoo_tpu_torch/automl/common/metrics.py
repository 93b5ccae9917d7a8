"""Regression metrics for AutoML model selection
(reference automl/common/metrics.py, 245 LoC)."""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np


def _flat(y_true, y_pred):
    y_true = np.asarray(y_true, np.float64).reshape(-1)
    y_pred = np.asarray(y_pred, np.float64).reshape(-1)
    if y_true.shape != y_pred.shape:
        raise ValueError(f"shape mismatch {y_true.shape} vs {y_pred.shape}")
    return y_true, y_pred


def mean_squared_error(y_true, y_pred) -> float:
    y_true, y_pred = _flat(y_true, y_pred)
    return float(np.mean((y_true - y_pred) ** 2))


def root_mean_squared_error(y_true, y_pred) -> float:
    return float(np.sqrt(mean_squared_error(y_true, y_pred)))


def mean_absolute_error(y_true, y_pred) -> float:
    y_true, y_pred = _flat(y_true, y_pred)
    return float(np.mean(np.abs(y_true - y_pred)))


def r_square(y_true, y_pred) -> float:
    y_true, y_pred = _flat(y_true, y_pred)
    ss_res = np.sum((y_true - y_pred) ** 2)
    ss_tot = np.sum((y_true - np.mean(y_true)) ** 2)
    return float(1.0 - ss_res / ss_tot) if ss_tot > 0 else 0.0


def symmetric_mean_absolute_percentage_error(y_true, y_pred) -> float:
    y_true, y_pred = _flat(y_true, y_pred)
    denom = (np.abs(y_true) + np.abs(y_pred)) / 2.0
    denom = np.where(denom == 0, 1.0, denom)
    return float(100.0 * np.mean(np.abs(y_true - y_pred) / denom))


def mean_absolute_percentage_error(y_true, y_pred) -> float:
    y_true, y_pred = _flat(y_true, y_pred)
    denom = np.where(np.abs(y_true) < 1e-8, 1e-8, np.abs(y_true))
    return float(100.0 * np.mean(np.abs((y_true - y_pred) / denom)))


_METRICS: Dict[str, Callable] = {
    "mse": mean_squared_error,
    "mean_squared_error": mean_squared_error,
    "rmse": root_mean_squared_error,
    "mae": mean_absolute_error,
    "mean_absolute_error": mean_absolute_error,
    "r2": r_square,
    "r_square": r_square,
    "smape": symmetric_mean_absolute_percentage_error,
    "mape": mean_absolute_percentage_error,
}

#: metrics where larger is better (everything else minimises)
_MAXIMIZE = {"r2", "r_square"}


class Evaluator:
    """Static metric dispatch (reference Evaluator.evaluate)."""

    @staticmethod
    def evaluate(metric: str, y_true, y_pred) -> float:
        m = metric.lower()
        if m not in _METRICS:
            raise ValueError(f"unknown metric {metric!r}; "
                             f"known: {sorted(_METRICS)}")
        return _METRICS[m](y_true, y_pred)

    @staticmethod
    def get_metric_mode(metric: str) -> str:
        """'max' for reward-style metrics (r2), else 'min'."""
        return "max" if metric.lower() in _MAXIMIZE else "min"
