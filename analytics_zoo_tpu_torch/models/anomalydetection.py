"""Anomaly detection: a stacked-LSTM forecaster over unrolled windows,
and detection by the largest absolute errors or a threshold.

``unroll`` and ``detect_anomalies`` are the JAX package's (numpy, on the
host); ``AnomalyDetector`` is built as it builds it, with its explicit
layer names (``ad_lstm{i}``, ``ad_drop{i}``, ``ad_out``), so weights
carry across by name.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.models.common import register_model
from analytics_zoo_tpu_torch.models.recommendation import ServedModel
from analytics_zoo_tpu_torch.nn import Sequential
from analytics_zoo_tpu_torch.nn.layers.core import Dense, Dropout
from analytics_zoo_tpu_torch.nn.layers.recurrent import LSTM


def unroll(data: np.ndarray, unroll_length: int,
           predict_step: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Sliding windows: x[i] = data[i : i+L], y[i] = data[i+L+step-1,
    0]."""
    data = np.asarray(data, np.float32)
    if data.ndim == 1:
        data = data[:, None]
    n = len(data) - unroll_length - predict_step + 1
    if n <= 0:
        raise ValueError(
            f"series of {len(data)} too short for unroll_length "
            f"{unroll_length} + predict_step {predict_step}")
    x = np.stack([data[i:i + unroll_length] for i in range(n)])
    y = data[unroll_length + predict_step - 1:
             unroll_length + predict_step - 1 + n, 0]
    return x, y.astype(np.float32)


def detect_anomalies(y_true: np.ndarray, y_pred: np.ndarray,
                     anomaly_size: Optional[int] = None,
                     threshold: Optional[float] = None) -> np.ndarray:
    """Indices of anomalous points: the ``anomaly_size`` largest absolute
    errors (1% of the points by default), or every point whose absolute
    error exceeds ``threshold``."""
    err = np.abs(np.asarray(y_true).ravel() - np.asarray(y_pred).ravel())
    if threshold is not None:
        return np.nonzero(err > threshold)[0]
    if anomaly_size is None:
        anomaly_size = max(1, int(0.01 * err.size))
    return np.argsort(-err)[:anomaly_size]


@register_model
class AnomalyDetector(ServedModel):
    """LSTMs over unrolled windows, each followed by dropout, and a
    Dense(1) next-value forecast.  ``feature_shape`` = (unroll_length,
    feature_num); the last LSTM returns its last output only."""

    def __init__(self, feature_shape: Sequence[int],
                 hidden_layers: Sequence[int] = (8, 32, 15),
                 dropouts: Sequence[float] = (0.2, 0.2, 0.2),
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(device=device, generator=generator)
        if len(hidden_layers) != len(dropouts):
            raise ValueError("hidden_layers and dropouts must align")
        self.feature_shape = tuple(feature_shape)
        self.hidden_layers = tuple(hidden_layers)
        self.dropouts = tuple(dropouts)
        layers: List = []
        for i, (h, p) in enumerate(zip(hidden_layers, dropouts)):
            last = i == len(hidden_layers) - 1
            kw = {"input_shape": self.feature_shape} if i == 0 else {}
            layers.append(LSTM(h, return_sequences=not last,
                               name=f"ad_lstm{i}", **kw))
            layers.append(Dropout(p, name=f"ad_drop{i}"))
        layers.append(Dense(1, name="ad_out"))
        self._finish(Sequential(layers, name="anomaly_detector"))

    def config(self):
        return {"feature_shape": list(self.feature_shape),
                "hidden_layers": list(self.hidden_layers),
                "dropouts": list(self.dropouts)}

    def detect_anomalies(self, y_true, y_pred, anomaly_size=None,
                         threshold=None):
        return detect_anomalies(y_true, y_pred, anomaly_size, threshold)
