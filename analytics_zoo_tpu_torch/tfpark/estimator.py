"""TFEstimator — the model_fn-style custom-loop estimator
(reference pyzoo/zoo/tfpark/estimator.py:30,47,116: a tf.estimator
wrapper whose ``model_fn(features, labels, mode, params)`` returns an
``EstimatorSpec``, trained/evaluated/predicted from ``input_fn``s).

The JAX package's module on the port's ``train.Estimator``: no
graph/session/ZooOptimizer dance — the model_fn is plain Python that
builds a Layer-protocol model and declares the loss/optimizer for the
requested mode; the spec lowers onto the Estimator (on the card, one
captured CUDA graph per step).  Custom
training logic lives in the spec's ``loss`` (any callable
``loss(y_true, y_pred) -> scalar``), custom prediction post-processing
in ``predictions_fn`` — the same degrees of freedom the reference's
EstimatorSpec train_op/predictions fields expose, minus the two-runtime
choreography (TFTrainingHelperV2.scala:53-98 is obsolete here).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


class ModeKeys:
    """tf.estimator.ModeKeys equivalent."""

    TRAIN = "train"
    EVAL = "eval"
    PREDICT = "predict"


class EstimatorSpec:
    """What a model_fn returns for a given mode.

    ``model``: a Layer-protocol model producing predictions from the
    features.  ``loss``: string or callable objective (TRAIN/EVAL).
    ``optimizer``: string or optimizer object (TRAIN).
    ``metrics``: metric names/objects (EVAL).  ``predictions_fn``:
    optional ``f(np.ndarray) -> np.ndarray`` applied to raw predictions
    (PREDICT).
    """

    def __init__(self, mode: str, model=None, loss=None, optimizer="adam",
                 metrics: Optional[Sequence] = None,
                 predictions_fn: Optional[Callable] = None,
                 grad_clip_norm: Optional[float] = None,
                 grad_accum_steps: int = 1):
        if model is None:
            raise ValueError("EstimatorSpec needs a model")
        if mode in (ModeKeys.TRAIN, ModeKeys.EVAL) and loss is None:
            raise ValueError(f"mode {mode!r} needs a loss")
        self.mode = mode
        self.model = model
        self.loss = loss
        self.optimizer = optimizer
        self.metrics = list(metrics or [])
        self.predictions_fn = predictions_fn
        self.grad_clip_norm = grad_clip_norm
        self.grad_accum_steps = grad_accum_steps


def _resolve_input(data) -> Tuple[List[np.ndarray], Optional[np.ndarray]]:
    """input_fn result → (features list, labels or None).  Accepts
    (x, y) tuples, bare arrays/lists (predict), or TFDataset."""
    from analytics_zoo_tpu_torch.tfpark.tf_dataset import TFDataset

    if isinstance(data, TFDataset):
        feats = list(data.features)
        labels = data.labels[0] if data.labels else None
        return feats, labels
    if isinstance(data, tuple) and len(data) == 2:
        x, y = data
        xs = list(x) if isinstance(x, (list, tuple)) else [np.asarray(x)]
        return [np.asarray(a) for a in xs], np.asarray(y)
    xs = list(data) if isinstance(data, (list, tuple)) else [np.asarray(data)]
    return [np.asarray(a) for a in xs], None


class TFEstimator:
    """train/evaluate/predict driven by ``input_fn``s over a model_fn.

    ``model_fn(features, labels, mode, params) -> EstimatorSpec`` —
    ``features``/``labels`` are the arrays the input_fn produced (so the
    model_fn can shape itself on them), ``params`` the hyper-parameter
    dict given at construction (reference estimator.py:47-99 semantics).
    """

    def __init__(self, model_fn: Callable, model_dir: Optional[str] = None,
                 params: Optional[Dict[str, Any]] = None):
        self.model_fn = model_fn
        self.model_dir = model_dir
        self.params = dict(params or {})
        self._train_est = None      # the Estimator (TRAIN spec)
        self._spec = None

    @classmethod
    def from_model_fn(cls, model_fn, model_dir=None, params=None):
        return cls(model_fn, model_dir=model_dir, params=params)

    # ------------------------------------------------------------------
    def _build(self, features, labels, mode) -> None:
        """Build (once) the underlying Estimator from the TRAIN
        spec; EVAL/PREDICT reuse its weights like tf.estimator reuses
        the checkpoint."""
        if self._train_est is not None:
            return
        from analytics_zoo_tpu_torch.train.estimator import Estimator

        spec = self.model_fn(features, labels, mode, self.params)
        if not isinstance(spec, EstimatorSpec):
            raise TypeError("model_fn must return an EstimatorSpec, got "
                            f"{type(spec).__name__}")
        self._spec = spec
        self._train_est = Estimator(
            spec.model, optimizer=spec.optimizer,
            # a PREDICT-only spec has no loss; the placeholder is never
            # evaluated on the predict path
            loss=spec.loss or "mse",
            metrics=spec.metrics, grad_clip_norm=spec.grad_clip_norm,
            grad_accum_steps=spec.grad_accum_steps)
        if self.model_dir:
            # tf.estimator semantics: model_dir checkpoints resume
            # training and serve predict-without-train (restored when the
            # model is built, at the first train/evaluate/predict call)
            self._train_est.set_checkpoint(self.model_dir)
            if self._train_est._ckpt_mgr.latest_step() is not None:
                self._train_est.load_checkpoint(self.model_dir)

    # ------------------------------------------------------------------
    def train(self, input_fn: Callable, steps: Optional[int] = None,
              batch_size: int = 32, epochs: int = 1):
        """Train from ``input_fn() -> (features, labels) | TFDataset``.
        ``steps`` caps the number of optimizer steps (reference
        train(input_fn, steps))."""
        data = input_fn()
        xs, y = _resolve_input(data)
        if y is None:
            raise ValueError("train input_fn must yield labels")
        self._build(xs, y, ModeKeys.TRAIN)
        est = self._train_est
        if steps is None:
            est.fit(xs, y, batch_size=batch_size,
                    epochs=est.finished_epochs + epochs, verbose=False)
            return self
        # exact step budget (tf.estimator train(steps) semantics): whole
        # epochs, then one trimmed pass for the remainder
        spe = max(1, len(y) // max(batch_size, 1))
        full, rem = divmod(steps, spe)
        if full:
            est.fit(xs, y, batch_size=batch_size,
                    epochs=est.finished_epochs + full, verbose=False)
        if rem:
            cut = rem * batch_size
            est.fit([a[:cut] for a in xs], y[:cut], batch_size=batch_size,
                    epochs=est.finished_epochs + 1, verbose=False)
        return self

    def evaluate(self, input_fn: Callable, eval_methods: Optional[Sequence] = None,
                 batch_size: int = 32) -> Dict[str, float]:
        data = input_fn()
        xs, y = _resolve_input(data)
        if y is None:
            raise ValueError("evaluate input_fn must yield labels")
        self._build(xs, y, ModeKeys.EVAL)
        # an EVAL-mode spec may carry extra metrics
        spec = self.model_fn(xs, y, ModeKeys.EVAL, self.params)
        if spec.metrics and not self._train_est.metrics:
            from analytics_zoo_tpu_torch.nn import metrics as metrics_lib
            self._train_est.metrics = [metrics_lib.get(m)
                                       for m in spec.metrics]
        return self._train_est.evaluate(xs, y, batch_size=batch_size)

    def predict(self, input_fn: Callable, batch_size: int = 32) -> np.ndarray:
        data = input_fn()
        xs, _ = _resolve_input(data)
        if self._train_est is None:
            self._build(xs, None, ModeKeys.PREDICT)
        preds = self._train_est.predict(xs, batch_size=batch_size)
        spec = self.model_fn(xs, None, ModeKeys.PREDICT, self.params)
        if spec.predictions_fn is not None:
            preds = spec.predictions_fn(preds)
        return preds

    # ------------------------------------------------------------------
    @property
    def estimator(self):
        """The underlying train.Estimator (weights, checkpoints)."""
        if self._train_est is None:
            raise RuntimeError("call train()/evaluate()/predict() first")
        return self._train_est
