"""TimeSequencePipeline — fitted transformer + model, save/load
(reference automl/pipeline/time_sequence.py), the JAX package's module
on the port's models.  A pipeline directory holds
``feature_transformer.json``, ``pipeline.json`` and ``model.npz`` (the
JAX package's archive format, ``train/checkpoint.save_pytree``), so a
directory written by either package loads in the other."""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from analytics_zoo_tpu_torch.automl.common.metrics import Evaluator
from analytics_zoo_tpu_torch.automl.feature.time_sequence import (
    TimeSequenceFeatureTransformer)
from analytics_zoo_tpu_torch.automl.model.time_sequence import VanillaLSTM


class TimeSequencePipeline:
    """Predict/evaluate on raw DataFrames with the best found config."""

    def __init__(self, feature_transformer: TimeSequenceFeatureTransformer,
                 model, config: Dict):
        self.feature_transformer = feature_transformer
        self.model = model
        self.config = dict(config)

    def predict(self, input_df: pd.DataFrame) -> pd.DataFrame:
        x, _ = self.feature_transformer.transform(input_df, is_train=False)
        y = self.model.predict(x)
        return self.feature_transformer.post_processing(input_df, y,
                                                        is_train=False)

    def evaluate(self, input_df: pd.DataFrame, metric: str = "mse") -> float:
        x, y = self.feature_transformer.transform(input_df, is_train=True)
        pred = self.model.predict(x)
        y_true = self.feature_transformer._unscale_y(y)
        y_pred = self.feature_transformer._unscale_y(np.asarray(pred))
        return Evaluator.evaluate(metric, y_true, y_pred)

    # -- persistence -------------------------------------------------------
    def save(self, pipeline_dir: str) -> None:
        os.makedirs(pipeline_dir, exist_ok=True)
        self.feature_transformer.save(
            os.path.join(pipeline_dir, "feature_transformer.json"))
        self.model.save(os.path.join(pipeline_dir, "model.npz"))
        meta = {"config": {k: (list(v) if isinstance(v, (list, tuple))
                               else v) for k, v in self.config.items()},
                "future_seq_len": self.feature_transformer.future_seq_len,
                "model_class": type(self.model).__name__}
        with open(os.path.join(pipeline_dir, "pipeline.json"), "w") as f:
            json.dump(meta, f)


def load_ts_pipeline(pipeline_dir: str) -> TimeSequencePipeline:
    with open(os.path.join(pipeline_dir, "pipeline.json")) as f:
        meta = json.load(f)
    ft = TimeSequenceFeatureTransformer.load(
        os.path.join(pipeline_dir, "feature_transformer.json"))
    config = meta["config"]
    fsl = int(meta.get("future_seq_len", 1))
    cls_name = meta.get("model_class", "VanillaLSTM")
    if cls_name == "MTNet":
        from analytics_zoo_tpu_torch.automl.model.mtnet import MTNet
        model = MTNet(future_seq_len=fsl)
    elif cls_name == "Seq2SeqForecaster":
        from analytics_zoo_tpu_torch.automl.model.time_sequence import (
            Seq2SeqForecaster)
        model = Seq2SeqForecaster(fsl)
    else:
        model = VanillaLSTM()
    # the transformer's config holds the RESOLVED feature selection and
    # window length (fit_transform persists them), so the model input
    # width is reconstructed exactly
    past = int(ft.config.get("past_seq_len", 2))
    n_feat = 1 + len(ft.config["selected_features"])
    model.restore(os.path.join(pipeline_dir, "model.npz"),
                  (past, n_feat), meta["future_seq_len"], config)
    return TimeSequencePipeline(ft, model, config)
