"""TimeSequencePredictor — AutoML entry point for time-series forecasting
(reference automl/regression/time_sequence_predictor.py:335-586).

``fit(input_df)`` searches feature + model hyper-parameters (per recipe)
and returns a fitted ``TimeSequencePipeline``.  The JAX package's module
on the port's models: each trial trains on the context's device, and
once the best trial is known the others' CUDA graphs are released
(their results keep the models, as the JAX engine keeps them).
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Sequence

from analytics_zoo_tpu_torch.automl.common.metrics import Evaluator
from analytics_zoo_tpu_torch.automl.feature.time_sequence import (
    TimeSequenceFeatureTransformer)
from analytics_zoo_tpu_torch.automl.model.time_sequence import (
    Seq2SeqForecaster, VanillaLSTM)
from analytics_zoo_tpu_torch.automl.pipeline.time_sequence import (
    TimeSequencePipeline)
from analytics_zoo_tpu_torch.automl.search import (Recipe, SearchEngine,
                                             SmokeRecipe)

logger = logging.getLogger("analytics_zoo_tpu_torch.automl")


class TimeSequencePredictor:
    """Search + train a forecaster for a univariate target with extra
    features.  future_seq_len == 1 -> VanillaLSTM; > 1 -> multi-horizon
    forecaster (reference picks Seq2Seq there)."""

    def __init__(self, name: str = "automl", logs_dir: str = "~/zoo_automl",
                 future_seq_len: int = 1, dt_col: str = "datetime",
                 target_col: str = "value",
                 extra_features_col: Optional[Sequence[str]] = None,
                 drop_missing: bool = True):
        self.name = name
        self.logs_dir = logs_dir
        self.future_seq_len = future_seq_len
        self.dt_col = dt_col
        self.target_col = target_col
        self.extra_features_col = extra_features_col
        self.drop_missing = drop_missing
        self.pipeline: Optional[TimeSequencePipeline] = None

    def _check_input(self, input_df, validation_df, metric):
        for df in (input_df, validation_df):
            if df is None:
                continue
            for col in (self.dt_col, self.target_col):
                if col not in df.columns:
                    raise ValueError(f"column {col!r} missing from frame")
        Evaluator.evaluate(metric, [0.0], [0.0])   # validates metric name

    def _make_model(self, config: Dict):
        """Model selection via the config's ``model`` key (reference
        recipes carry "model": "LSTM"|"Seq2seq"|"MTNet",
        time_sequence_predictor.py:70,99,162)."""
        name = str(config.get("model", "")).lower()
        if name == "mtnet":
            from analytics_zoo_tpu_torch.automl.model.mtnet import MTNet
            return MTNet(future_seq_len=self.future_seq_len)
        if name in ("seq2seq", "seq2seqforecaster"):
            return Seq2SeqForecaster(max(self.future_seq_len, 1))
        if name in ("lstm", "vanillalstm"):
            return VanillaLSTM()
        # default: horizon decides (the pre-"model"-key behavior)
        return (VanillaLSTM() if self.future_seq_len == 1
                else Seq2SeqForecaster(self.future_seq_len))

    def fit(self, input_df: pd.DataFrame,
            validation_df: Optional[pd.DataFrame] = None,
            metric: str = "mse", recipe: Optional[Recipe] = None,
            max_parallel: int = 1) -> TimeSequencePipeline:
        recipe = recipe or SmokeRecipe()
        self._check_input(input_df, validation_df, metric)

        probe = TimeSequenceFeatureTransformer(
            future_seq_len=self.future_seq_len, dt_col=self.dt_col,
            target_col=self.target_col,
            extra_features_col=self.extra_features_col,
            drop_missing=self.drop_missing)
        feature_list = probe.get_feature_list(input_df)
        space = recipe.search_space(feature_list)
        mode = Evaluator.get_metric_mode(metric)

        def trainable(config: Dict):
            ft = TimeSequenceFeatureTransformer(
                future_seq_len=self.future_seq_len, dt_col=self.dt_col,
                target_col=self.target_col,
                extra_features_col=self.extra_features_col,
                drop_missing=self.drop_missing)
            x, y = ft.fit_transform(input_df, **config)
            if validation_df is not None:
                vx, vy = ft.transform(validation_df, is_train=True)
                val = (vx, vy)
            else:
                split = max(1, int(len(x) * 0.9))
                val = (x[split:], y[split:]) if split < len(x) else None
                x, y = x[:split], y[:split]
            model = self._make_model(config)
            score = model.fit_eval(x, y, validation_data=val, metric=metric,
                                   **config)
            return score, {"ft": ft, "model": model}

        engine = SearchEngine(
            space, metric_mode=mode, num_samples=recipe.num_samples,
            max_parallel=max_parallel,
            search_alg=getattr(recipe, "search_alg", "random"),
            n_startup=getattr(recipe, "n_startup", None))
        engine.run(trainable)
        best = engine.best()
        for r in engine.results:
            if r is not best and "model" in r.extra:
                r.extra["model"].model.estimator.release_graphs()
        logger.info("best config %s -> %s=%.6g", best.config, metric,
                    best.metric)
        self.pipeline = TimeSequencePipeline(
            best.extra["ft"], best.extra["model"], best.config)
        return self.pipeline

    def predict(self, input_df: pd.DataFrame) -> pd.DataFrame:
        if self.pipeline is None:
            raise RuntimeError("fit first")
        return self.pipeline.predict(input_df)

    def evaluate(self, input_df: pd.DataFrame, metric: str = "mse") -> float:
        if self.pipeline is None:
            raise RuntimeError("fit first")
        return self.pipeline.evaluate(input_df, metric)
