"""AutoML for time series (reference pyzoo/zoo/automl), the JAX
package's ``automl`` on the port:

- ``TimeSequencePredictor.fit(df)`` drives a hyper-parameter search over
  rolling-window feature configs + model configs and returns a fitted
  ``TimeSequencePipeline`` (reference regression/time_sequence_predictor.py).
- The search engine is **in-process** with a ray.tune-shaped API
  (search/__init__.py): every trial trains through the port's Estimator
  on the card, so trials run concurrently in a thread/process pool, are
  pinned round-robin to the context's cards (``backend="device"``), or
  run as one ``torch.func.vmap`` population (``backend="vmap"``).
  ``search_alg="tpe"`` / ``BayesRecipe`` give BayesOpt-style sequential
  model-based search (reference RayTuneSearchEngine.py:25
  BayesOptSearch); the samplers propose the JAX package's configs for
  the same seed.
- Feature engineering (rolling windows, datetime features, scaling) in
  feature/time_sequence.py (reference feature/time_sequence.py:30-540);
  pandas is needed only for its DataFrame front end.
- Models: VanillaLSTM, encoder-decoder Seq2Seq (future_seq_len>1), and
  MTNet (model/mtnet.py — the reference's flagship, MTNet_keras.py),
  selectable via the config's ``model`` key.
"""

from analytics_zoo_tpu_torch.automl.common.metrics import Evaluator
from analytics_zoo_tpu_torch.automl.feature.time_sequence import (
    TimeSequenceFeatureTransformer)
from analytics_zoo_tpu_torch.automl.model.mtnet import MTNet, MTNetBlock
from analytics_zoo_tpu_torch.automl.pipeline.time_sequence import (
    TimeSequencePipeline, load_ts_pipeline)
from analytics_zoo_tpu_torch.automl.regression.time_sequence_predictor \
    import TimeSequencePredictor
from analytics_zoo_tpu_torch.automl.search import (BayesRecipe,
                                                   GridRandomRecipe,
                                                   MTNetGridRandomRecipe,
                                                   MTNetSmokeRecipe,
                                                   RandomRecipe, Recipe,
                                                   SearchEngine,
                                                   SmokeRecipe, TPESampler)

__all__ = ["TimeSequencePredictor", "TimeSequencePipeline",
           "load_ts_pipeline", "TimeSequenceFeatureTransformer",
           "Evaluator", "SearchEngine", "Recipe", "SmokeRecipe",
           "RandomRecipe", "GridRandomRecipe", "BayesRecipe",
           "MTNetSmokeRecipe", "MTNetGridRandomRecipe", "TPESampler",
           "MTNet", "MTNetBlock"]
