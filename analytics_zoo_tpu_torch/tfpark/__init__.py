"""BERT task models (the JAX package's ``tfpark/text_estimators.py``), the
foreign-model wrappers of its ``tfpark/model.py`` that need no
TensorFlow (``FunctionModel``, ``TorchModel``, ``TorchCriterion``),
``TFDataset`` (TFRecords read without TensorFlow) and the model_fn
``TFEstimator``."""

from analytics_zoo_tpu_torch.tfpark.converter import (  # noqa: F401
    GraphProgram,
    UnsupportedLayerError,
)
from analytics_zoo_tpu_torch.tfpark.estimator import (  # noqa: F401
    EstimatorSpec,
    ModeKeys,
    TFEstimator,
)
from analytics_zoo_tpu_torch.tfpark.model import (  # noqa: F401
    FunctionModel,
    TorchCriterion,
    TorchModel,
)
from analytics_zoo_tpu_torch.tfpark.text_estimators import (  # noqa: F401
    BERTClassifier,
    BERTNER,
    BERTSQuAD,
)
from analytics_zoo_tpu_torch.tfpark.tf_dataset import TFDataset  # noqa: F401

__all__ = ["BERTClassifier", "BERTNER", "BERTSQuAD", "EstimatorSpec",
           "FunctionModel", "GraphProgram", "ModeKeys", "TFDataset",
           "TFEstimator", "TorchCriterion", "TorchModel",
           "UnsupportedLayerError"]
