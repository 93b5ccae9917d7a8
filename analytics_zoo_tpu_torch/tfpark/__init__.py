"""BERT task models (the JAX package's ``tfpark/text_estimators.py``) and
the foreign-model wrappers of its ``tfpark/model.py`` that need no
TensorFlow: ``FunctionModel``, ``TorchModel`` and ``TorchCriterion``."""

from analytics_zoo_tpu_torch.tfpark.converter import (  # noqa: F401
    GraphProgram,
    UnsupportedLayerError,
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

__all__ = ["BERTClassifier", "BERTNER", "BERTSQuAD", "FunctionModel",
           "GraphProgram", "TorchCriterion", "TorchModel",
           "UnsupportedLayerError"]
