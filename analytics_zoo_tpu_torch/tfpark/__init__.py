"""BERT task models (the JAX package's ``tfpark/text_estimators.py``)."""

from analytics_zoo_tpu_torch.tfpark.text_estimators import (  # noqa: F401
    BERTClassifier,
    BERTNER,
    BERTSQuAD,
)

__all__ = ["BERTClassifier", "BERTNER", "BERTSQuAD"]
