from analytics_zoo_tpu_torch.models.common import ZooModel, register_model  # noqa: F401
from analytics_zoo_tpu_torch.models.recommendation import (  # noqa: F401
    NeuralCF,
    Recommender,
)
