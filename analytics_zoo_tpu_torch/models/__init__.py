from analytics_zoo_tpu_torch.models.common import ZooModel, register_model  # noqa: F401
from analytics_zoo_tpu_torch.models.recommendation import (  # noqa: F401
    NeuralCF,
    Recommender,
    SessionRecommender,
    WideAndDeep,
)
from analytics_zoo_tpu_torch.models.image import ImageClassifier  # noqa: F401
from analytics_zoo_tpu_torch.models.objectdetection import (  # noqa: F401
    ObjectDetector,
)
from analytics_zoo_tpu_torch.models.text import (  # noqa: F401
    KNRM,
    Ranker,
    TextClassifier,
)
from analytics_zoo_tpu_torch.models.anomalydetection import (  # noqa: F401
    AnomalyDetector,
)
from analytics_zoo_tpu_torch.models.seq2seq import Seq2seq  # noqa: F401
