from analytics_zoo_tpu_torch.models.common import ZooModel, register_model  # noqa: F401
from analytics_zoo_tpu_torch.models.recommendation import (  # noqa: F401
    NeuralCF,
    Recommender,
    SessionRecommender,
    WideAndDeep,
    negative_sample,
    presample_implicit_epochs,
)
from analytics_zoo_tpu_torch.models.image import ImageClassifier  # noqa: F401
from analytics_zoo_tpu_torch.models.objectdetection import (  # noqa: F401
    ObjectDetector,
)
from analytics_zoo_tpu_torch.models.text import (  # noqa: F401
    KNRM,
    Ranker,
    TextClassifier,
    mean_average_precision,
    ndcg,
)
from analytics_zoo_tpu_torch.models.anomalydetection import (  # noqa: F401
    AnomalyDetector,
    detect_anomalies,
    unroll,
)
from analytics_zoo_tpu_torch.models.seq2seq import (  # noqa: F401
    Bridge,
    RNNDecoder,
    RNNEncoder,
    Seq2seq,
)
