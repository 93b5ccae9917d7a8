"""Host datasets: ``FeatureSet`` with HOST / DEVICE cache levels and the
MovieLens readers."""

from analytics_zoo_tpu_torch.data.datasets import (  # noqa: F401
    generate_movielens_like,
    movielens_featureset,
    read_movielens_1m,
)
from analytics_zoo_tpu_torch.data.featureset import (  # noqa: F401
    CacheLevel,
    FeatureSet,
)
