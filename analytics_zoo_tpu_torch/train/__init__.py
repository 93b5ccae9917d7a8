"""Training: the ``Estimator`` (and ``LocalEstimator``) and optax-equivalent
optimizers."""

from analytics_zoo_tpu_torch.train.estimator import Estimator  # noqa: F401
from analytics_zoo_tpu_torch.train.local_estimator import (  # noqa: F401
    LocalEstimator)
