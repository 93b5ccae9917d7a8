"""Training: the ``Estimator`` and optax-equivalent optimizers."""

from analytics_zoo_tpu_torch.train.estimator import Estimator  # noqa: F401
