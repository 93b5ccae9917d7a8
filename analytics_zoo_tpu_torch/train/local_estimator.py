"""LocalEstimator — the single-device training facade.

In the JAX package this is the ``Estimator`` pinned to a one-device mesh.
The port's ``Estimator`` always trains on one device, so this class is
that ``Estimator``, on the context's device (or ``device``): the same
fit / evaluate / predict, and no second code path.
"""

from __future__ import annotations

from typing import Optional

from analytics_zoo_tpu_torch.core.context import ZooContext
from analytics_zoo_tpu_torch.train.estimator import Estimator

__all__ = ["LocalEstimator"]


class LocalEstimator(Estimator):
    """``Estimator`` on one device (the JAX signature)."""

    def __init__(self, model, optimizer="adam", loss="mse", metrics=None,
                 ctx: Optional[ZooContext] = None, **kw):
        super().__init__(model, optimizer=optimizer, loss=loss,
                         metrics=metrics, ctx=ctx, **kw)
