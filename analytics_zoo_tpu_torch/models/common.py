"""ZooModel base: a built-in model owns a ``KerasNet`` (its ``model``),
its hyper-parameters and the device its weights live on; ``compile`` /
``fit`` / ``evaluate`` / ``predict`` delegate to the net (and so to
``train.Estimator``) on that device.  Persistence belongs to a later
slice."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from analytics_zoo_tpu_torch.core.context import get_zoo_context, resolve_device

_MODEL_REGISTRY: Dict[str, type] = {}


def register_model(cls):
    _MODEL_REGISTRY[cls.__name__] = cls
    return cls


class ZooModel:
    """Base for built-in zoo models.

    ``device`` (default ``cuda``) is where the weights live; ``generator``
    (default seeded from ``ZooConfig.seed``) draws their initial values.
    """

    def __init__(self, device=None,
                 generator: Optional[torch.Generator] = None):
        self.model = None  # KerasNet, set by subclass build()
        self.device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(
                get_zoo_context().config.seed)
        self.generator = generator

    def build(self):
        raise NotImplementedError

    def _finish(self, net) -> None:
        """Allocate ``net``'s weights and place them on the device."""
        net.build(self.generator)
        self.model = net.to(self.device)

    # -- training facade --------------------------------------------------
    def compile(self, optimizer, loss, metrics=None, device=None):
        """``KerasNet.compile`` on this model's device by default."""
        self.model.compile(optimizer, loss, metrics=metrics,
                           device=self.device if device is None else device)
        return self

    def fit(self, *a, **kw):
        return self.model.fit(*a, **kw)

    def evaluate(self, *a, **kw):
        return self.model.evaluate(*a, **kw)

    def predict(self, *a, **kw):
        return self.model.predict(*a, **kw)

    @property
    def estimator(self):
        return self.model.estimator
