"""ZooModel base: a built-in model owns a ``KerasNet`` (its ``model``),
its hyper-parameters and the device its weights live on.  Persistence and
training belong to later slices."""

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
