"""``GraphNet``: transfer-learning surgery over a model (the JAX package's
``nn/net.py``, its freezing part).

Freezing marks top-level layers whose parameters stop moving: the
Estimator zeroes their part of every update while their optimizer
moments go on updating, as the JAX step does, and reads the frozen set
at every ``fit``, so a change between fits takes effect.  A frozen
layer's state (BatchNormalization's moving statistics) goes on moving,
as in the JAX step.  Cutting a
sub-graph (``new_graph``) is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence, Set


class GraphNet:
    """Wraps a ``Model`` or ``Sequential``; other attributes pass through
    to it."""

    def __init__(self, model):
        self.model = model

    def freeze(self, names: Optional[Sequence[str]] = None) -> "GraphNet":
        """Freeze the named layers (every layer when None)."""
        layer_names = {layer.name for layer in self.model.layers}
        targets = set(names) if names is not None else layer_names
        unknown = targets - layer_names
        if unknown:
            raise ValueError(f"unknown layers {sorted(unknown)}; "
                             f"known: {sorted(layer_names)}")
        self.model._frozen = self.frozen | targets
        return self

    def unfreeze(self, names: Optional[Sequence[str]] = None) -> "GraphNet":
        """Unfreeze the named layers (every frozen layer when None)."""
        frozen = self.frozen
        self.model._frozen = frozen - (set(names) if names is not None
                                       else frozen)
        return self

    def freeze_up_to(self, name: str) -> "GraphNet":
        """Freeze every layer up to and including ``name`` in the model's
        layer order (topological for a graph): fine-tune the head."""
        layers = self.model.layers
        idx = [i for i, layer in enumerate(layers) if layer.name == name]
        if not idx:
            raise ValueError(f"unknown layer {name!r}")
        return self.freeze([layer.name for layer in layers[:idx[-1] + 1]])

    @property
    def frozen(self) -> Set[str]:
        return set(getattr(self.model, "_frozen", set()))

    def compile(self, *a, **kw):
        self.model.compile(*a, **kw)
        return self

    def __getattr__(self, item):
        return getattr(self.model, item)
