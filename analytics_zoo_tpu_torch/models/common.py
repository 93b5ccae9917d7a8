"""ZooModel base: a built-in model owns a ``KerasNet`` (its ``model``),
its hyper-parameters and the device its weights live on; ``compile`` /
``fit`` / ``evaluate`` / ``predict`` delegate to the net (and so to
``train.Estimator``) on that device.

Persistence is the JAX package's: ``save_model`` writes ``config.json``
(``{"class", "config"}``: the registered class and its constructor
arguments) and ``weights.npz`` (``{"params", "state"}`` in the archive
format of ``train/checkpoint.py``), so a directory saved by either
package loads into either.  The port's net holds its weights from
construction, so ``load_model`` applies them at once."""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

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

    def config(self) -> Dict[str, Any]:
        """JSON-serializable constructor arguments."""
        raise NotImplementedError

    def _finish(self, net) -> None:
        """Allocate ``net``'s weights and place them on the device."""
        net.build(self.generator)
        self.model = net.to(self.device)

    # -- training facade --------------------------------------------------
    def compile(self, optimizer, loss, metrics=None, device=None, **kw):
        """``KerasNet.compile`` on this model's device by default
        (``compute_dtype``, ``grad_accum_steps`` pass through)."""
        self.model.compile(optimizer, loss, metrics=metrics,
                           device=self.device if device is None else device,
                           **kw)
        return self

    def fit(self, *a, **kw):
        return self.model.fit(*a, **kw)

    def evaluate(self, *a, **kw):
        return self.model.evaluate(*a, **kw)

    def predict(self, *a, **kw):
        return self.model.predict(*a, **kw)

    def set_checkpoint(self, path: str, over_write: bool = True):
        self.model.set_checkpoint(path, over_write=over_write)
        return self

    def set_tensorboard(self, log_dir: str, app_name: str = "zoo"):
        self.model.set_tensorboard(log_dir, app_name)
        return self

    @property
    def estimator(self):
        return self.model.estimator

    # -- persistence ------------------------------------------------------
    def save_model(self, path: str) -> None:
        """Save config and weights (reference ZooModel.saveModel)."""
        from analytics_zoo_tpu_torch.train.checkpoint import (_atomic_text,
                                                              save_pytree)

        os.makedirs(path, exist_ok=True)
        _atomic_text(os.path.join(path, "config.json"), json.dumps(
            {"class": type(self).__name__, "config": self.config()},
            indent=2))
        save_pytree(os.path.join(path, "weights.npz"),
                    {"params": self.model.params(),
                     "state": self.model.state()})

    @classmethod
    def load_model(cls, path: str, device=None) -> "ZooModel":
        """The model a ``save_model`` directory holds, on ``device``
        (default ``cuda``), with its weights."""
        from analytics_zoo_tpu_torch.convert import load_archive_params
        from analytics_zoo_tpu_torch.train.checkpoint import load_pytree

        with open(os.path.join(path, "config.json")) as f:
            blob = json.load(f)
        model_cls = _MODEL_REGISTRY.get(blob["class"])
        if model_cls is None:
            raise ValueError(f"unknown model class {blob['class']}; "
                             f"registered: {sorted(_MODEL_REGISTRY)}")
        inst = model_cls(**blob["config"], device=device)
        wpath = os.path.join(path, "weights.npz")
        if os.path.exists(wpath):
            tree = load_pytree(wpath)
            load_archive_params(inst.model, tree["params"], tree.get("state"))
        return inst
