"""Foreign models trained and served natively (the JAX package's
``tfpark/model.py``: ``FunctionModel``, ``TorchModel``, ``TorchCriterion``).

``FunctionModel`` is a ``KerasNet`` over a program — an imported ONNX or
Caffe graph (``onnx.OnnxProgram``), its int8 form
(``ops.quantization.QuantizedProgram``) or a converted torch
``Sequential`` (``tfpark.converter.GraphProgram``).  It holds the
program's parameter tree as its own leaves, so ``params()`` is the JAX
tree — flat ``{onnx_name: tensor}`` for an ONNX graph (names such as
``layer1.0.conv1.weight``, which ``register_parameter`` refuses, are kept
under positional keys), ``{layer: {leaf: tensor}}`` for a converted torch
model — and ``compile`` / ``fit`` / ``predict`` and
``InferenceModel.from_keras_net`` work on it as on a native net.  An int8
program's quantized weights are leaves too, in the port's quantized-leaf
form ``{"q", "scale"}``.

``TorchModel`` converts a ``torch.nn.Sequential`` of the JAX vocabulary
(Linear, Conv2d, ReLU, Sigmoid, Tanh, Flatten, Dropout, MaxPool2d) into
a ``GraphProgram``: NCHW / OIHW layout and the parameter tree
(``torch_{i}_{type}``: Linear ``kernel`` (in, out), Conv2d ``kernel``
OIHW) are the JAX package's, the ops are torch's.  ``TorchCriterion``
maps a torch loss module to the port's loss of the same name, as the
JAX package maps it to its own.

``KerasModel``, ``TFNet``, ``TFOptimizer`` and ``TFGraphOptimizer`` need
TensorFlow, which the card machine lacks (ROADMAP A10).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.nn.layers.core import Dropout
from analytics_zoo_tpu_torch.nn.module import Layer, is_qleaf
from analytics_zoo_tpu_torch.nn.topology import KerasNet
from analytics_zoo_tpu_torch.onnx.loader import _pad_spatial, _same_pairs
from analytics_zoo_tpu_torch.tfpark.converter import (GraphProgram,
                                                      UnsupportedLayerError,
                                                      _stateless)

__all__ = ["FunctionModel", "TorchModel", "TorchCriterion"]


def _leaf_items(tree, path=()) -> List[Tuple[tuple, object]]:
    """(key path, leaf) pairs of a nested dict, in its order."""
    if isinstance(tree, dict) and not is_qleaf(tree):
        out = []
        for k, v in tree.items():
            out += _leaf_items(v, path + (k,))
        return out
    return [(path, tree)]


def _put(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().clone()
    return torch.from_numpy(np.array(value))


class FunctionModel(KerasNet):
    """A KerasNet over a program (imported weights)."""

    def __init__(self, program, **kw):
        super().__init__(**kw)
        self.program = program
        # positional leaf key -> key path in the program's tree
        self._paths: Dict[str, tuple] = {}
        self._state_paths: Dict[str, tuple] = {}
        self._quantized: set = set()
        for path, value in _leaf_items(program.params):
            key = f"p{len(self._paths)}"
            self._paths[key] = path
            Layer.set_leaf(self, key, _tensor(value))
        for wname, (q, scale) in getattr(program, "qweights", {}).items():
            key = f"p{len(self._paths)}"
            self._paths[key] = (wname,)
            self._quantized.add(key)
            Layer.set_leaf(self, key, {"q": q, "scale": scale})
        for path, value in _leaf_items(program.state):
            key = f"s{len(self._state_paths)}"
            self._state_paths[key] = path
            Layer.set_state(self, key, _tensor(value))
        self._keys = {p: k for k, p in self._paths.items()}
        self._state_keys = {p: k for k, p in self._state_paths.items()}
        # holds the Estimator's dropout generator during fit
        self.rng = (Dropout(0.0, name=f"{self.name}_rng")
                    if getattr(program, "has_dropout", False) else None)
        self._output_shape = ()         # built: the weights are given

    @property
    def layers(self):
        return []

    def build(self, generator, *input_shapes):
        """The weights come from the foreign model: nothing to draw."""
        self._output_shape = ()

    def _key(self, name, keys: Dict[tuple, str]) -> str:
        path = (name,) if isinstance(name, str) else tuple(name)
        if path not in keys:
            raise KeyError(f"{self.name} has no leaf {'.'.join(path)!r}")
        return keys[path]

    def params(self):
        out: dict = {}
        for key, path in self._paths.items():
            _put(out, path, self.qleaf(key) if key in self._qkinds
                 else self._parameters[key].detach())
        return out

    def state(self):
        out: dict = {}
        for key, path in self._state_paths.items():
            _put(out, path, self._buffers[key].detach())
        return out

    def set_leaf(self, name, value) -> None:
        """Install the leaf at key path ``name``: a float value of the live
        parameter's shape and dtype is copied into it (a captured step
        holds it); anything else replaces it."""
        key = self._key(name, self._keys)
        live = self._parameters.get(key)
        if live is not None and not is_qleaf(value):
            t = torch.as_tensor(np.asarray(value)
                                if not isinstance(value, torch.Tensor)
                                else value)
            if t.shape == live.shape and t.dtype == live.dtype:
                with torch.no_grad():
                    live.copy_(t)
                return
        Layer.set_leaf(self, key, value)

    def set_state(self, name, value) -> None:
        Layer.set_state(self, self._key(name, self._state_keys), value)

    def forward(self, *xs):
        params: dict = {}
        qweights = {}
        for key, path in self._paths.items():
            if key in self._quantized:
                q = self.qleaf(key)
                qweights[path[0]] = (q["q"], q["scale"])
            else:
                _put(params, path, self.leaf(key))
        state = self.state()
        kw = {"qweights": qweights} if self._quantized else {}
        rng = self.rng.generator if self.rng is not None else None
        out, new_state = self.program.call(params, state, *xs,
                                           training=self.training, rng=rng,
                                           **kw)
        if self.training:
            old = dict(_leaf_items(state))
            for path, value in _leaf_items(new_state):
                if path in self._state_keys and value is not old.get(path):
                    self.update_state(self._state_keys[path], value)
        return out


# ---------------------------------------------------------------------------
# torch ingestion


class TorchModel:
    """Convert a simple ``torch.nn.Sequential`` into a natively trainable
    model (Linear/Conv2d/ReLU/Sigmoid/Tanh/Flatten/Dropout/MaxPool2d); the
    weights are imported and the torch module is not in the step.  Trains
    on ``device`` (default ``cuda``) after the JAX arguments."""

    def __init__(self, torch_module, optimizer=None, loss=None,
                 metrics=None, device=None):
        program = self._convert(torch_module)
        self._torch = torch_module
        self.model = FunctionModel(program)
        from analytics_zoo_tpu_torch.train.optimizers import Adam

        self.model.compile(optimizer=optimizer or Adam(lr=1e-3),
                           loss=loss or "mse", metrics=metrics,
                           device=device)

    def fit(self, x, y=None, batch_size: int = 32, epochs: int = 1, **kw):
        return self.model.fit(x, y, batch_size=batch_size, nb_epoch=epochs,
                              **kw)

    def evaluate(self, x, y=None, batch_size: int = 32):
        return self.model.evaluate(x, y, batch_size=batch_size)

    def predict(self, x, batch_size: int = 32):
        return self.model.predict(x, batch_size=batch_size)

    @staticmethod
    def _convert(module) -> GraphProgram:
        if not isinstance(module, torch.nn.Sequential):
            raise UnsupportedLayerError(
                "TorchModel converts torch.nn.Sequential models; for "
                "arbitrary modules use deploy.InferenceModel.load_torch "
                "(inference) instead")
        nodes, params, state = [], {}, {}
        prev = "input"
        for i, sub in enumerate(module):
            name = f"torch_{i}_{type(sub).__name__.lower()}"
            t = type(sub).__name__
            p: dict = {}
            if t == "Linear":
                p = {"kernel": sub.weight.detach().cpu().numpy().T.copy()}
                if sub.bias is not None:
                    p["bias"] = sub.bias.detach().cpu().numpy().copy()

                def linear_fn(p, xs, tr, r):
                    y = xs[0] @ p["kernel"]
                    return y + p["bias"] if "bias" in p else y

                op = _stateless(linear_fn)
            elif t == "Conv2d":
                if tuple(sub.dilation) != (1, 1) or sub.groups != 1:
                    raise UnsupportedLayerError(
                        "Conv2d with dilation/groups is not converted")
                # torch's NCHW / OIHW, kept verbatim: the program takes
                # the tensors the torch module takes, and Flatten ->
                # Linear ordering stays C*H*W
                p = {"kernel": sub.weight.detach().cpu().numpy().copy()}
                if sub.bias is not None:
                    p["bias"] = sub.bias.detach().cpu().numpy().copy()
                stride = tuple(sub.stride)
                pad = (tuple((int(a), int(a)) for a in sub.padding)
                       if not isinstance(sub.padding, str)
                       else sub.padding.upper())

                def conv_fn(p, xs, tr, r, _s=stride, _pad=pad):
                    x, k = xs[0], p["kernel"]
                    pairs = _pad
                    if pairs == "SAME":
                        pairs = _same_pairs(x.shape[2:], k.shape[2:], _s)
                    elif pairs == "VALID":
                        pairs = ((0, 0), (0, 0))
                    if all(a == b for a, b in pairs):
                        return F.conv2d(x, k, p.get("bias"), _s,
                                        tuple(a for a, _ in pairs))
                    return F.conv2d(_pad_spatial(x, pairs), k, p.get("bias"),
                                    _s)

                op = _stateless(conv_fn)
            elif t == "ReLU":
                op = _stateless(lambda p, xs, tr, r: torch.relu(xs[0]))
            elif t == "Sigmoid":
                op = _stateless(lambda p, xs, tr, r: torch.sigmoid(xs[0]))
            elif t == "Tanh":
                op = _stateless(lambda p, xs, tr, r: torch.tanh(xs[0]))
            elif t == "Flatten":
                op = _stateless(
                    lambda p, xs, tr, r: xs[0].reshape(xs[0].shape[0], -1))
            elif t == "Dropout":
                rate = float(sub.p)

                def drop_fn(p, xs, tr, r, _rate=rate):
                    x = xs[0]
                    if not tr or r is None or _rate <= 0:
                        return x
                    keep = torch.rand(x.shape, generator=r,
                                      device=x.device) < 1.0 - _rate
                    return torch.where(keep, x / (1.0 - _rate),
                                       torch.zeros_like(x))

                op = _stateless(drop_fn)
            elif t == "MaxPool2d":
                if sub.padding not in (0, (0, 0)) or sub.dilation not in (
                        1, (1, 1)):
                    raise UnsupportedLayerError(
                        "MaxPool2d with padding/dilation is not converted")
                ks = (tuple(sub.kernel_size)
                      if isinstance(sub.kernel_size, tuple)
                      else (sub.kernel_size,) * 2)
                st = ((tuple(sub.stride) if isinstance(sub.stride, tuple)
                       else (sub.stride,) * 2) if sub.stride else ks)

                def pool_fn(p, xs, tr, r, _k=ks, _s=st):
                    # VALID windows, as the JAX conversion takes them
                    return F.max_pool2d(xs[0], _k, _s)

                op = _stateless(pool_fn)
            else:
                raise UnsupportedLayerError(f"torch layer {t!r}")
            nodes.append((name, op, [prev]))
            if p:
                params[name] = p
            prev = name
        program = GraphProgram(nodes, ["input"], [prev], params, state)
        program.has_dropout = any(type(sub).__name__ == "Dropout"
                                  for sub in module)
        return program


def _smooth_l1(y_true, y_pred):
    d = torch.abs(y_pred - y_true)
    return torch.mean(torch.where(d < 1.0, 0.5 * d * d, d - 0.5))


class TorchCriterion:
    """A torch loss module as the training objective: known torch losses
    map to the port's loss of the JAX mapping's name (the loss is plain
    math; no torch module runs in the step).  Unknown losses raise."""

    _TABLE = {
        "MSELoss": "mse",
        "L1Loss": "mae",
        "CrossEntropyLoss": "sparse_categorical_crossentropy_with_logits",
        "NLLLoss": "class_nll",
        "BCELoss": "binary_crossentropy",
        "BCEWithLogitsLoss": "binary_crossentropy_with_logits",
        "SmoothL1Loss": None,       # handled specially below
        # (HingeEmbeddingLoss deliberately unmapped: its distance-based
        # semantics differ from the keras margin hinge)
    }

    def __init__(self, torch_loss):
        name = type(torch_loss).__name__
        if name == "SmoothL1Loss":
            self.loss = _smooth_l1
        elif name in self._TABLE:
            from analytics_zoo_tpu_torch.nn import objectives

            self.loss = objectives.get(self._TABLE[name])
        else:
            raise UnsupportedLayerError(
                f"torch loss {name!r} has no native mapping; pass a loss "
                f"function to compile() directly")
        self.name = name

    def __call__(self, y_true, y_pred):
        return self.loss(y_true, y_pred)
