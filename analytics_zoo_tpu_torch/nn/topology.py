"""Model containers: ``Sequential`` and the graph ``Model``.

Both own their layers as submodules, keyed by layer name, so
``params()`` returns the JAX package's tree layout
(``{layer_name: {leaf: tensor}}``, empty dicts for weightless layers),
and ``state()`` its state tree (``{layer_name: {leaf: tensor}}``, empty
dicts for stateless layers).
``compile`` / ``fit`` / ``evaluate`` / ``predict`` are thin facades over
``train.Estimator``, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from analytics_zoo_tpu_torch.nn.autograd import Variable, evaluate, topo_sort
from analytics_zoo_tpu_torch.nn.module import Layer


class KerasNet(Layer):
    """Shared base of Sequential and Model: the compile / fit / evaluate /
    predict facade over ``train.Estimator``."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self._estimator = None          # created by compile()
        self._pending_init = None       # set_initial_weights before it
        self._ckpt_dir = None           # set_checkpoint before it

    def __getstate__(self):
        """A copy (``copy.deepcopy``, pickle) carries the net's weights,
        not its estimator: serving copies stay small."""
        state = dict(self.__dict__)
        state["_estimator"] = state["_pending_init"] = None
        return state

    @property
    def layers(self) -> List[Layer]:
        raise NotImplementedError

    def params(self) -> Dict[str, Dict[str, object]]:
        """``{layer_name: layer tree}``, plus the net's own sub-trees
        (a task head that is not a layer, as BERTClassifier's)."""
        out = {layer.name: layer.params() for layer in self.layers}
        out.update(super().params())
        return out

    def state(self) -> Dict[str, Dict[str, object]]:
        """``{layer_name: layer state tree}`` (BatchNormalization's moving
        statistics), plus the net's own sub-trees' state."""
        out = {layer.name: layer.state() for layer in self.layers}
        out.update(super().state())
        return out

    def subtree(self, key: str) -> Layer:
        """A layer by name, else one of the net's own sub-trees."""
        for layer in self.layers:
            if layer.name == key:
                return layer
        return super().subtree(key)

    def regularization_loss(self):
        """Sum of every layer's weight penalty (``w_regularizer`` /
        ``b_regularizer``), added to the training objective by the
        Estimator; 0.0 when no layer has one."""
        total = 0.0
        for layer in self.layers:
            fn = getattr(layer, "regularization_loss", None)
            if fn is not None:
                total = total + fn()
        return total

    # -- training facade (delegates to train.Estimator) -------------------
    def compile(self, optimizer, loss, metrics=None, sharding="dp",
                aux_loss_weight: float = 0.01, grad_accum_steps: int = 1,
                device=None, compute_dtype: Optional[str] = None):
        """Configure training, in the JAX signature with the port's extras
        after it: ``optimizer`` / ``loss`` / ``metrics`` take Keras names
        or objects; ``sharding`` is "dp" (one device here; the JAX
        package's other regimes, tp / ep / sp / pp, raise until the
        multi-GPU slice); ``aux_loss_weight`` is accepted and inert until
        the layers that emit auxiliary losses are ported (``moe.py``,
        ROADMAP A9); ``grad_accum_steps`` and ``compute_dtype``
        ("bfloat16") go to the ``Estimator``; ``device`` defaults to the
        context's, else ``cuda``.  Re-compiling keeps the live weights
        (they live in this net); weights staged by ``set_initial_weights``
        — before this call, or on the previous estimator and not yet
        applied — carry over, and so does a ``set_checkpoint`` made before
        it."""
        from analytics_zoo_tpu_torch.train.estimator import Estimator

        prev = self._estimator
        self._estimator = Estimator(self, optimizer=optimizer, loss=loss,
                                    metrics=metrics, sharding=sharding,
                                    compute_dtype=compute_dtype,
                                    aux_loss_weight=aux_loss_weight,
                                    grad_accum_steps=grad_accum_steps,
                                    device=device)
        carried = prev._initial if prev is not None else None
        if self._pending_init is not None:
            carried, self._pending_init = self._pending_init, None
        if carried is not None:
            self._estimator.set_initial_weights(*carried)
        if self._ckpt_dir is not None:
            self._estimator.set_checkpoint(self._ckpt_dir)
        return self

    def set_initial_weights(self, params, state=None):
        """Seed weights, and state, by layer name (``{layer: {leaf:
        array}}``) before or after ``compile``; uncovered layers warn at
        build and keep theirs."""
        if self._estimator is not None:
            self._estimator.set_initial_weights(params, state)
        else:
            self._pending_init = (params, state)
        return self

    @property
    def estimator(self):
        if self._estimator is None:
            raise RuntimeError("call compile(optimizer, loss) before "
                               "fit/evaluate")
        return self._estimator

    def set_checkpoint(self, path: str, over_write: bool = True):
        """Snapshot every epoch under ``path`` (before or after
        ``compile``); ``fit(resume=True)`` continues from there."""
        self._ckpt_dir = path
        if self._estimator is not None:
            self._estimator.set_checkpoint(path, over_write=over_write)
        return self

    # -- persistence ------------------------------------------------------
    def save_weights(self, path: str, params=None, state=None) -> None:
        """``{"params", "state"}`` in the JAX package's archive format
        (``train/checkpoint.py``); ``params`` and ``state`` default to
        this net's."""
        from analytics_zoo_tpu_torch.train.checkpoint import save_pytree

        save_pytree(path, {
            "params": self.params() if params is None else params,
            "state": self.state() if state is None else state})

    def load_weights(self, path: str):
        """Load an archive written by ``save_weights`` (of either package)
        into this net, weights and state, by key path, building it first
        from its declared input shapes if need be; returns its
        ``(params, state)``."""
        from analytics_zoo_tpu_torch.convert import load_archive_params
        from analytics_zoo_tpu_torch.core.context import get_zoo_context
        from analytics_zoo_tpu_torch.train.checkpoint import load_pytree

        tree = load_pytree(path)
        if getattr(self, "_output_shape", None) is None:
            self.build(torch.Generator().manual_seed(
                get_zoo_context().config.seed))
        load_archive_params(self, tree["params"], tree.get("state"))
        return tree["params"], tree.get("state", {})

    def fit(self, x, y=None, batch_size: int = 32,
            nb_epoch: Optional[int] = None, validation_data=None,
            epochs: Optional[int] = None, **kw):
        """``nb_epoch`` and ``epochs`` are aliases; pass one of them.
        Other keywords (``resume=True``, triggers) go to
        ``Estimator.fit``."""
        if nb_epoch is not None and epochs is not None:
            raise ValueError(
                "pass either nb_epoch= or epochs= (aliases), not both")
        n = nb_epoch if nb_epoch is not None else (
            epochs if epochs is not None else 1)
        return self.estimator.fit(x, y, batch_size=batch_size, epochs=n,
                                  validation_data=validation_data, **kw)

    def evaluate(self, x, y=None, batch_size: int = 32):
        return self.estimator.evaluate(x, y, batch_size=batch_size)

    def predict(self, x, batch_size: int = 32, distributed: bool = True):
        """``distributed`` is accepted and ignored, as the JAX package
        ignores it."""
        return self.estimator.predict(x, batch_size=batch_size)

    def predict_classes(self, x, batch_size: int = 32,
                        zero_based_label: bool = True):
        return self.estimator.predict_classes(
            x, batch_size=batch_size, zero_based_label=zero_based_label)


class Sequential(KerasNet):
    """Linear stack of layers."""

    def __init__(self, layers: Optional[Sequence[Layer]] = None, **kw):
        super().__init__(**kw)
        self._layers = nn.ModuleList()
        for layer in layers or []:
            self.add(layer)

    def add(self, layer: Layer) -> "Sequential":
        self._layers.append(layer)
        return self

    @property
    def layers(self) -> List[Layer]:
        return list(self._layers)

    def build(self, generator, *input_shapes):
        if len(input_shapes) == 1:
            shape = tuple(input_shapes[0])
        elif self._layers and self._layers[0].input_shape is not None:
            shape = (2,) + self._layers[0].input_shape
        else:
            raise ValueError("Sequential.build needs an input shape")
        for layer in self._layers:
            layer.build(generator, shape)
            shape = layer.output_shape(shape)
        self._output_shape = shape

    def output_shape(self, *input_shapes):
        shape = tuple(input_shapes[0])
        for layer in self._layers:
            shape = layer.output_shape(shape)
        return shape

    def forward(self, x):
        for layer in self._layers:
            x = layer(x)
        return x


class Model(KerasNet):
    """Graph model over autograd Variables.

    >>> a = Input(shape=(8,)); b = Input(shape=(8,))
    >>> h = Dense(16, activation="relu")(merge([a, b], mode="concat"))
    >>> model = Model([a, b], Dense(1, activation="sigmoid")(h))
    """

    def __init__(self, inputs, outputs, **kw):
        super().__init__(**kw)
        self.inputs: List[Variable] = (
            list(inputs) if isinstance(inputs, (list, tuple)) else [inputs])
        self.single_output = not isinstance(outputs, (list, tuple))
        self.outputs: List[Variable] = (
            [outputs] if self.single_output else list(outputs))
        self.order = topo_sort(self.outputs)
        input_ids = {v.id for v in self.inputs}
        for v in self.order:
            if v.kind == "input" and v.id not in input_ids:
                raise ValueError(f"graph uses input {v.name} not in inputs=")
        self._layer_map = nn.ModuleDict()
        for v in self.order:
            if v.kind == "layer" and v.layer.name not in self._layer_map:
                self._layer_map[v.layer.name] = v.layer

    @property
    def layers(self) -> List[Layer]:
        return list(self._layer_map.values())

    def __getstate__(self):
        """The graph as a flat list in topological order, each node naming
        its parents by position: a copy (``copy.deepcopy``, pickle) of a
        deep graph (ResNet-50's 170-odd nodes) then never recurses
        through the chain of parents."""
        state = super().__getstate__()
        index = {v.id: i for i, v in enumerate(self.order)}
        state["order"] = [(v.kind, tuple(index[p.id] for p in v.parents),
                           v.layer, v.fn, v.shape, v.name, v.dtype)
                          for v in self.order]
        state["inputs"] = [index[v.id] for v in self.inputs]
        state["outputs"] = [index[v.id] for v in self.outputs]
        return state

    def __setstate__(self, state):
        nodes: List[Variable] = []
        for kind, parents, layer, fn, shape, name, dtype in state["order"]:
            nodes.append(Variable(kind, [nodes[i] for i in parents],
                                  layer=layer, fn=fn, shape=shape, name=name,
                                  dtype=dtype))
        state = dict(state, order=nodes,
                     inputs=[nodes[i] for i in state["inputs"]],
                     outputs=[nodes[i] for i in state["outputs"]])
        super().__setstate__(state)

    def _shapes(self, input_shapes, generator=None):
        """Thread shapes through the DAG, building each layer once when a
        generator is given."""
        if not input_shapes:
            input_shapes = tuple((2,) + tuple(v.shape[1:])
                                 for v in self.inputs)
        if len(input_shapes) != len(self.inputs):
            raise ValueError(f"expected {len(self.inputs)} input shapes, "
                             f"got {len(input_shapes)}")
        shapes = {v.id: tuple(s) for v, s in zip(self.inputs, input_shapes)}
        built = set()
        for v in self.order:
            if v.id in shapes:
                continue
            parent = [shapes[p.id] for p in v.parents]
            if v.kind == "layer":
                if generator is not None and v.layer.name not in built:
                    v.layer.build(generator, *parent)  # shared: once
                    built.add(v.layer.name)
                shapes[v.id] = tuple(v.layer.output_shape(*parent))
            else:
                metas = [torch.empty(s, device="meta") for s in parent]
                shapes[v.id] = tuple(v.fn(*metas).shape)
        outs = tuple(shapes[o.id] for o in self.outputs)
        return outs[0] if self.single_output else outs

    def build(self, generator, *input_shapes):
        self._output_shape = self._shapes(input_shapes, generator)

    def output_shape(self, *input_shapes):
        return self._shapes(input_shapes)

    def forward(self, *inputs):
        if len(inputs) == 1 and isinstance(inputs[0], (list, tuple)):
            inputs = tuple(inputs[0])
        if len(inputs) != len(self.inputs):
            raise ValueError(
                f"expected {len(self.inputs)} inputs, got {len(inputs)}")
        env = evaluate(self.order,
                       {v.id: x for v, x in zip(self.inputs, inputs)})
        outs = [env[o.id] for o in self.outputs]
        return outs[0] if self.single_output else outs
