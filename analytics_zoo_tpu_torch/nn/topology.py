"""Model containers: ``Sequential`` and the graph ``Model``.

Both own their layers as submodules, keyed by layer name, so
``params()`` returns the JAX package's tree layout
(``{layer_name: {leaf: tensor}}``, empty dicts for weightless layers).
Training (``compile``/``fit``) belongs to a later slice.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from analytics_zoo_tpu_torch.nn.autograd import Variable, evaluate, topo_sort
from analytics_zoo_tpu_torch.nn.module import Layer


class KerasNet(Layer):
    """Shared base of Sequential and Model."""

    @property
    def layers(self) -> List[Layer]:
        raise NotImplementedError

    def params(self) -> Dict[str, Dict[str, object]]:
        return {layer.name: layer.params() for layer in self.layers}


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
