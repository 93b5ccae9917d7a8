"""``Net`` (model import) and ``GraphNet`` (transfer-learning surgery over
a model), the JAX package's ``nn/net.py``.

``Net`` is the loader facade (reference api/Net.scala:136-189): a saved
``ZooModel`` directory, a torch ``Sequential``, an ONNX file and a Caffe
prototxt + caffemodel each land in the port's layer world, so an
imported model trains under the Estimator and serves through
``InferenceModel`` as a native one does.  BigDL files raise as in the JAX
package (their weights load by name into a natively built net:
``bigdl.import_weights_by_name``); the TensorFlow loader and exporter
raise naming ROADMAP A10 (the card machine has no TensorFlow).

Freezing marks top-level layers whose parameters stop moving: the
Estimator zeroes their part of every update while their optimizer
moments go on updating, as the JAX step does, and reads the frozen set
at every ``fit``, so a change between fits takes effect.  A frozen
layer's state (BatchNormalization's moving statistics) goes on moving,
as in the JAX step.  ``new_graph`` cuts a sub-model ending at named
layers, with the source net's current weights (copies: training the
sub-model leaves the source as it is, as the JAX sub-model's own
estimator does).
"""

from __future__ import annotations

from typing import Optional, Sequence, Set, Union

__all__ = ["Net", "GraphNet"]

_TF_PENDING = ("needs TensorFlow, which the port's card machine lacks; the "
               "TensorFlow importers wait in ROADMAP A10 (tfpark: "
               "convert_keras_model, KerasModel, TFNet)")


class Net:
    """Unified loader facade (reference api/Net.scala:136-189)."""

    @staticmethod
    def load(path: str, device=None):
        """Load a saved ZooModel directory (``models/common.py``), on
        ``device`` (default ``cuda``)."""
        from analytics_zoo_tpu_torch.models.common import ZooModel

        return ZooModel.load_model(path, device=device)

    @staticmethod
    def load_torch(module_or_path, device=None):
        """torch.nn.Sequential (or a TorchScript file path) -> natively
        trainable model (reference loadTorch, Net.scala:161)."""
        import torch

        if isinstance(module_or_path, str):
            module_or_path = torch.jit.load(module_or_path,
                                            map_location="cpu")
        from analytics_zoo_tpu_torch.tfpark.model import TorchModel

        return TorchModel(module_or_path, device=device)

    @staticmethod
    def load_tf(path_or_model, **kw):
        """TF SavedModel path or tf.keras model (reference loadTF,
        Net.scala:176): not ported."""
        raise NotImplementedError(f"Net.load_tf {_TF_PENDING}")

    @staticmethod
    def load_onnx(path: str):
        """.onnx file -> trainable KerasNet (``onnx/loader.py``)."""
        from analytics_zoo_tpu_torch.onnx import load_onnx, to_model

        return to_model(load_onnx(path))

    @staticmethod
    def load_bigdl(path: str):
        raise NotImplementedError(
            "BigDL protobuf checkpoints are a JVM-era format; export the "
            "model to ONNX or TF SavedModel and use Net.load_onnx / "
            "Net.load_tf")

    @staticmethod
    def load_caffe(def_path: str, model_path: str):
        """prototxt + caffemodel -> trainable program (reference
        Net.loadCaffe, api/Net.scala:169-189; ``caffe/loader.py``);
        ``onnx.to_model`` wraps it as a KerasNet."""
        from analytics_zoo_tpu_torch.caffe import load_caffe as _load

        return _load(def_path, model_path)

    @staticmethod
    def export_tf_saved_model(model, params, path: str, input_shapes,
                              state=None):
        """Native model -> TF SavedModel: not ported."""
        raise NotImplementedError(
            f"Net.export_tf_saved_model {_TF_PENDING}")


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

    def new_graph(self, output_names: Union[str, Sequence[str]]
                  ) -> "GraphNet":
        """Cut a sub-model ending at the named layers' outputs (reference
        newGraph, NetUtils.scala): e.g. chop the classifier off an imported
        backbone and reuse the feature extractor.  The sub-model holds
        copies of the source's current weights and state, on its device;
        when the source was compiled, the sub-model is compiled too (SGD,
        mse, the source's device), so it predicts at once, and a later
        ``compile`` keeps the weights."""
        import copy

        from analytics_zoo_tpu_torch.nn.topology import Model

        single = isinstance(output_names, str)
        names = [output_names] if single else list(output_names)
        by_name = {}
        for v in self.model.order:
            if v.kind == "layer":
                by_name[v.layer.name] = v     # last node of a shared layer
        missing = [n for n in names if n not in by_name]
        if missing:
            raise ValueError(f"unknown layers {missing}; known: "
                             f"{sorted(by_name)}")
        outs = [by_name[n] for n in names]
        sub = Model(self.model.inputs, outs[0] if single else outs)
        sub._output_shape = sub.output_shape()
        # copies: the sub-model's layers are its own from here on
        sub = copy.deepcopy(sub)
        est = getattr(self.model, "_estimator", None)
        if est is not None:
            # sgd is stateless: no optimizer moments for what is typically
            # an inference-only feature extractor
            sub.compile(optimizer="sgd", loss="mse", device=est.device)
        return GraphNet(sub)

    def compile(self, *a, **kw):
        self.model.compile(*a, **kw)
        return self

    def __getattr__(self, item):
        return getattr(self.model, item)
