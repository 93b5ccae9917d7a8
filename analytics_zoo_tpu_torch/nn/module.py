"""Layer protocol — the base of the Keras-style API.

A layer is a ``torch.nn.Module`` that owns its weights.  Its weights are
*leaves* named as in the JAX package's parameter tree, so
``model.params()[layer_name][leaf]`` addresses the same tensor in both
packages and weights carry across by name (``convert.load_jax_params``).

    build(generator, *input_shapes)  allocate the leaves (explicit
                                     torch.Generator, full shapes with
                                     the batch dim)
    output_shape(*input_shapes)      the output shape, without computing
    forward(*inputs)                 the computation

A leaf may be held quantized — ``{"q", "scale"}`` (int8) or
``{"q4", "scale"}`` (packed int4), the serving tree's format.  ``leaf()``
then returns it dequantized to f32, in the forward; a layer that can use
the packed form directly (``Dense`` and its fused dequantize-matmul) reads
``qleaf()`` instead.

Calling a layer on autograd ``Variable``s builds the model graph; calling
it on tensors runs ``forward``.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from analytics_zoo_tpu_torch.ops.dequant_matmul import dequantize_leaf

QLEAF_KINDS = ("q", "q4")

# Auto-naming counters are THREAD-LOCAL: concurrent model builds each get
# an isolated scope, so two threads never race into colliding names.
_NAME_SCOPE = threading.local()


def _counters() -> Dict[str, int]:
    if not hasattr(_NAME_SCOPE, "counters"):
        _NAME_SCOPE.counters = collections.defaultdict(int)
    return _NAME_SCOPE.counters


def _auto_name(cls_name: str) -> str:
    c = _counters()
    c[cls_name] += 1
    return f"{cls_name.lower()}_{c[cls_name]}"


def reset_name_scope() -> None:
    """Reset the calling thread's auto-naming counters (test isolation)."""
    _counters().clear()


def is_qleaf(x) -> bool:
    return (isinstance(x, dict)
            and set(x) in ({"q", "scale"}, {"q4", "scale"}))


class Layer(nn.Module):
    """Base class for all layers and containers."""

    def __init__(self, name: Optional[str] = None,
                 input_shape: Optional[Sequence[int]] = None):
        super().__init__()
        self.name = name or _auto_name(type(self).__name__)
        # Keras-style input_shape excludes the batch dim.
        self.input_shape = (tuple(input_shape) if input_shape is not None
                            else None)
        self._leaf_names: list = []
        self._qkinds: Dict[str, str] = {}

    # -- to be implemented by subclasses ---------------------------------
    def build(self, generator: torch.Generator, *input_shapes) -> None:
        """Allocate the leaves for the given full input shapes."""

    def output_shape(self, *input_shapes) -> Tuple[int, ...]:
        return tuple(input_shapes[0])

    # -- generic machinery ------------------------------------------------
    def set_leaf(self, name: str, value) -> None:
        """Install leaf ``name``: a tensor (becomes a Parameter on the
        device of the leaf it replaces) or a quantized leaf dict."""
        old = self._leaf_device(name)
        self._parameters.pop(name, None)
        for kind in QLEAF_KINDS + ("scale",):
            self._buffers.pop(f"{name}_{kind}", None)
        self._qkinds.pop(name, None)
        if name not in self._leaf_names:
            self._leaf_names.append(name)
        if is_qleaf(value):
            kind = "q4" if "q4" in value else "q"
            self.register_buffer(f"{name}_{kind}",
                                 torch.as_tensor(value[kind]).to(old))
            self.register_buffer(f"{name}_scale",
                                 torch.as_tensor(value["scale"]).to(old))
            self._qkinds[name] = kind
        else:
            t = torch.as_tensor(value).to(old)
            self.register_parameter(
                name, nn.Parameter(t, requires_grad=t.is_floating_point()))

    def _leaf_device(self, name: str) -> torch.device:
        q = self.qleaf(name)
        if q is not None:
            return q["scale"].device
        p = self._parameters.get(name)
        return p.device if p is not None else torch.device("cpu")

    def qleaf(self, name: str) -> Optional[dict]:
        """Leaf ``name`` in its quantized form, or None if it is not."""
        kind = self._qkinds.get(name)
        if kind is None:
            return None
        return {kind: self._buffers[f"{name}_{kind}"],
                "scale": self._buffers[f"{name}_scale"]}

    def leaf(self, name: str) -> torch.Tensor:
        """Leaf ``name`` as a float tensor (dequantized if quantized)."""
        q = self.qleaf(name)
        return dequantize_leaf(q) if q is not None else self._parameters[name]

    def params(self) -> Dict[str, object]:
        """This layer's leaves by name: tensors, or quantized leaf dicts."""
        return {n: (self.qleaf(n) if n in self._qkinds
                    else self._parameters[n].detach())
                for n in self._leaf_names}

    # -- symbolic application (autograd DSL) ------------------------------
    def __call__(self, *args, **kw):
        """Applied to ``Variable``s → a new graph ``Variable``; applied to
        tensors → ``forward``."""
        from analytics_zoo_tpu_torch.nn.autograd import Variable, apply_layer

        if args and all(isinstance(a, Variable) for a in args):
            return apply_layer(self, args)
        return super().__call__(*args, **kw)
