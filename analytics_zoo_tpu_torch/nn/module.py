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

A layer may own sub-layers under tree keys (``add_subtree``): its
``params()`` then nests theirs, as the JAX package's trees nest (BERT's
``{"enc0": {"attn": {"q": {"kernel", "bias"}}, "ln1": ...}}``), and
``set_leaf`` takes a key path into them.

A leaf may be held quantized — ``{"q", "scale"}`` (int8) or
``{"q4", "scale"}`` (packed int4), the serving tree's format.  ``leaf()``
then returns it dequantized to f32, in the forward; a layer that can use
the packed form directly (``Dense`` and its fused dequantize-matmul) reads
``qleaf()`` instead.

A layer may hold *state*: values the training forward computes but no
gradient moves (BatchNormalization's moving statistics), the JAX
package's ``state`` tree.  They are registered buffers named as in that
tree (``set_state``), so ``state()`` nests as it does (``{"stem_bn":
{"moving_mean", "moving_var"}}``); they are not in ``params()``, so never
in the optimizer's vector and never quantized.  A training forward hands
its new values to ``update_state``: inside ``collect_state_updates()``
(the Estimator's step) they are collected, to be committed once the
loss is known (``commit_state``: kept only on a finite step, as the JAX
step keeps the old state on a non-finite one); outside it they are
written at once.

Calling a layer on autograd ``Variable``s builds the model graph; calling
it on tensors runs ``forward``.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

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


# where a training forward's new state goes: a list per thread while a
# step collects it, else None (written at once)
_STATE_SINK = threading.local()


@contextlib.contextmanager
def collect_state_updates() -> Iterator[List[tuple]]:
    """Collect the ``(layer, name, new value)`` of every ``update_state``
    the calling thread makes inside the block, instead of writing them."""
    prev = getattr(_STATE_SINK, "updates", None)
    updates: List[tuple] = []
    _STATE_SINK.updates = updates
    try:
        yield updates
    finally:
        _STATE_SINK.updates = prev


def commit_state(updates: List[tuple], ok=None) -> None:
    """Write collected state updates into the live buffers, in place (a
    captured step holds them), each cast to its buffer's dtype: where
    the device scalar ``ok`` is False the old value stays.  A buffer
    updated twice (a layer shared in the graph) takes the last value."""
    if not updates:
        return
    with torch.no_grad():
        live = [layer._buffers[name] for layer, name, _ in updates]
        new = [v.to(t.dtype) for t, (_, _, v) in zip(live, updates)]
        if ok is not None:
            new = [torch.where(ok, n, t) for n, t in zip(new, live)]
        torch._foreach_copy_(live, new)


def state_buffer_names(module: nn.Module) -> set:
    """The qualified names (as ``named_buffers`` gives them) of every
    state leaf in ``module`` — not the quantized leaves' buffers."""
    return {f"{prefix}.{n}" if prefix else n
            for prefix, m in module.named_modules()
            for n in getattr(m, "_state_names", ())}


def cast_floats(module: nn.Module, dtype) -> Dict[str, torch.Tensor]:
    """``module``'s float parameters and float state leaves cast to
    ``dtype``, by qualified name, for ``torch.func.functional_call`` (the
    JAX package's ``_cast_floats`` over its params and state trees); the
    buffers of quantized leaves are left as they are."""
    out = {n: p.to(dtype) if p.is_floating_point() else p
           for n, p in module.named_parameters()}
    names = state_buffer_names(module)
    out.update({n: b.to(dtype) for n, b in module.named_buffers()
                if n in names and b.is_floating_point()})
    return out


def has_leaves(tree) -> bool:
    """Whether a (nested dict) tree holds any leaf."""
    if isinstance(tree, dict) and not is_qleaf(tree):
        return any(has_leaves(v) for v in tree.values())
    return True


def prune(tree):
    """``tree`` without its sub-trees that hold no leaf (weightless or
    stateless layers, which the two packages' trees list differently)."""
    if isinstance(tree, dict) and not is_qleaf(tree):
        return {k: prune(v) for k, v in tree.items() if has_leaves(v)}
    return tree


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
        self._state_names: list = []
        self._qkinds: Dict[str, str] = {}
        # sub-layers by tree key (their params() nest under the key)
        self._tree = nn.ModuleDict()

    # -- to be implemented by subclasses ---------------------------------
    def build(self, generator: torch.Generator, *input_shapes) -> None:
        """Allocate the leaves for the given full input shapes."""

    def output_shape(self, *input_shapes) -> Tuple[int, ...]:
        return tuple(input_shapes[0])

    # -- generic machinery ------------------------------------------------
    def add_subtree(self, key: str, layer: "Layer") -> "Layer":
        """Own ``layer`` under tree key ``key``; returns it."""
        self._tree[key] = layer
        return layer

    def subtree(self, key: str) -> "Layer":
        """The sub-layer whose leaves nest under ``key``."""
        if key not in self._tree:
            raise KeyError(f"{self.name} has no sub-tree {key!r}")
        return self._tree[key]

    def set_leaf(self, name, value) -> None:
        """Install leaf ``name`` — a leaf name, or a key path (a tuple)
        through sub-trees to one: a tensor (becomes a Parameter on the
        device of the leaf it replaces) or a quantized leaf dict."""
        path = (name,) if isinstance(name, str) else tuple(name)
        if len(path) > 1:
            self.subtree(path[0]).set_leaf(path[1:], value)
            return
        name = path[0]
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
        """This layer's leaves by name — tensors, or quantized leaf dicts —
        and its sub-layers' trees by key."""
        out = {n: (self.qleaf(n) if n in self._qkinds
                   else self._parameters[n].detach())
               for n in self._leaf_names}
        out.update({k: sub.params() for k, sub in self._tree.items()})
        return out

    # -- state -------------------------------------------------------------
    def set_state(self, name, value) -> None:
        """Install state leaf ``name`` (a name or a key path through
        sub-trees).  A live leaf of the same shape is overwritten in
        place, cast to its dtype, since a captured step holds it; else
        the value becomes a buffer on the device of the leaf it
        replaces."""
        path = (name,) if isinstance(name, str) else tuple(name)
        if len(path) > 1:
            self.subtree(path[0]).set_state(path[1:], value)
            return
        name = path[0]
        t = torch.as_tensor(value)
        live = self._buffers.get(name) if name in self._state_names else None
        if live is not None and live.shape == t.shape:
            with torch.no_grad():
                live.copy_(t.to(live.dtype))
            return
        dev = live.device if live is not None else torch.device("cpu")
        self.register_buffer(name, t.detach().to(dev).clone())
        if name not in self._state_names:
            self._state_names.append(name)

    def state_leaf(self, name: str) -> torch.Tensor:
        """State leaf ``name`` as the forward sees it."""
        return self._buffers[name]

    def update_state(self, name: str, value: torch.Tensor) -> None:
        """A training forward's new value of state leaf ``name``:
        collected when a step collects (``collect_state_updates``), else
        written at once."""
        sink = getattr(_STATE_SINK, "updates", None)
        if sink is not None:
            sink.append((self, name, value))
        else:
            commit_state([(self, name, value)])

    def state(self) -> Dict[str, object]:
        """This layer's state leaves by name, and its sub-layers' state
        trees by key (those that hold any)."""
        out = {n: self._buffers[n].detach() for n in self._state_names}
        for k, sub in self._tree.items():
            st = sub.state()
            if has_leaves(st):
                out[k] = st
        return out

    # -- symbolic application (autograd DSL) ------------------------------
    def __call__(self, *args, **kw):
        """Applied to ``Variable``s → a new graph ``Variable``; applied to
        tensors → ``forward``."""
        from analytics_zoo_tpu_torch.nn.autograd import Variable, apply_layer

        if args and all(isinstance(a, Variable) for a in args):
            return apply_layer(self, args)
        return super().__call__(*args, **kw)


class StatelessLayer(Layer):
    """A layer that holds no state leaves (the JAX package's base of the
    same name; here every layer is a ``Layer``, and this one only adds
    the output shape).  Its output shape comes from running ``forward`` on
    meta tensors of the input shapes, so a shape-changing layer needs no
    shape rule of its own; a layer whose forward reads its leaves or
    draws from a generator gives its own."""

    def output_shape(self, *input_shapes):
        metas = [torch.empty(s, device="meta") for s in input_shapes]
        return tuple(self.forward(*metas).shape)
