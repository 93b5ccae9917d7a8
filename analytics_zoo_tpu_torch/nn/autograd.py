"""Symbolic graph DSL: ``Variable`` nodes, ``Input``, ``Parameter``, the
free functions of the JAX package's ``nn/autograd.py``, and DAG
evaluation.

A ``Variable`` is a node in a lightweight DAG: ``input`` nodes are
placeholders, ``layer`` nodes apply a ``Layer`` (a ``Parameter`` is a
layer node without parents whose one leaf, ``value``, is the tensor),
``lambda`` nodes apply a plain function of tensors (the arithmetic
operators, slicing, the free functions).  ``Model`` walks the
topologically sorted DAG once per forward.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.nn import initializers
from analytics_zoo_tpu_torch.nn.module import Layer

_var_ids = itertools.count()
_KINDS = ("input", "layer", "lambda")


class Variable:
    """A symbolic tensor in the model DAG."""

    def __init__(self, kind: str, parents: Sequence["Variable"] = (),
                 layer=None, fn: Optional[Callable] = None,
                 shape: Optional[Tuple[Optional[int], ...]] = None,
                 name: Optional[str] = None, dtype=torch.float32):
        if kind not in _KINDS:
            raise ValueError(f"Variable kind must be one of {_KINDS}, "
                             f"got {kind!r}")
        self.kind = kind
        self.parents = tuple(parents)
        self.layer = layer
        self.fn = fn
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.id = next(_var_ids)
        self.name = name or f"var_{self.id}"

    def _binop(self, other, fn, name):
        if isinstance(other, Variable):
            return Variable("lambda", (self, other), fn=fn, name=name)
        const = other
        return Variable("lambda", (self,), fn=lambda a: fn(a, const),
                        name=name)

    def __add__(self, o): return self._binop(o, lambda a, b: a + b, "add")
    def __radd__(self, o): return self._binop(o, lambda a, b: b + a, "radd")
    def __sub__(self, o): return self._binop(o, lambda a, b: a - b, "sub")
    def __rsub__(self, o): return self._binop(o, lambda a, b: b - a, "rsub")
    def __mul__(self, o): return self._binop(o, lambda a, b: a * b, "mul")
    def __rmul__(self, o): return self._binop(o, lambda a, b: b * a, "rmul")
    def __truediv__(self, o): return self._binop(o, lambda a, b: a / b, "div")
    def __rtruediv__(self, o):
        return self._binop(o, lambda a, b: b / a, "rdiv")
    def __pow__(self, o): return self._binop(o, lambda a, b: a ** b, "pow")

    def __neg__(self):
        return _unary(self, lambda a: -a, "neg")

    # -- slicing on any dim (the reference's slice / indexSelect) ---------
    def __getitem__(self, idx):
        return _unary(self, lambda a: a[idx], "slice")

    def slice(self, dim: int, start: int, length: int):
        """``length`` entries of ``dim`` from ``start`` (the dim stays)."""
        return _unary(self, lambda a: a.narrow(dim, start, length), "slice")

    def index_select(self, dim: int, index):
        """``jnp.take(a, index, axis=dim)``: an int index drops ``dim``."""
        def fn(a):
            if isinstance(index, int):
                return a.select(dim, index)
            idx = torch.as_tensor(index, device=a.device).to(torch.int64)
            return a.index_select(dim, idx.reshape(-1)).reshape(
                a.shape[:dim % a.ndim] + tuple(idx.shape)
                + a.shape[dim % a.ndim + 1:])
        return _unary(self, fn, "index_select")

    def squeeze(self, dim: Optional[int] = None):
        return _unary(self, lambda a: a.squeeze() if dim is None
                      else a.squeeze(dim), "squeeze")

    def expand_dims(self, axis: int):
        return _unary(self, lambda a: a.unsqueeze(axis), "expand_dims")

    def reshape(self, *shape):
        """The full shape, batch dim included (as ``jnp.reshape``)."""
        return _unary(self, lambda a: a.reshape(shape), "reshape")

    def __repr__(self):
        return f"Variable({self.name}, kind={self.kind}, shape={self.shape})"


def Input(shape: Sequence[int], name: Optional[str] = None,
          dtype=torch.float32) -> Variable:
    """Create an input placeholder; ``shape`` excludes the batch dim."""
    return Variable("input", shape=(None,) + tuple(shape), name=name,
                    dtype=dtype)


def apply_layer(layer, args: Sequence[Variable]) -> Variable:
    return Variable("layer", args, layer=layer, name=layer.name)


class _Param(Layer):
    """The layer of a ``Parameter``: one leaf, ``value``, of ``shape``."""

    def __init__(self, shape, init, **kw):
        super().__init__(**kw)
        self.shape = tuple(shape)
        self.initializer = initializers.get(init)

    def build(self, generator, *unused):
        self.set_leaf("value", self.initializer(generator, self.shape))

    def output_shape(self, *unused):
        return self.shape

    def forward(self, *unused):
        return self.leaf("value")


def Parameter(shape: Sequence[int], init="glorot_uniform",
              name: Optional[str] = None) -> Variable:
    """A trainable free tensor of ``shape`` (no batch dim): a layer node
    without parents, whose tree is ``{name: {"value": tensor}}``."""
    layer = _Param(shape, init, name=name)
    return Variable("layer", (), layer=layer, name=layer.name)


# ----------------------------------------------------------------------
# free functions (the JAX package's, over torch)
# ----------------------------------------------------------------------

def _unary(v: Variable, fn, name) -> Variable:
    return Variable("lambda", (v,), fn=fn, name=name)


def abs(v): return _unary(v, torch.abs, "abs")              # noqa: A001
def square(v): return _unary(v, torch.square, "square")
def sqrt(v): return _unary(v, torch.sqrt, "sqrt")
def log(v): return _unary(v, torch.log, "log")
def exp(v): return _unary(v, torch.exp, "exp")
def erf(v): return _unary(v, torch.erf, "erf")
def softsign(v): return _unary(v, F.softsign, "softsign")


def softplus(v):
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it."""
    return _unary(v, lambda x: torch.logaddexp(x, torch.zeros_like(x)),
                  "softplus")


def pow(v, a):                                              # noqa: A001
    return _unary(v, lambda x: x ** a, "pow")


def clip(v, min, max):                                      # noqa: A002
    return _unary(v, lambda x: torch.clamp(x, min, max), "clip")


def sum(v, axis: int = 0, keepdims: bool = False):          # noqa: A001
    return _unary(v, lambda x: torch.sum(x, dim=axis, keepdim=keepdims),
                  "sum")


def mean(v, axis: int = 0, keepdims: bool = False):
    return _unary(v, lambda x: torch.mean(x, dim=axis, keepdim=keepdims),
                  "mean")


def maximum(a, b):
    if isinstance(a, Variable) and isinstance(b, Variable):
        return Variable("lambda", (a, b), fn=torch.maximum, name="maximum")
    if isinstance(a, Variable):
        return _unary(a, lambda x: torch.clamp(x, min=b), "maximum")
    return _unary(b, lambda x: torch.clamp(x, min=a), "maximum")


def stack(vars: Sequence[Variable], axis: int = 1) -> Variable:  # noqa: A002
    return Variable("lambda", tuple(vars),
                    fn=lambda *xs: torch.stack(xs, dim=axis), name="stack")


def expand_dims(v, axis: int):
    return v.expand_dims(axis)


def contiguous(v):
    return _unary(v, lambda x: x.contiguous(), "contiguous")


def _batched_dot(x, y, axes):
    """``lax.dot_general`` with batch dim 0 on both sides, contracting
    ``x``'s ``axes[0]`` with ``y``'s ``axes[1]``: (B, x's other dims...,
    y's other dims...)."""
    x = x.movedim(axes[0], -1)
    y = y.movedim(axes[1], 1)
    fx, fy = x.shape[1:-1], y.shape[2:]
    out = torch.bmm(x.reshape(x.shape[0], -1, x.shape[-1]),
                    y.reshape(y.shape[0], y.shape[1], -1))
    return out.reshape((x.shape[0],) + tuple(fx) + tuple(fy))


def mm(a: Variable, b: Variable, axes: Optional[Tuple[int, int]] = None):
    """Batched matmul: ``torch.matmul``, or with ``axes`` the contraction
    of ``a``'s ``axes[0]`` with ``b``'s ``axes[1]`` over batch dim 0."""
    if axes is None:
        return Variable("lambda", (a, b), fn=torch.matmul, name="mm")
    return Variable("lambda", (a, b),
                    fn=lambda x, y: _batched_dot(x, y, axes), name="mm")


def batch_dot(a: Variable, b: Variable, axes: Tuple[int, int] = (1, 1)):
    return mm(a, b, axes=axes)


def l2_normalize(v, axis: int = -1):
    return _unary(v, lambda x: x / (torch.linalg.vector_norm(
        x, dim=axis, keepdim=True) + 1e-12), "l2_normalize")


def topo_sort(outputs: Sequence[Variable]) -> List[Variable]:
    seen: Dict[int, Variable] = {}
    order: List[Variable] = []

    def visit(v: Variable):
        if v.id in seen:
            return
        seen[v.id] = v
        for p in v.parents:
            visit(p)
        order.append(v)

    for out in outputs:
        visit(out)
    return order


def evaluate(order: List[Variable], env: Dict[int, Any]) -> Dict[int, Any]:
    """Evaluate a topo-sorted DAG; ``env`` seeds input nodes (by var id).
    Returns the full env."""
    for v in order:
        if v.id in env:
            continue
        if v.kind == "input":
            raise ValueError(f"missing value for input {v.name}")
        parent_vals = [env[p.id] for p in v.parents]
        if v.kind == "layer":
            env[v.id] = v.layer(*parent_vals)
        else:
            env[v.id] = v.fn(*parent_vals)
    return env
