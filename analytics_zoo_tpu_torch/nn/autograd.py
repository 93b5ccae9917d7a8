"""Symbolic graph DSL: ``Variable`` nodes, ``Input``, and DAG evaluation.

A ``Variable`` is a node in a lightweight DAG: ``input`` nodes are
placeholders, ``layer`` nodes apply a ``Layer``, ``lambda`` nodes apply a
plain function of tensors (the arithmetic operators).  ``Model`` walks
the topologically sorted DAG once per forward.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

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
    def __sub__(self, o): return self._binop(o, lambda a, b: a - b, "sub")
    def __mul__(self, o): return self._binop(o, lambda a, b: a * b, "mul")
    def __truediv__(self, o): return self._binop(o, lambda a, b: a / b, "div")

    def __neg__(self):
        return Variable("lambda", (self,), fn=lambda a: -a, name="neg")

    def __repr__(self):
        return f"Variable({self.name}, kind={self.kind}, shape={self.shape})"


def Input(shape: Sequence[int], name: Optional[str] = None,
          dtype=torch.float32) -> Variable:
    """Create an input placeholder; ``shape`` excludes the batch dim."""
    return Variable("input", shape=(None,) + tuple(shape), name=name,
                    dtype=dtype)


def apply_layer(layer, args: Sequence[Variable]) -> Variable:
    return Variable("layer", args, layer=layer, name=layer.name)


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
