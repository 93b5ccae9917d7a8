"""Weights across packages: load a JAX-package parameter tree into a port
model by layer and leaf name."""

from __future__ import annotations

import numpy as np
import torch

from analytics_zoo_tpu_torch.nn.module import is_qleaf


def _as_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach()
    return torch.from_numpy(np.array(a))


def _check_qleaf(where: str, want: tuple, leaf: dict) -> dict:
    """A quantized leaf must decode to the float leaf's shape: ``q`` the
    same shape, ``q4`` half the (even) rows of a 2-D leaf, and a scale
    with one entry per last-axis channel."""
    kind = "q4" if "q4" in leaf else "q"
    q, scale = _as_tensor(leaf[kind]), _as_tensor(leaf["scale"])
    if kind == "q4":
        ok = (len(want) == 2 and want[0] % 2 == 0
              and tuple(q.shape) == (want[0] // 2, want[1]))
    else:
        ok = tuple(q.shape) == want
    if not ok or q.dtype != torch.int8 or scale.numel() not in (
            want[-1] if want else 1, 1):
        raise ValueError(
            f"{where}: quantized leaf {kind} {tuple(q.shape)} {q.dtype} "
            f"with scale {tuple(scale.shape)} does not fit the leaf shape "
            f"{want}")
    return {kind: q, "scale": scale.to(torch.float32)}


def load_jax_params(model, params) -> None:
    """Fill ``model`` (a port ``KerasNet``) from ``params``, the JAX
    package's tree ``{layer_name: {leaf: array}}`` — numpy arrays or
    tensors, float leaves or quantized ``{"q"|"q4", "scale"}`` leaves.

    Raises on a missing or extra layer or leaf, and on a leaf whose shape
    does not fit; nothing is changed before every leaf has been checked.
    """
    layers = {layer.name: layer for layer in model.layers}
    extra = sorted(set(params) - set(layers))
    missing = sorted(set(layers) - set(params))
    if extra or missing:
        raise ValueError(f"parameter tree does not match the model: "
                         f"missing layers {missing}, extra layers {extra}")
    staged = []
    for name, layer in layers.items():
        have = layer.params()
        given = params[name]
        extra = sorted(set(given) - set(have))
        missing = sorted(set(have) - set(given))
        if extra or missing:
            raise ValueError(f"layer {name}: missing leaves {missing}, "
                             f"extra leaves {extra}")
        for leaf, value in given.items():
            cur = have[leaf]
            want = (tuple(cur.shape) if not is_qleaf(cur) else
                    _float_shape(cur))
            where = f"{name}.{leaf}"
            if is_qleaf(value):
                staged.append((layer, leaf, _check_qleaf(where, want, value)))
                continue
            t = _as_tensor(value)
            if tuple(t.shape) != want:
                raise ValueError(f"{where}: shape {tuple(t.shape)} != "
                                 f"model's {want}")
            if t.is_floating_point() and not is_qleaf(cur):
                t = t.to(cur.dtype)
            staged.append((layer, leaf, t))
    for layer, leaf, value in staged:
        layer.set_leaf(leaf, value)


def _float_shape(qleaf: dict) -> tuple:
    if "q4" in qleaf:
        rows, cols = qleaf["q4"].shape
        return (2 * rows, cols)
    return tuple(qleaf["q"].shape)
