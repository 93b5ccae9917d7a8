"""Weights across packages, by key path: load a JAX-package parameter tree
into a port model (``load_jax_params``), and export a port model's
weights as such a tree (``export_params``).

Trees nest as the JAX package's do — ``{layer_name: {leaf: array}}`` for
flat layers, deeper for the attention layers (``{"enc0": {"attn": {"q":
{"kernel", "bias"}}}}``), a stacked ``blocks`` sub-tree whose leaves carry
a leading ``n_block`` dim, and entries that are not layers (BERTClassifier's
``"head"``).  A quantized ``{"q"|"q4", "scale"}`` dict is a leaf wherever
it sits.

Every leaf travels by key path and shape, so a layer's leaves need no
code here: ``Deconvolution2D``'s kernel (kh, kw, in, out), the locally
connected layers' per-position kernels ((positions, patch, out)) and
biases, SSD's convolution and BN leaves load as ResNet-50's do, and so
do the AutoML blocks' nested trees: ``MTNetBlock``'s ``mem`` / ``ctx`` /
``query`` encoders with their ``gru{i}`` sub-trees, heads and AR leaves,
and the encoder-decoder's ``enc`` / ``dec`` sub-trees (a wrong shape or a
missing leaf names its path, e.g. ``mtnetblock_1.mem.gru0.wh``).

State trees (BatchNormalization's moving statistics, ``{layer_name:
{"moving_mean", "moving_var"}}``) load and export the same way, beside
the parameters; sub-trees without leaves (stateless layers, listed by
the JAX package as ``{}``) are left out on both sides before they are
compared.

An imported model (``tfpark.FunctionModel`` over an ONNX or Caffe
program) has the JAX ``FunctionModel``'s flat tree, ``{onnx_name:
array}`` with dotted names such as ``layer1.0.conv1.weight``; a
converted torch ``Sequential`` has ``{torch_{i}_{type}: {leaf}}``.
``program_params`` takes that tree from a JAX ``FunctionModel`` (its
trained weights), a program, or an int8 program (its quantized weights
as ``{"q", "scale"}`` leaves), so JAX-trained or JAX-quantized weights
load into the port's model by name and serve there."""

from __future__ import annotations

import numpy as np
import torch

from analytics_zoo_tpu_torch.nn.module import has_leaves, is_qleaf, prune


def _as_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach()
    a = np.array(a)
    if a.dtype.name == "bfloat16":   # a JAX bf16 leaf, as numpy holds it
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _is_subtree(x) -> bool:
    return isinstance(x, dict) and not is_qleaf(x)


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


def _float_shape(qleaf: dict) -> tuple:
    if "q4" in qleaf:
        rows, cols = qleaf["q4"].shape
        return (2 * rows, cols)
    return tuple(qleaf["q"].shape)


def _stage(have: dict, given, path: tuple, staged: list,
           what: str = "parameter") -> None:
    """Check ``given`` against the model's tree ``have`` under ``path``
    and append ``(key path, value)`` for each leaf."""
    where = ".".join(path)
    if not _is_subtree(given):
        raise ValueError(f"{where}: expected a sub-tree with keys "
                         f"{sorted(have)}, got a leaf")
    extra = sorted(set(given) - set(have))
    missing = sorted(set(have) - set(given))
    if extra or missing:
        if not path:
            raise ValueError(f"{what} tree does not match the model: "
                             f"missing layers {missing}, extra layers "
                             f"{extra}")
        raise ValueError(f"{where}: missing leaves {missing}, extra leaves "
                         f"{extra}")
    for key, cur in have.items():
        sub, value = path + (key,), given[key]
        if _is_subtree(cur):
            _stage(cur, value, sub, staged, what)
            continue
        where = ".".join(sub)
        want = _float_shape(cur) if is_qleaf(cur) else tuple(cur.shape)
        if _is_subtree(value):
            raise ValueError(f"{where}: expected a leaf of shape {want}, "
                             f"got a sub-tree")
        if is_qleaf(value):
            staged.append((sub, _check_qleaf(where, want, value)))
            continue
        t = _as_tensor(value)
        if tuple(t.shape) != want:
            raise ValueError(f"{where}: shape {tuple(t.shape)} != "
                             f"model's {want}")
        if t.is_floating_point() and not is_qleaf(cur):
            t = t.to(cur.dtype)
        staged.append((sub, t))


def load_jax_params(model, params, state=None) -> None:
    """Fill ``model`` (a port ``KerasNet``, or any layer) from ``params``,
    a JAX-package tree of numpy arrays or tensors, float leaves or
    quantized ``{"q"|"q4", "scale"}`` leaves, and from ``state`` (the
    JAX state tree) when it is given.

    Raises on a missing or extra key or a leaf whose shape does not fit,
    naming its full path; nothing is changed before every leaf of both
    trees has been checked.  A float leaf of the live parameter's shape
    and dtype is copied into that parameter's storage, which a captured
    training step (``core/graphs.py``) may hold; other leaves replace
    theirs.  State leaves are always copied into the live buffers, cast
    to their dtype.
    """
    staged: list = []
    _stage(model.params(), params, (), staged)
    staged_state: list = []
    if state is not None:
        _stage(prune(model.state()), prune(state), (), staged_state,
               "state")
        for path, value in staged_state:
            if is_qleaf(value):
                raise ValueError(f"{'.'.join(path)}: a state leaf cannot "
                                 f"be quantized")
    for path, value in staged_state:
        model.set_state(path, value)
    for path, value in staged:
        live = _live_parameter(model, path)
        if (live is not None and not is_qleaf(value)
                and value.shape == live.shape and value.dtype == live.dtype):
            with torch.no_grad():
                live.copy_(value)
        else:
            model.set_leaf(path, value)


def _live_parameter(model, path):
    """The parameter ``set_leaf`` would replace at key path ``path``, or
    None: a quantized leaf, or a layer on the path with a ``set_leaf`` of
    its own (a stacked tree, which splits the leaf across its blocks)."""
    from analytics_zoo_tpu_torch.nn.module import Layer

    layer = model
    for depth, key in enumerate(path):
        if type(layer).set_leaf is not Layer.set_leaf:
            return None
        if depth < len(path) - 1:
            layer = layer.subtree(key)
    if path[-1] in layer._qkinds:
        return None
    return layer._parameters.get(path[-1])


def export_params(model) -> dict:
    """The reverse of ``load_jax_params``: ``model``'s weights as the JAX
    package's tree on the host (a quantized leaf as its ``{"q"|"q4",
    "scale"}`` arrays).  The arrays are copies: training the model on
    goes on without changing them."""
    def host(t):
        if _is_subtree(t):
            return {k: host(v) for k, v in t.items()}
        if is_qleaf(t):
            return {k: host(v) for k, v in t.items()}
        return t.detach().cpu().numpy().copy()

    return host(model.params())


def export_state(model) -> dict:
    """``model``'s state as the JAX package's tree on the host (copies)."""
    def host(t):
        if _is_subtree(t):
            return {k: host(v) for k, v in t.items()}
        return t.detach().cpu().numpy().copy()

    return host(model.state())


def load_archive_params(model, params, state=None) -> None:
    """``load_jax_params`` for trees read from an archive
    (``train.checkpoint.load_pytree``), which holds no entry for a sub-tree
    without leaves (a weightless layer): those are taken from the model.
    ``state`` None (an archive without state leaves) leaves the model's
    state as it is."""
    def fill(have, given):
        if not (_is_subtree(have) and _is_subtree(given)):
            return given
        out = dict(given)
        for key, sub in have.items():
            if key in out:
                out[key] = fill(sub, out[key])
            elif not has_leaves(sub):
                out[key] = sub
        return out

    load_jax_params(model, fill(model.params(), params), state)


def program_params(source) -> dict:
    """The parameter tree of an imported model, ready for
    ``load_jax_params``: of a ``FunctionModel`` (either package's) its
    estimator's live weights once built, else its program's; of a
    program (``OnnxProgram``, ``GraphProgram``, ``QuantizedProgram``) its
    ``params``, with a quantized program's int8 weights as ``{"q",
    "scale"}`` leaves under their initializer names; a tree as it is."""
    est = getattr(source, "_estimator", None)
    live = getattr(est, "params", None) if est is not None else None
    if isinstance(live, dict):
        return live
    prog = getattr(source, "program", source)
    tree = getattr(prog, "params", prog)
    qweights = getattr(prog, "qweights", None)
    if qweights:
        tree = dict(tree)
        tree.update({name: {"q": q, "scale": s}
                     for name, (q, s) in qweights.items()})
    return tree
