"""ONNX graph -> a torch program (the JAX package's ``onnx/loader.py``).

Ops lower directly to torch functions in a topologically ordered
tensor-environment program, with the float initializers as the trainable
parameter tree (a flat ``{tensor_name: array}``), so an imported model
both predicts and trains (``to_model`` -> ``tfpark.FunctionModel``).
Convolutions and pools stay NCHW, as ONNX and the JAX package keep them.

Host values.  Integer initializers, ``Constant`` values and ``Shape``
results are numpy arrays on the host, and a node whose inputs are all
host values runs on the host (on CPU tensors, its result back in numpy):
a ``Shape -> Gather -> Unsqueeze -> Concat -> Reshape`` chain never
touches the device, so it neither copies to the host nor breaks a CUDA
graph's capture.  A host value that meets a device tensor is copied to
the device once and kept (``OnnxProgram.device_value``): the first,
eager run of a program fills the copies a captured replay then reads.
Host floats are f32 and host integers keep their width (the JAX package,
without x64, holds them in 32 bits; the values are the same).

Dropout draws its masks from the ``torch.Generator`` passed as ``rng``
(the Estimator's, through ``FunctionModel``); the law is the JAX
package's (keep with probability ``1 - ratio``, scale by its inverse),
the bits are not ``jax.random``'s.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.onnx import proto

__all__ = ["load_onnx", "load_onnx_bytes", "to_model", "OnnxProgram",
           "UnsupportedOnnxOp"]


class UnsupportedOnnxOp(ValueError):
    pass


def is_host(v) -> bool:
    return isinstance(v, (np.ndarray, np.generic))


def _host_array(v) -> np.ndarray:
    """A host value as numpy, floats at f32 (f16 kept)."""
    a = np.asarray(v)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return a


def _ints(v) -> List[int]:
    """Integer list of a shape-like input (host array, or a tensor, which
    is read back: eager only)."""
    if isinstance(v, torch.Tensor):
        return [int(a) for a in v.reshape(-1).tolist()]
    return [int(a) for a in np.asarray(v).reshape(-1)]


def _scalar(v):
    """A scalar input as a Python number (host) or a 0-d tensor."""
    if v is None or isinstance(v, torch.Tensor):
        return v
    return np.asarray(v).item()


def _pads_to_pairs(pads: Sequence[int], spatial: int):
    """ONNX pads [b1..bn, e1..en] -> [(b1, e1), ...]."""
    if not pads:
        return [(0, 0)] * spatial
    return [(int(pads[i]), int(pads[i + spatial])) for i in range(spatial)]


def _auto_pad_or_pads(attrs, spatial: int):
    """Resolve ONNX auto_pad/pads: "SAME" for SAME_UPPER (resolved against
    the shapes by the op), else explicit (begin, end) pairs.  SAME_LOWER
    raises, as in the JAX package (its SAME pads at the end)."""
    auto_pad = attrs.get("auto_pad", b"NOTSET")
    if isinstance(auto_pad, bytes):
        auto_pad = auto_pad.decode()
    if auto_pad == "SAME_UPPER":
        return "SAME"
    if auto_pad == "SAME_LOWER":
        raise UnsupportedOnnxOp(
            "auto_pad=SAME_LOWER (lax SAME pads at the end; re-export "
            "with explicit pads)")
    return _pads_to_pairs(attrs.get("pads", []), spatial)


def _same_pairs(sizes, kernel, strides, dilations=None):
    """lax's SAME: out = ceil(in / stride), the total pad split with the
    extra element at the end."""
    out = []
    for i, n in enumerate(sizes):
        d = dilations[i] if dilations else 1
        k = (kernel[i] - 1) * d + 1
        o = -(-n // strides[i])
        total = max(0, (o - 1) * strides[i] + k - n)
        out.append((total // 2, total - total // 2))
    return out


def _pad_spatial(x, pairs, value=0.0):
    """Pad the trailing spatial dims of ``x`` by (begin, end) pairs."""
    if not any(a or b for a, b in pairs):
        return x
    flat = []
    for a, b in reversed(pairs):
        flat += [a, b]
    return F.pad(x, flat, value=value)


def _window_sum(x, ks, strides):
    """Sum over each pooling window (no padding)."""
    spatial = x.ndim - 2
    if spatial == 1:
        return F.avg_pool2d(x.unsqueeze(-1), (ks[0], 1), (strides[0], 1),
                            divisor_override=1).squeeze(-1)
    pool = F.avg_pool2d if spatial == 2 else F.avg_pool3d
    return pool(x, ks, strides, divisor_override=1)


def _max_pool(x, ks, strides):
    spatial = x.ndim - 2
    return (F.max_pool1d, F.max_pool2d, F.max_pool3d)[spatial - 1](
        x, ks, strides)


# each mapper: (node) -> fn(xs, training, rng) -> tensor (or host value);
# xs are the resolved inputs in node-input order.  A mapper's
# ``host_inputs`` lists the positions it reads on the host (shapes,
# axes, pads): those are not copied to the device.

def _reads_host(*positions, scalars_only=False):
    """Mark the input positions a mapper reads on the host; with
    ``scalars_only``, only 0-d host values there stay on the host."""
    def mark(fn):
        fn.host_inputs = frozenset(positions)
        fn.host_scalars_only = scalars_only
        return fn
    return mark


def _mk_conv(node):
    attrs = node.attrs

    def fn(xs, training, rng):
        x, w = xs[0], xs[1]
        spatial = x.ndim - 2
        strides = tuple(int(v) for v in attrs.get("strides",
                                                  [1] * spatial))
        dil = tuple(int(v) for v in attrs.get("dilations", [1] * spatial))
        groups = int(attrs.get("group", 1))
        pairs = _auto_pad_or_pads(attrs, spatial)
        if pairs == "SAME":
            pairs = _same_pairs(x.shape[2:], w.shape[2:], strides, dil)
        if all(a == b for a, b in pairs):
            padding = tuple(a for a, _ in pairs)
        else:
            x, padding = _pad_spatial(x, pairs), 0
        bias = xs[2] if len(xs) > 2 else None
        conv = (F.conv1d, F.conv2d, F.conv3d)[spatial - 1]
        return conv(x, w, bias, strides, padding, dil, groups)

    return fn


def _mk_pool(node, mode):
    attrs = node.attrs
    if int(attrs.get("ceil_mode", 0)):
        raise UnsupportedOnnxOp("pooling with ceil_mode=1")

    def fn(xs, training, rng):
        x = xs[0]
        spatial = x.ndim - 2
        if mode in ("gmax", "gavg"):
            dims = tuple(range(2, x.ndim))
            if mode == "gmax":
                return x.amax(dim=dims, keepdim=True)
            return x.mean(dim=dims, keepdim=True)
        ks = tuple(int(v) for v in attrs["kernel_shape"])
        strides = tuple(int(v) for v in attrs.get("strides", [1] * spatial))
        pairs = _auto_pad_or_pads(attrs, spatial)
        if pairs == "SAME":
            pairs = _same_pairs(x.shape[2:], ks, strides)
        if mode == "max":
            return _max_pool(_pad_spatial(x, pairs, -math.inf), ks, strides)
        summed = _window_sum(_pad_spatial(x, pairs), ks, strides)
        if int(attrs.get("count_include_pad", 0)):
            return summed / float(np.prod(ks))
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        counts = _window_sum(_pad_spatial(ones, pairs), ks, strides)
        return summed / counts

    return fn


def _mk_gemm(node):
    attrs = node.attrs

    def fn(xs, training, rng):
        a, b = xs[0], xs[1]
        if int(attrs.get("transA", 0)):
            a = a.t()
        if int(attrs.get("transB", 0)):
            b = b.t()
        y = float(attrs.get("alpha", 1.0)) * (a @ b)
        if len(xs) > 2:
            y = y + float(attrs.get("beta", 1.0)) * xs[2]
        return y

    return fn


def _mk_batchnorm(node):
    eps = float(node.attrs.get("epsilon", 1e-5))

    def fn(xs, training, rng):
        x, gamma, beta, mean, var = xs[:5]
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return ((x - mean.reshape(shape))
                / torch.sqrt(var.reshape(shape) + eps)
                * gamma.reshape(shape) + beta.reshape(shape))

    return fn


def _axis_attr(node, default=1):
    return int(node.attrs.get("axis", default))


def _mk_elementwise(f):
    return lambda node: (lambda xs, training, rng: f(*xs))


def _mk_reduce(red):
    def make(node):
        axes = node.attrs.get("axes")
        keep = bool(int(node.attrs.get("keepdims", 1)))

        @_reads_host(1)
        def fn(xs, training, rng):
            ax = tuple(axes) if axes else None
            if ax is None and len(xs) > 1 and xs[1] is not None:
                # opset>=13 passes axes as a (constant) second input
                ax = tuple(_ints(xs[1]))
            x = xs[0]
            if ax is None:
                ax = tuple(range(x.ndim))
            return red(x, dim=ax, keepdim=keep)

        return fn

    return make


def _mk_dropout(node):
    ratio = float(node.attrs.get("ratio", 0.5))

    def fn(xs, training, rng):
        x = xs[0]
        if not training or rng is None or ratio <= 0:
            return x
        keep = torch.rand(x.shape, generator=rng, device=x.device) \
            < 1.0 - ratio
        return torch.where(keep, x / (1.0 - ratio), torch.zeros_like(x))

    return fn


def _broadcast_extreme(op):
    def f(*xs):
        out = xs[0]
        for x in xs[1:]:
            out = op(out, x)
        return out
    return f


_MAPPERS: Dict[str, Callable] = {
    "Conv": _mk_conv,
    "MaxPool": lambda n: _mk_pool(n, "max"),
    "AveragePool": lambda n: _mk_pool(n, "avg"),
    "GlobalMaxPool": lambda n: _mk_pool(n, "gmax"),
    "GlobalAveragePool": lambda n: _mk_pool(n, "gavg"),
    "Gemm": _mk_gemm,
    "BatchNormalization": _mk_batchnorm,
    "Dropout": _mk_dropout,
    "MatMul": _mk_elementwise(torch.matmul),
    "Add": _mk_elementwise(torch.add),
    "Sub": _mk_elementwise(torch.sub),
    "Mul": _mk_elementwise(torch.mul),
    "Div": _mk_elementwise(torch.true_divide),
    "Pow": _mk_elementwise(torch.pow),
    "Neg": _mk_elementwise(torch.neg),
    "Abs": _mk_elementwise(torch.abs),
    "Exp": _mk_elementwise(torch.exp),
    "Log": _mk_elementwise(torch.log),
    "Sqrt": _mk_elementwise(torch.sqrt),
    "Relu": _mk_elementwise(torch.relu),
    "Sigmoid": _mk_elementwise(torch.sigmoid),
    "Tanh": _mk_elementwise(torch.tanh),
    # jax.nn.softplus is logaddexp(x, 0): no linear threshold
    "Softplus": _mk_elementwise(lambda x: torch.logaddexp(
        x, torch.zeros_like(x))),
    "Identity": _mk_elementwise(lambda x: x),
    "Sum": _mk_elementwise(lambda *xs: sum(xs[1:], xs[0])),
    "Max": _mk_elementwise(_broadcast_extreme(torch.maximum)),
    "Min": _mk_elementwise(_broadcast_extreme(torch.minimum)),
    "Erf": _mk_elementwise(torch.erf),
    "Reciprocal": _mk_elementwise(lambda x: 1.0 / x),
    "Floor": _mk_elementwise(torch.floor),
    "Ceil": _mk_elementwise(torch.ceil),
}


def _slice_dim(x, axis, start, end, step):
    """``x`` sliced along ``axis`` as Python slicing does, negative steps
    included (torch slicing takes positive steps only)."""
    n = x.shape[axis]
    start, end, step = slice(start, end, step).indices(n)
    count = len(range(start, end, step))
    if step > 0:
        return x.narrow(axis, start, 0) if count == 0 else \
            x.narrow(axis, start, (count - 1) * step + 1)[
                (slice(None),) * axis + (slice(None, None, step),)]
    flipped = x.flip(axis)
    first = n - 1 - start
    if count == 0:
        return flipped.narrow(axis, 0, 0)
    return flipped.narrow(axis, first, (count - 1) * -step + 1)[
        (slice(None),) * axis + (slice(None, None, -step),)]


def _pad_index(n, lo, hi, mode, device):
    """Source indices of an edge or reflect pad of one dim (numpy's rule)."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge" or n == 1:
        return i.clamp(0, n - 1)
    period = 2 * (n - 1)
    j = torch.remainder(i, period)
    return torch.where(j >= n, period - j, j)


_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.float16): torch.float16,
                 # without x64 the JAX package holds f64 as f32
                 np.dtype(np.float64): torch.float32,
                 np.dtype(np.uint8): torch.uint8,
                 np.dtype(np.int8): torch.int8,
                 np.dtype(np.int16): torch.int16,
                 np.dtype(np.int32): torch.int32,
                 np.dtype(np.int64): torch.int64,
                 np.dtype(np.bool_): torch.bool,
                 np.dtype(np.uint32): torch.int64,
                 np.dtype(np.uint64): torch.int64}


def _register_structured():
    def softmax(node):
        ax = _axis_attr(node, -1)
        return lambda xs, t, r: torch.softmax(xs[0], dim=ax)

    def logsoftmax(node):
        ax = _axis_attr(node, -1)
        return lambda xs, t, r: torch.log_softmax(xs[0], dim=ax)

    def leaky(node):
        alpha = float(node.attrs.get("alpha", 0.01))
        return lambda xs, t, r: F.leaky_relu(xs[0], alpha)

    def elu(node):
        alpha = float(node.attrs.get("alpha", 1.0))
        return lambda xs, t, r: F.elu(xs[0], alpha)

    def hard_sigmoid(node):
        alpha = float(node.attrs.get("alpha", 0.2))
        beta = float(node.attrs.get("beta", 0.5))
        return lambda xs, t, r: torch.clamp(alpha * xs[0] + beta, 0.0, 1.0)

    def prelu(node):
        return lambda xs, t, r: torch.where(xs[0] >= 0, xs[0],
                                            xs[1] * xs[0])

    def clip(node):
        lo = node.attrs.get("min")
        hi = node.attrs.get("max")

        @_reads_host(1, 2)
        def fn(xs, t, r):
            # omitted optional inputs arrive as None placeholders, so
            # min/max keep their positions
            low = _scalar(xs[1]) if len(xs) > 1 and xs[1] is not None \
                else lo
            high = _scalar(xs[2]) if len(xs) > 2 and xs[2] is not None \
                else hi
            x = xs[0]
            if isinstance(low, torch.Tensor):
                x = torch.maximum(x, low.to(x.dtype))
            elif low is not None:
                x = x.clamp(min=low)
            if isinstance(high, torch.Tensor):
                x = torch.minimum(x, high.to(x.dtype))
            elif high is not None:
                x = x.clamp(max=high)
            return x

        return fn

    def flatten(node):
        ax = _axis_attr(node, 1)
        return lambda xs, t, r: xs[0].reshape(
            (int(np.prod(xs[0].shape[:ax])) if ax else 1, -1))

    def reshape(node):
        @_reads_host(1)
        def fn(xs, t, r):
            shape = _ints(xs[1])
            shape = tuple(xs[0].shape[i] if s == 0 else s
                          for i, s in enumerate(shape))
            return xs[0].reshape(shape)

        return fn

    def transpose(node):
        perm = node.attrs.get("perm")

        def fn(xs, t, r):
            p = tuple(perm) if perm else tuple(reversed(range(xs[0].ndim)))
            return xs[0].permute(p)

        return fn

    def concat(node):
        ax = _axis_attr(node)
        return lambda xs, t, r: torch.cat(xs, dim=ax)

    def squeeze(node):
        axes = node.attrs.get("axes")

        @_reads_host(1)
        def fn(xs, t, r):
            ax = axes if axes is not None else (
                _ints(xs[1]) if len(xs) > 1 and xs[1] is not None else None)
            if not ax:
                return xs[0].squeeze()
            return xs[0].squeeze(tuple(int(a) for a in ax))

        return fn

    def unsqueeze(node):
        axes = node.attrs.get("axes")

        @_reads_host(1)
        def fn(xs, t, r):
            ax = axes if axes is not None else _ints(xs[1])
            y = xs[0]
            for a in sorted(int(v) for v in ax):
                y = y.unsqueeze(a)
            return y

        return fn

    def gather(node):
        ax = _axis_attr(node, 0)

        @_reads_host(1, scalars_only=True)
        def fn(xs, t, r):
            data, idx = xs[0], xs[1]
            axis = ax % data.ndim
            n = data.shape[axis]
            if is_host(idx):                # a host scalar index: a view
                return data.select(axis, int(idx) % n)
            idx = idx.long()
            idx = torch.where(idx < 0, idx + n, idx)
            flat = torch.index_select(data, axis, idx.reshape(-1))
            return flat.reshape(tuple(data.shape[:axis]) + tuple(idx.shape)
                                + tuple(data.shape[axis + 1:]))

        return fn

    def constant(node):
        t = node.attrs.get("value")
        arr = _host_array(t.array if isinstance(t, proto.Tensor) else t)
        return lambda xs, tr, r: arr

    def pad(node):
        mode = node.attrs.get("mode", b"constant")
        if isinstance(mode, bytes):
            mode = mode.decode()
        pads_attr = node.attrs.get("pads")

        @_reads_host(1, 2)
        def fn(xs, t, r):
            x = xs[0]
            pads = pads_attr if pads_attr is not None else _ints(xs[1])
            n = x.ndim
            widths = [(int(pads[i]), int(pads[i + n])) for i in range(n)]
            if mode == "constant":
                value = (float(_scalar(xs[2]))
                         if len(xs) > 2 and xs[2] is not None else 0.0)
                flat = []
                for a, b in reversed(widths):
                    flat += [a, b]
                return F.pad(x, flat, value=value)
            kind = "edge" if mode == "edge" else "reflect"
            for d, (a, b) in enumerate(widths):
                if a or b:
                    x = torch.index_select(
                        x, d, _pad_index(x.shape[d], a, b, kind, x.device))
            return x

        return fn

    def lrn(node):
        alpha = float(node.attrs.get("alpha", 1e-4))
        beta = float(node.attrs.get("beta", 0.75))
        bias = float(node.attrs.get("bias", 1.0))
        size = int(node.attrs["size"])

        def fn(xs, t, r):
            x = xs[0]
            sq = x * x
            half = size // 2
            c = x.shape[1]
            pad = [0, 0] * (x.ndim - 2) + [half, size - 1 - half]
            sqp = F.pad(sq, pad)
            acc = sqp.narrow(1, 0, c)
            for j in range(1, size):
                acc = acc + sqp.narrow(1, j, c)
            return x / torch.pow(bias + alpha / size * acc, beta)

        return fn

    def cast(node):
        to = int(node.attrs["to"])
        dtype = _TORCH_DTYPES[np.dtype(proto._DTYPES.get(to, np.float32))]
        return lambda xs, t, r: xs[0].to(dtype)

    @_reads_host(0)
    def _shape(xs, t, r):
        return np.asarray(tuple(xs[0].shape), np.int64)

    def shape_op(node):
        return _shape

    def slice_op(node):
        # opset-10+ takes starts/ends/axes/steps as inputs; opset-1 as
        # attrs.  All are host values (constants or Shape chains).
        a_starts = node.attrs.get("starts")
        a_ends = node.attrs.get("ends")
        a_axes = node.attrs.get("axes")

        @_reads_host(1, 2, 3, 4)
        def fn(xs, t, r):
            x = xs[0]
            starts = a_starts if a_starts is not None else _ints(xs[1])
            ends = a_ends if a_ends is not None else _ints(xs[2])
            axes = a_axes
            if axes is None and len(xs) > 3 and xs[3] is not None:
                axes = _ints(xs[3])
            if axes is None:
                axes = list(range(len(starts)))
            steps = (_ints(xs[4]) if len(xs) > 4 and xs[4] is not None
                     else [1] * len(starts))
            for s, e, a, st in zip(starts, ends, axes, steps):
                x = _slice_dim(x, int(a) % x.ndim, int(s), int(e), int(st))
            return x

        return fn

    def split_op(node):
        ax = _axis_attr(node, 0)
        a_split = node.attrs.get("split")

        @_reads_host(1)
        def fn(xs, t, r):
            x = xs[0]
            sizes = (a_split if a_split is not None
                     else (_ints(xs[1])
                           if len(xs) > 1 and xs[1] is not None else None))
            if sizes is None:
                n = len(node.outputs)
                if x.shape[ax] % n:
                    raise ValueError(f"Split: dim {x.shape[ax]} does not "
                                     f"divide into {n} equal parts")
                return tuple(torch.split(x, x.shape[ax] // n, dim=ax))
            return tuple(torch.split(x, [int(s) for s in sizes], dim=ax))

        return fn

    def expand(node):
        @_reads_host(1)
        def fn(xs, t, r):
            shape = tuple(_ints(xs[1]))
            return torch.broadcast_to(
                xs[0], np.broadcast_shapes(tuple(xs[0].shape), shape))

        return fn

    def where(node):
        return lambda xs, t, r: torch.where(xs[0].to(torch.bool), xs[1],
                                            xs[2])

    def _mk_arg(fn):
        def build(node):
            ax = _axis_attr(node, 0)
            keep = int(node.attrs.get("keepdims", 1))

            def f(xs, t, r):
                y = fn(xs[0], dim=ax)
                return y.unsqueeze(ax) if keep else y

            return f
        return build

    def conv_transpose(node):
        strides = tuple(int(s) for s in node.attrs.get("strides", (1, 1)))
        pads = node.attrs.get("pads")
        group = int(node.attrs.get("group", 1))
        if group != 1:
            raise UnsupportedOnnxOp("ConvTranspose group != 1")
        out_pad = node.attrs.get("output_padding")
        if out_pad is not None and any(int(p) for p in out_pad):
            raise UnsupportedOnnxOp("ConvTranspose output_padding != 0")
        dil = node.attrs.get("dilations")
        if dil is not None and any(int(d) != 1 for d in dil):
            raise UnsupportedOnnxOp("ConvTranspose dilations != 1")
        if node.attrs.get("output_shape") is not None:
            raise UnsupportedOnnxOp("ConvTranspose explicit output_shape")
        ap = node.attrs.get("auto_pad", b"NOTSET")
        ap = ap.decode() if isinstance(ap, bytes) else ap
        if ap not in ("NOTSET", ""):
            raise UnsupportedOnnxOp(f"ConvTranspose auto_pad={ap}")

        def fn(xs, t, r):
            x, w = xs[0], xs[1]          # x NCHW, w (Cin, Cout, kH, kW)
            nd = x.ndim - 2
            st = strides if len(strides) == nd else (1,) * nd
            conv_t = F.conv_transpose1d if nd == 1 else F.conv_transpose2d
            bias = xs[2] if len(xs) > 2 else None
            y = conv_t(x, w, bias, st)
            # ONNX deconvolution pads remove output at each end
            for i, (a, b) in enumerate(_pads_to_pairs(pads or [], nd)):
                if a or b:
                    y = y.narrow(2 + i, a, y.shape[2 + i] - a - b)
            return y

        return fn

    _MAPPERS.update({
        "Softmax": softmax, "LogSoftmax": logsoftmax,
        "LeakyRelu": leaky, "Elu": elu, "HardSigmoid": hard_sigmoid,
        "PRelu": prelu, "Clip": clip, "Flatten": flatten,
        "Reshape": reshape, "Transpose": transpose, "Concat": concat,
        "Squeeze": squeeze, "Unsqueeze": unsqueeze, "Gather": gather,
        "Constant": constant, "Pad": pad, "LRN": lrn, "Cast": cast,
        "Shape": shape_op,
        "ReduceMean": _mk_reduce(torch.mean),
        "ReduceSum": _mk_reduce(torch.sum),
        "ReduceMax": _mk_reduce(torch.amax),
        "ReduceMin": _mk_reduce(torch.amin),
        "Slice": slice_op, "Split": split_op, "Expand": expand,
        "Where": where, "ArgMax": _mk_arg(torch.argmax),
        "ArgMin": _mk_arg(torch.argmin), "ConvTranspose": conv_transpose,
    })


_register_structured()


def _resolve_inputs(env: Dict[str, Any], names: Sequence[str]) -> List:
    """Resolve a node's inputs: trailing omitted optionals ("") are
    dropped, interior ones become None PLACEHOLDERS so later inputs keep
    their spec positions (e.g. Clip with min omitted but max given)."""
    names = list(names)
    while names and not names[-1]:
        names.pop()
    return [env[i] if i else None for i in names]


def _to_host(out):
    """A folded node's result back on the host."""
    if isinstance(out, (tuple, list)):
        return type(out)(_to_host(o) for o in out)
    if isinstance(out, torch.Tensor):
        return out.numpy()
    return out


class OnnxProgram:
    """Topologically ordered op list over a name-keyed tensor env.

    Follows the FunctionModel program protocol (``tfpark/model.py``):
    ``params`` / ``state`` and ``call(params, state, *inputs)``, so the
    loaded graph trains and predicts under the Estimator.  The float
    initializers are the params (a flat ``{tensor_name: array}`` of numpy
    arrays; ``FunctionModel`` holds them as parameters); the others are
    host constants.
    """

    def __init__(self, model: proto.Model):
        g = model.graph
        self.opset = model.opset
        self.params = {t.name: _host_array(t.array)
                       for t in g.initializers
                       if np.issubdtype(t.array.dtype, np.floating)}
        self.consts = {t.name: _host_array(t.array)
                       for t in g.initializers
                       if not np.issubdtype(t.array.dtype, np.floating)}
        self.state: Dict = {}
        init_names = set(self.params) | set(self.consts)
        self.input_names = [vi.name for vi in g.inputs
                            if vi.name not in init_names]
        self.output_names = [vi.name for vi in g.outputs]
        self.nodes = []
        for n in g.nodes:
            if n.op_type not in _MAPPERS:
                raise UnsupportedOnnxOp(
                    f"ONNX op {n.op_type!r} (supported: "
                    f"{sorted(_MAPPERS)})")
            self.nodes.append((n, _MAPPERS[n.op_type](n)))
        self.has_dropout = any(n.op_type == "Dropout" for n, _ in self.nodes)
        self._device_values: Dict[tuple, tuple] = {}

    def device_value(self, arr, device: torch.device) -> torch.Tensor:
        """Host value ``arr`` as a tensor on ``device``, copied once:
        small values are keyed by content (a Shape chain recomputes them
        every call), large ones by identity (constants)."""
        a = _host_array(arr)
        if a.size <= 4096:
            key = ("v", a.dtype.str, a.shape, a.tobytes(), str(device))
        else:
            key = ("id", id(arr), str(device))
        hit = self._device_values.get(key)
        if hit is not None and (key[0] == "v" or hit[0] is arr):
            return hit[1]
        t = torch.from_numpy(np.array(a)).to(device)
        self._device_values[key] = (arr, t)
        return t

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_device_values"] = {}
        return state

    def run_node(self, n, fn, xs, training=False, rng=None):
        """One node on its resolved inputs: on the host when every input
        is a host value, else on the device of its first tensor input,
        host inputs copied there but for the positions it reads on the
        host."""
        given = [x for x in xs if x is not None]
        if given and all(is_host(x) for x in given):
            cpu = [None if x is None else torch.from_numpy(_host_array(x))
                   for x in xs]
            with torch.no_grad():
                return _to_host(fn(cpu, training, rng))
        dev = next((x.device for x in given if isinstance(x, torch.Tensor)),
                   None)
        keep = getattr(fn, "host_inputs", frozenset())
        scalars = getattr(fn, "host_scalars_only", False)
        if dev is not None:
            xs = [self.device_value(x, dev)
                  if is_host(x) and not (i in keep and (
                      not scalars or np.ndim(x) == 0)) else x
                  for i, x in enumerate(xs)]
        return fn(xs, training, rng)

    def run_nodes(self, env: Dict[str, Any], training=False, rng=None,
                  hook=None) -> Dict[str, Any]:
        """Run every node in order over ``env`` (value by name), binding
        each node's outputs there; returns ``env``.  ``hook(index, node,
        env)``, where given, sees each node first and may return its value
        in its place (None: the node runs as the graph says) — the one
        loop behind ``call``, the quantized program's call and the
        calibration pass."""
        for idx, (n, fn) in enumerate(self.nodes):
            out = None if hook is None else hook(idx, n, env)
            if out is None:
                out = self.run_node(n, fn, _resolve_inputs(env, n.inputs),
                                    training, rng)
            if isinstance(out, tuple) and len(n.outputs) == len(out):
                # true multi-output op (Split): one value per output —
                # including the degenerate single-output Split, whose
                # length-1 tuple must unwrap to the array
                for name, val in zip(n.outputs, out):
                    if name:
                        env[name] = val
            else:
                env[n.outputs[0]] = out
                for extra in n.outputs[1:]:
                    if extra:        # e.g. Dropout mask output — unused
                        env[extra] = out
        return env

    def call(self, params, state, *inputs, training=False, rng=None):
        """Run the graph: ``params`` a ``{name: tensor or array}`` dict,
        ``inputs`` tensors (or numpy arrays, which run on the host),
        ``rng`` the dropout ``torch.Generator``.  Returns ``(output or
        list of outputs, state)``."""
        if len(inputs) != len(self.input_names):
            raise ValueError(f"expected {len(self.input_names)} inputs "
                             f"({self.input_names}), got {len(inputs)}")
        env: Dict[str, Any] = dict(self.consts)
        env.update(params)
        env.update(zip(self.input_names, inputs))
        env = self.run_nodes(env, training, rng)
        outs = [env[o] for o in self.output_names]
        return (outs[0] if len(outs) == 1 else outs), state


def load_onnx_bytes(buf: bytes) -> OnnxProgram:
    return OnnxProgram(proto.decode_model(buf))


def load_onnx(path: str) -> OnnxProgram:
    """Load a ``.onnx`` file into a trainable/predictable program."""
    with open(path, "rb") as f:
        return load_onnx_bytes(f.read())


def to_model(program: OnnxProgram):
    """Wrap as a KerasNet (compile/fit/evaluate/predict surface)."""
    from analytics_zoo_tpu_torch.tfpark.model import FunctionModel

    return FunctionModel(program)
