"""Minimal Caffe importer: prototxt + caffemodel → a trainable program
(the JAX package's ``caffe/loader.py``; its translation is numpy and is
copied).

Reference capability: the Scala Caffe importer
(zoo/src/main/scala/com/intel/analytics/zoo/models/caffe/CaffeLoader.scala:718
plus Converter.scala/LayerConverter.scala/V1LayerConverter.scala, ~2.9k LoC)
loading prototxt+caffemodel into BigDL graphs via protobuf.

No ``caffe`` / protobuf dependency — the caffemodel's NetParameter wire
format is decoded with the same hand-rolled protobuf reader the ONNX
importer uses (onnx/proto.py), the prototxt with a ~60 line text-format
parser, and the network is *translated into the ONNX node vocabulary* and
executed by the port's ``OnnxProgram`` (torch ops on the device; trains
under the Estimator via ``to_model``).  Layout stays NCHW like the ONNX
path.

Scope (the reference's core conv-net vocabulary): Input, Convolution,
Pooling (MAX/AVE/global, with Caffe's ceil-mode output sizes restored
via computed extra padding), InnerProduct, ReLU, Sigmoid, TanH, Softmax
(+SoftmaxWithLoss as inference softmax), Dropout, LRN, BatchNorm, Scale,
Concat, Eltwise (SUM/PROD/MAX), Flatten, Split; train-only layers
(Data/Accuracy/losses) are skipped.  Anything else raises
``UnsupportedCaffeLayer`` loudly with caffe2onnx guidance (the
reference's exotic-layer surface is legacy).

Known approximation: Caffe AVE pooling over a ceil-mode tail divides by
the in-bounds+pad window it actually covered; the translation divides by
the full kernel area (count_include_pad).  Nets whose spatial dims tile
evenly (the common case) are exact.
"""

from __future__ import annotations

import re
import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from analytics_zoo_tpu_torch.onnx import proto
from analytics_zoo_tpu_torch.onnx.loader import OnnxProgram
from analytics_zoo_tpu_torch.onnx.proto import _fields, _read_varint


class UnsupportedCaffeLayer(ValueError):
    def __init__(self, layer_type: str, name: str = ""):
        super().__init__(
            f"Caffe layer type {layer_type!r}" +
            (f" (layer {name!r})" if name else "") +
            " is outside the minimal importer's conv-net vocabulary "
            "(Convolution/Pooling/InnerProduct/BatchNorm/Scale/ReLU/"
            "Sigmoid/TanH/Softmax/Dropout/LRN/Concat/Eltwise/Flatten); "
            "convert the model with caffe2onnx and use "
            "onnx.load_onnx instead")


# ---------------------------------------------------------------------------
# prototxt (protobuf text format) parser
# ---------------------------------------------------------------------------

_TOKEN = re.compile(r"""
    \s*(?:\#[^\n]*\s*)*            # whitespace / comments
    (?P<tok>
        [A-Za-z_][A-Za-z0-9_]* |   # identifier
        "(?:[^"\\]|\\.)*"      |   # quoted string
        '(?:[^'\\]|\\.)*'      |
        [-+]?[0-9.eE+-]+       |   # number
        [{}:]                      # punctuation
    )""", re.VERBOSE)


def _tokenize(text: str) -> List[str]:
    toks, pos = [], 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None:
            rest = text[pos:].strip()
            if not rest:
                break
            raise ValueError(f"prototxt parse error near: {rest[:40]!r}")
        toks.append(m.group("tok"))
        pos = m.end()
    return toks


def _coerce(tok: str) -> Any:
    if tok[0] in "\"'":
        return tok[1:-1]
    if tok in ("true", "True"):
        return True
    if tok in ("false", "False"):
        return False
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        return tok        # bare enum (MAX, AVE, SUM ...)


def parse_prototxt(text: str) -> Dict[str, List[Any]]:
    """Protobuf text format → nested dict; every key maps to a LIST
    (repeated fields are first-class in caffe prototxts)."""
    toks = _tokenize(text)
    pos = 0

    def message() -> Dict[str, List[Any]]:
        nonlocal pos
        out: Dict[str, List[Any]] = {}
        while pos < len(toks) and toks[pos] != "}":
            key = toks[pos]
            pos += 1
            if pos < len(toks) and toks[pos] == ":":
                pos += 1
                val = _coerce(toks[pos])
                pos += 1
            elif pos < len(toks) and toks[pos] == "{":
                pos += 1
                val = message()
                if toks[pos] != "}":
                    raise ValueError("prototxt: unbalanced braces")
                pos += 1
            else:
                raise ValueError(f"prototxt: expected ':' or '{{' after "
                                 f"{key!r}")
            out.setdefault(key, []).append(val)
        return out

    msg = message()
    if pos != len(toks):
        raise ValueError("prototxt: trailing tokens")
    return msg


def _one(d: Dict[str, List[Any]], key: str, default=None):
    v = d.get(key)
    return v[0] if v else default


def _many(d: Dict[str, List[Any]], key: str) -> List[Any]:
    return list(d.get(key, []))


# ---------------------------------------------------------------------------
# caffemodel (NetParameter wire format) → {layer_name: [blob arrays]}
# ---------------------------------------------------------------------------

def _decode_blob(buf: bytes) -> np.ndarray:
    dims: List[int] = []
    legacy = [0, 0, 0, 0]          # num, channels, height, width
    floats: List[float] = []
    raw: List[bytes] = []
    for fnum, wtype, val in _fields(buf):
        if fnum == 7 and wtype == 2:          # shape: BlobShape{dim=1}
            for f2, w2, v2 in _fields(val):
                if f2 == 1:
                    if w2 == 2:               # packed varints
                        p = 0
                        while p < len(val if False else v2):
                            d, p = _read_varint(v2, p)
                            dims.append(d)
                    else:
                        dims.append(v2)
        elif fnum == 5:                        # data: repeated float
            if wtype == 2:                     # packed
                raw.append(val)
            else:                              # unpacked single
                floats.append(struct.unpack("<f", val)[0])
        elif fnum in (1, 2, 3, 4) and wtype == 0:
            legacy[fnum - 1] = val
    if raw:
        buf_all = b"".join(raw)
        arr = np.frombuffer(buf_all, dtype="<f4").astype(np.float32)
    else:
        arr = np.asarray(floats, np.float32)
    if not dims and any(legacy):
        dims = [d for d in legacy]
        # legacy blobs are always logically 4D; squeeze leading ones later
    if dims and int(np.prod(dims)) == arr.size:
        arr = arr.reshape(dims)
    return arr


def decode_caffemodel(buf: bytes) -> Dict[str, List[np.ndarray]]:
    """NetParameter → layer name → blobs.  Handles both the V2 ``layer``
    (field 100) and V1 ``layers`` (field 2) encodings (the reference
    ships both converters — LayerConverter/V1LayerConverter.scala)."""
    out: Dict[str, List[np.ndarray]] = {}
    for fnum, wtype, val in _fields(buf):
        if fnum == 100 and wtype == 2:        # V2 LayerParameter
            name, blobs = "", []
            for f2, w2, v2 in _fields(val):
                if f2 == 1:
                    name = v2.decode()
                elif f2 == 7:
                    blobs.append(_decode_blob(v2))
            if name and blobs:
                out[name] = blobs
        elif fnum == 2 and wtype == 2:        # V1LayerParameter
            name, blobs = "", []
            for f2, w2, v2 in _fields(val):
                if f2 == 4 and w2 == 2:
                    name = v2.decode()
                elif f2 == 6 and w2 == 2:
                    blobs.append(_decode_blob(v2))
            if name and blobs:
                out[name] = blobs
    return out


# ---------------------------------------------------------------------------
# translation to the ONNX vocabulary
# ---------------------------------------------------------------------------

# V1 enum type name → V2 string type
_V1_TYPES = {
    "CONVOLUTION": "Convolution", "POOLING": "Pooling",
    "INNER_PRODUCT": "InnerProduct", "RELU": "ReLU", "SIGMOID": "Sigmoid",
    "TANH": "TanH", "SOFTMAX": "Softmax", "SOFTMAX_LOSS": "SoftmaxWithLoss",
    "LRN": "LRN", "DROPOUT": "Dropout", "CONCAT": "Concat",
    "ELTWISE": "Eltwise", "FLATTEN": "Flatten", "SPLIT": "Split",
    "DATA": "Data", "ACCURACY": "Accuracy",
    "POWER": "Power", "ABSVAL": "AbsVal", "BNLL": "BNLL", "EXP": "Exp",
    "DECONVOLUTION": "Deconvolution", "SLICE": "Slice",
    "INNERPRODUCT": "InnerProduct",
}

_SKIP_TYPES = {"Data", "ImageData", "HDF5Data", "DummyData", "MemoryData",
               "Accuracy", "Silence", "EuclideanLoss", "HingeLoss",
               "SigmoidCrossEntropyLoss", "ContrastiveLoss",
               "InfogainLoss", "MultinomialLogisticLoss"}


def _pair(param, base: str, default: int) -> Tuple[int, int]:
    """Caffe's spatial params: repeated ``base`` or ``base_h``/``base_w``."""
    h = _one(param, f"{base}_h")
    w = _one(param, f"{base}_w")
    if h is not None or w is not None:
        return int(h or default), int(w or default)
    vals = _many(param, base)
    if not vals:
        return default, default
    if len(vals) == 1:
        return int(vals[0]), int(vals[0])
    return int(vals[0]), int(vals[1])


def _conv_out(h: int, k: int, p: int, s: int, d: int = 1) -> int:
    return (h + 2 * p - d * (k - 1) - 1) // s + 1


def _pool_out_caffe(h: int, k: int, p: int, s: int) -> int:
    out = -(-(h + 2 * p - k) // s) + 1       # ceil
    if p > 0 and (out - 1) * s >= h + p:     # caffe's clip rule
        out -= 1
    return out


class _Translator:
    """Builds the ONNX graph while tracking NCHW shapes (needed to
    restore Caffe's ceil-mode pooling sizes and to place Flatten before
    InnerProduct)."""

    def __init__(self, weights: Dict[str, List[np.ndarray]]):
        self.weights = weights
        self.nodes: List[proto.Node] = []
        self.inits: List[proto.Tensor] = []
        self.shapes: Dict[str, Tuple[int, ...]] = {}
        self._uid = 0

    def uid(self, base: str) -> str:
        self._uid += 1
        return f"{base}__{self._uid}"

    def add_init(self, name: str, arr: np.ndarray) -> str:
        self.inits.append(proto.Tensor(
            name=name, dims=tuple(arr.shape),
            data_type=proto._DTYPE_IDS[np.dtype(arr.dtype)], array=arr))
        return name

    def node(self, op: str, name: str, inputs: Sequence[str],
             outputs: Sequence[str], **attrs):
        self.nodes.append(proto.Node(op_type=op, name=name,
                                     inputs=list(inputs),
                                     outputs=list(outputs),
                                     attrs=dict(attrs)))

    # -- per-layer handlers ------------------------------------------------
    def convolution(self, name, param, bottom, top):
        blobs = self.weights.get(name)
        if not blobs:
            raise ValueError(f"conv layer {name!r} has no weights in the "
                             "caffemodel")
        w = blobs[0]
        if w.ndim != 4:
            w = w.reshape(w.shape[-4:]) if w.size else w
        kh, kw = _pair(param, "kernel_size", 0)
        if kh == 0:
            kh, kw = w.shape[2], w.shape[3]
        ph, pw = _pair(param, "pad", 0)
        sh, sw = _pair(param, "stride", 1)
        dil = int(_one(param, "dilation", 1))
        group = int(_one(param, "group", 1))
        ins = [bottom, self.add_init(f"{name}_W", w.astype(np.float32))]
        bias_term = _one(param, "bias_term", True)
        if bias_term and len(blobs) > 1:
            ins.append(self.add_init(f"{name}_b",
                                     blobs[1].reshape(-1).astype(np.float32)))
        self.node("Conv", name, ins, [top],
                  kernel_shape=[kh, kw], strides=[sh, sw],
                  pads=[ph, pw, ph, pw], dilations=[dil, dil], group=group)
        b, c, h, wd = self.shapes[bottom]
        self.shapes[top] = (b, w.shape[0],
                            _conv_out(h, kh, ph, sh, dil),
                            _conv_out(wd, kw, pw, sw, dil))

    def pooling(self, name, param, bottom, top):
        mode = str(_one(param, "pool", "MAX")).upper()
        if mode not in ("MAX", "AVE", "0", "1"):
            raise UnsupportedCaffeLayer(f"Pooling pool={mode}", name)
        is_max = mode in ("MAX", "0")
        if _one(param, "global_pooling", False):
            self.node("GlobalMaxPool" if is_max else "GlobalAveragePool",
                      name, [bottom], [top])
            b, c = self.shapes[bottom][:2]
            self.shapes[top] = (b, c, 1, 1)
            return
        kh, kw = _pair(param, "kernel_size", 0)
        ph, pw = _pair(param, "pad", 0)
        sh, sw = _pair(param, "stride", 1)
        b, c, h, w = self.shapes[bottom]
        oh = _pool_out_caffe(h, kh, ph, sh)
        ow = _pool_out_caffe(w, kw, pw, sw)
        # restore Caffe's ceil-mode output under floor-mode windows by
        # extending the END padding to exactly cover the tail windows
        eh = max(0, (oh - 1) * sh + kh - h - 2 * ph)
        ew = max(0, (ow - 1) * sw + kw - w - 2 * pw)
        self.node("MaxPool" if is_max else "AveragePool", name,
                  [bottom], [top], kernel_shape=[kh, kw],
                  strides=[sh, sw], pads=[ph, pw, ph + eh, pw + ew],
                  count_include_pad=1)
        self.shapes[top] = (b, c, oh, ow)

    def inner_product(self, name, param, bottom, top):
        blobs = self.weights.get(name)
        if not blobs:
            raise ValueError(f"ip layer {name!r} has no weights in the "
                             "caffemodel")
        w = blobs[0]
        w = w.reshape(w.shape[-2:]) if w.ndim > 2 else w     # (out, in)
        src = bottom
        shape = self.shapes[bottom]
        if len(shape) > 2:
            flat = self.uid(f"{name}_flat")
            self.node("Flatten", f"{name}_flatten", [bottom], [flat],
                      axis=1)
            src = flat
            shape = (shape[0], int(np.prod(shape[1:])))
        ins = [src, self.add_init(f"{name}_W", w.astype(np.float32))]
        if len(blobs) > 1 and _one(param, "bias_term", True):
            ins.append(self.add_init(f"{name}_b",
                                     blobs[1].reshape(-1).astype(np.float32)))
        self.node("Gemm", name, ins, [top], transB=1)
        self.shapes[top] = (shape[0], w.shape[0])

    def batch_norm(self, name, param, bottom, top):
        blobs = self.weights.get(name, [])
        if len(blobs) < 2:
            raise ValueError(f"BatchNorm layer {name!r} needs mean/var "
                             "blobs in the caffemodel")
        mean, var = blobs[0].reshape(-1), blobs[1].reshape(-1)
        if len(blobs) > 2 and blobs[2].size:
            sf = float(blobs[2].reshape(-1)[0])
            if sf != 0:
                mean = mean / sf
                var = var / sf
        c = mean.shape[0]
        eps = float(_one(param, "eps", 1e-5))
        ins = [bottom,
               self.add_init(f"{name}_scale", np.ones(c, np.float32)),
               self.add_init(f"{name}_bias", np.zeros(c, np.float32)),
               self.add_init(f"{name}_mean", mean.astype(np.float32)),
               self.add_init(f"{name}_var", var.astype(np.float32))]
        self.node("BatchNormalization", name, ins, [top], epsilon=eps)
        self.shapes[top] = self.shapes[bottom]

    def scale(self, name, param, bottom, top):
        blobs = self.weights.get(name, [])
        if not blobs:
            raise ValueError(f"Scale layer {name!r} has no blobs")
        shape = self.shapes[bottom]
        c = blobs[0].size
        bshape = (1, c) + (1,) * (len(shape) - 2)
        gamma = self.add_init(f"{name}_gamma",
                              blobs[0].reshape(bshape).astype(np.float32))
        mul_out = top if not (_one(param, "bias_term", False)
                              or len(blobs) > 1) else self.uid(name)
        self.node("Mul", name, [bottom, gamma], [mul_out])
        if mul_out != top:
            beta = self.add_init(f"{name}_beta",
                                 blobs[1].reshape(bshape).astype(np.float32))
            self.node("Add", f"{name}_bias", [mul_out, beta], [top])
        self.shapes[top] = shape

    def eltwise(self, name, param, bottoms, top):
        op = str(_one(param, "operation", "SUM")).upper()
        coeffs = [float(c) for c in _many(param, "coeff")]
        onnx_op = {"SUM": "Sum", "1": "Sum", "PROD": "Mul", "0": "Mul",
                   "MAX": "Max", "2": "Max"}.get(op)
        if onnx_op is None:
            raise UnsupportedCaffeLayer(f"Eltwise operation={op}", name)
        ins = list(bottoms)
        if coeffs and any(c != 1.0 for c in coeffs):
            if onnx_op != "Sum":
                raise UnsupportedCaffeLayer(
                    f"Eltwise coeff with operation={op}", name)
            if len(coeffs) != len(ins):     # caffe rejects this too
                raise UnsupportedCaffeLayer(
                    f"Eltwise: {len(coeffs)} coeffs for {len(ins)} "
                    "bottoms", name)
            scaled = []
            for k, (b, c) in enumerate(zip(ins, coeffs)):
                cn = self.add_init(f"{name}_coeff{k}",
                                   np.asarray(c, np.float32))
                out = self.uid(name)
                self.node("Mul", f"{name}_scale{k}", [b, cn], [out])
                scaled.append(out)
            ins = scaled
        self.node(onnx_op, name, ins, [top])
        self.shapes[top] = self.shapes[bottoms[0]]

    def _affine(self, name, bottom, scale, shift):
        """Emit y = scale*x + shift (skipping identity factors); returns
        the tensor name holding the result."""
        cur = bottom
        if scale != 1.0:
            c = self.add_init(f"{name}_scale", np.asarray(scale, np.float32))
            out = self.uid(name)
            self.node("Mul", f"{name}_mul", [cur, c], [out])
            cur = out
        if shift != 0.0:
            c = self.add_init(f"{name}_shift", np.asarray(shift, np.float32))
            out = self.uid(name)
            self.node("Add", f"{name}_add", [cur, c], [out])
            cur = out
        return cur

    def power(self, name, param, bottom, top):
        """y = (shift + scale * x) ** power (caffe PowerLayer)."""
        power = float(_one(param, "power", 1.0))
        cur = self._affine(name, bottom, float(_one(param, "scale", 1.0)),
                           float(_one(param, "shift", 0.0)))
        if power != 1.0:
            c = self.add_init(f"{name}_pow", np.asarray(power, np.float32))
            self.node("Pow", name, [cur, c], [top])
        else:
            self.node("Identity", name, [cur], [top])
        self.shapes[top] = self.shapes[bottom]

    def exp_log(self, name, param, bottom, top, kind):
        """Exp: y = base^(scale*x+shift); Log: y = log_base(scale*x+shift)
        (base=-1 means e)."""
        base = float(_one(param, "base", -1.0))
        cur = self._affine(name, bottom, float(_one(param, "scale", 1.0)),
                           float(_one(param, "shift", 0.0)))
        ln_b = 1.0 if base <= 0 else float(np.log(base))
        if kind == "Exp":
            if ln_b != 1.0:
                c = self.add_init(f"{name}_lnb", np.asarray(ln_b, np.float32))
                out = self.uid(name)
                self.node("Mul", f"{name}_lnb_mul", [cur, c], [out])
                cur = out
            self.node("Exp", name, [cur], [top])
        else:
            if ln_b != 1.0:
                out = self.uid(name)
                self.node("Log", f"{name}_ln", [cur], [out])
                c = self.add_init(f"{name}_invlnb",
                                  np.asarray(1.0 / ln_b, np.float32))
                self.node("Mul", name, [out, c], [top])
            else:
                self.node("Log", name, [cur], [top])
        self.shapes[top] = self.shapes[bottom]

    def prelu(self, name, param, bottom, top):
        blobs = self.weights.get(name, [])
        if not blobs:
            raise ValueError(f"PReLU layer {name!r} has no slope blob")
        shape = self.shapes[bottom]
        slope = blobs[0].reshape(-1).astype(np.float32)
        if _one(param, "channel_shared", False) or slope.size == 1:
            sl = slope.reshape(())
        else:
            sl = slope.reshape((1, slope.size) + (1,) * (len(shape) - 2))
        s = self.add_init(f"{name}_slope", sl)
        self.node("PRelu", name, [bottom, s], [top])
        self.shapes[top] = shape

    def bias(self, name, param, bottom, top):
        """Bias layer: add a learned per-channel blob (ScaleLayer minus
        the multiply).  Only the caffe defaults (axis=1, num_axes=1 — a
        per-channel broadcast) are supported; anything else must fail
        loud rather than import a silently-wrong broadcast."""
        axis = int(_one(param, "axis", 1))
        num_axes = int(_one(param, "num_axes", 1))
        if axis != 1 or num_axes != 1:
            raise UnsupportedCaffeLayer(
                f"Bias with axis={axis} num_axes={num_axes} (only the "
                "per-channel default axis=1/num_axes=1 is supported)", name)
        blobs = self.weights.get(name, [])
        if not blobs:
            raise ValueError(f"Bias layer {name!r} has no blob")
        shape = self.shapes[bottom]
        c = blobs[0].size
        b = self.add_init(f"{name}_b", blobs[0].reshape(
            (1, c) + (1,) * (len(shape) - 2)).astype(np.float32))
        self.node("Add", name, [bottom, b], [top])
        self.shapes[top] = shape

    def reshape(self, name, param, bottom, top):
        # only the full-shape default (axis=0, num_axes=-1) is supported;
        # partial-range reshapes would import silently wrong otherwise
        axis = int(_one(param, "axis", 0))
        num_axes = int(_one(param, "num_axes", -1))
        if axis != 0 or num_axes != -1:
            raise UnsupportedCaffeLayer(
                f"Reshape with axis={axis} num_axes={num_axes} (only the "
                "whole-shape default axis=0/num_axes=-1 is supported)", name)
        dims = [int(d) for d in _many(_one(param, "shape", {}), "dim")]
        if not dims:
            raise UnsupportedCaffeLayer("Reshape without shape.dim", name)
        shp = self.add_init(f"{name}_shape", np.asarray(dims, np.int64))
        self.node("Reshape", name, [bottom, shp], [top])
        src = self.shapes[bottom]
        out = [src[i] if d == 0 else d for i, d in enumerate(dims)]
        if -1 in out:
            known = int(np.prod([d for d in out if d != -1]))
            out[out.index(-1)] = int(np.prod(src)) // max(1, known)
        self.shapes[top] = tuple(out)

    def slice(self, name, param, bottom, tops):
        axis = int(_one(param, "axis", _one(param, "slice_dim", 1)))
        points = [int(p) for p in _many(param, "slice_point")]
        src = self.shapes[bottom]
        if points:
            bounds = [0] + points + [src[axis]]
            sizes = [bounds[i + 1] - bounds[i]
                     for i in range(len(bounds) - 1)]
        else:
            n = len(tops)
            if src[axis] % n:
                raise UnsupportedCaffeLayer(
                    f"Slice: dim {src[axis]} not divisible by {n}", name)
            sizes = [src[axis] // n] * n
        if len(sizes) != len(tops):
            raise UnsupportedCaffeLayer(
                f"Slice: {len(sizes)} pieces for {len(tops)} tops", name)
        self.node("Split", name, [bottom], list(tops),
                  axis=axis, split=sizes)
        for t, s in zip(tops, sizes):
            shp = list(src)
            shp[axis] = s
            self.shapes[t] = tuple(shp)

    def deconvolution(self, name, param, bottom, top):
        blobs = self.weights.get(name)
        if not blobs:
            raise ValueError(f"deconv layer {name!r} has no weights")
        w = blobs[0]                    # caffe: (Cin, Cout, kH, kW)
        kh, kw = _pair(param, "kernel_size", 0)
        if kh == 0:
            kh, kw = w.shape[2], w.shape[3]
        ph, pw = _pair(param, "pad", 0)
        sh, sw = _pair(param, "stride", 1)
        if int(_one(param, "group", 1)) != 1:
            raise UnsupportedCaffeLayer("Deconvolution group != 1", name)
        if int(_one(param, "dilation", 1)) != 1:
            raise UnsupportedCaffeLayer("Deconvolution dilation != 1", name)
        ins = [bottom, self.add_init(f"{name}_W", w.astype(np.float32))]
        if _one(param, "bias_term", True) and len(blobs) > 1:
            ins.append(self.add_init(
                f"{name}_b", blobs[1].reshape(-1).astype(np.float32)))
        self.node("ConvTranspose", name, ins, [top],
                  kernel_shape=[kh, kw], strides=[sh, sw],
                  pads=[ph, pw, ph, pw])
        b, c, h, wd = self.shapes[bottom]
        self.shapes[top] = (b, w.shape[1],
                            (h - 1) * sh + kh - 2 * ph,
                            (wd - 1) * sw + kw - 2 * pw)

    def lrn(self, name, param, bottom, top):
        region = str(_one(param, "norm_region", "ACROSS_CHANNELS")).upper()
        if region not in ("ACROSS_CHANNELS", "0"):
            raise UnsupportedCaffeLayer("LRN WITHIN_CHANNEL", name)
        self.node("LRN", name, [bottom], [top],
                  size=int(_one(param, "local_size", 5)),
                  alpha=float(_one(param, "alpha", 1.0)),
                  beta=float(_one(param, "beta", 0.75)),
                  bias=float(_one(param, "k", 1.0)))
        self.shapes[top] = self.shapes[bottom]


def _layer_entries(net: Dict[str, List[Any]]):
    """Normalize V2 ``layer`` / V1 ``layers`` prototxt entries to
    (name, type, bottoms, tops, layer_dict)."""
    raw = _many(net, "layer") or _many(net, "layers")
    for ld in raw:
        ltype = str(_one(ld, "type", ""))
        ltype = _V1_TYPES.get(ltype, ltype)
        yield (str(_one(ld, "name", "")), ltype,
               [str(b) for b in _many(ld, "bottom")],
               [str(t) for t in _many(ld, "top")], ld)


def _graph_inputs(net) -> List[Tuple[str, Tuple[int, ...]]]:
    out = []
    names = [str(n) for n in _many(net, "input")]
    if names:
        shapes = _many(net, "input_shape")
        if shapes:
            dims = [tuple(int(d) for d in _many(s, "dim")) for s in shapes]
        else:
            flat = [int(d) for d in _many(net, "input_dim")]
            per = len(flat) // max(len(names), 1)
            dims = [tuple(flat[i * per:(i + 1) * per])
                    for i in range(len(names))]
        out.extend(zip(names, dims))
    for name, ltype, _, tops, ld in _layer_entries(net):
        if ltype == "Input":
            ip = _one(ld, "input_param", {})
            shapes = _many(ip, "shape")
            dims = (tuple(int(d) for d in _many(shapes[0], "dim"))
                    if shapes else ())
            out.append((tops[0], dims))
    return out


def load_caffe_parts(prototxt_text: str, caffemodel: bytes) -> OnnxProgram:
    net = parse_prototxt(prototxt_text)
    weights = decode_caffemodel(caffemodel)
    tr = _Translator(weights)

    inputs = _graph_inputs(net)
    if not inputs:
        raise ValueError("prototxt declares no inputs (need input:/"
                         "input_dim: or an Input layer)")
    for name, dims in inputs:
        tr.shapes[name] = dims

    for name, ltype, bottoms, tops, ld in _layer_entries(net):
        # skip train-phase-only layers (include { phase: TRAIN })
        phases = [str(_one(inc, "phase", "")) for inc in _many(ld, "include")]
        if any(p.upper() == "TRAIN" for p in phases):
            continue
        if ltype in _SKIP_TYPES or ltype == "Input":
            continue
        bottom = bottoms[0] if bottoms else ""
        top = tops[0] if tops else bottom
        if ltype == "Convolution":
            tr.convolution(name, _one(ld, "convolution_param", {}),
                           bottom, top)
        elif ltype == "Pooling":
            tr.pooling(name, _one(ld, "pooling_param", {}), bottom, top)
        elif ltype == "InnerProduct":
            tr.inner_product(name, _one(ld, "inner_product_param", {}),
                             bottom, top)
        elif ltype == "BatchNorm":
            tr.batch_norm(name, _one(ld, "batch_norm_param", {}),
                          bottom, top)
        elif ltype == "Scale":
            tr.scale(name, _one(ld, "scale_param", {}), bottom, top)
        elif ltype == "ReLU":
            slope = float(_one(_one(ld, "relu_param", {}),
                               "negative_slope", 0.0))
            if slope:
                tr.node("LeakyRelu", name, [bottom], [top], alpha=slope)
            else:
                tr.node("Relu", name, [bottom], [top])
            tr.shapes[top] = tr.shapes[bottom]
        elif ltype == "Sigmoid":
            tr.node("Sigmoid", name, [bottom], [top])
            tr.shapes[top] = tr.shapes[bottom]
        elif ltype == "TanH":
            tr.node("Tanh", name, [bottom], [top])
            tr.shapes[top] = tr.shapes[bottom]
        elif ltype in ("Softmax", "SoftmaxWithLoss"):
            # loss head imports as its inference softmax (the label
            # bottom, if present, is dropped)
            tr.node("Softmax", name, [bottom], [top], axis=1)
            tr.shapes[top] = tr.shapes[bottom]
        elif ltype == "Dropout":
            ratio = float(_one(_one(ld, "dropout_param", {}),
                               "dropout_ratio", 0.5))
            tr.node("Dropout", name, [bottom], [top], ratio=ratio)
            tr.shapes[top] = tr.shapes[bottom]
        elif ltype == "LRN":
            tr.lrn(name, _one(ld, "lrn_param", {}), bottom, top)
        elif ltype == "Concat":
            cp = _one(ld, "concat_param", {})
            axis = int(_one(cp, "axis", _one(cp, "concat_dim", 1)))
            tr.node("Concat", name, bottoms, [top], axis=axis)
            ref = list(tr.shapes[bottoms[0]])
            ref[axis] = sum(tr.shapes[b][axis] for b in bottoms)
            tr.shapes[top] = tuple(ref)
        elif ltype == "Flatten":
            tr.node("Flatten", name, [bottom], [top], axis=1)
            s = tr.shapes[bottom]
            tr.shapes[top] = (s[0], int(np.prod(s[1:])))
        elif ltype == "Split":
            for t in tops:
                tr.node("Identity", f"{name}_{t}", [bottom], [t])
                tr.shapes[t] = tr.shapes[bottom]
        elif ltype == "Eltwise":
            tr.eltwise(name, _one(ld, "eltwise_param", {}), bottoms, top)
        elif ltype == "Power":
            tr.power(name, _one(ld, "power_param", {}), bottom, top)
        elif ltype == "Exp":
            tr.exp_log(name, _one(ld, "exp_param", {}), bottom, top,
                       kind="Exp")
        elif ltype == "Log":
            tr.exp_log(name, _one(ld, "log_param", {}), bottom, top,
                       kind="Log")
        elif ltype == "AbsVal":
            tr.node("Abs", name, [bottom], [top])
            tr.shapes[top] = tr.shapes[bottom]
        elif ltype == "BNLL":
            tr.node("Softplus", name, [bottom], [top])
            tr.shapes[top] = tr.shapes[bottom]
        elif ltype == "ELU":
            alpha = float(_one(_one(ld, "elu_param", {}), "alpha", 1.0))
            tr.node("Elu", name, [bottom], [top], alpha=alpha)
            tr.shapes[top] = tr.shapes[bottom]
        elif ltype == "PReLU":
            tr.prelu(name, _one(ld, "prelu_param", {}), bottom, top)
        elif ltype == "Bias":
            tr.bias(name, _one(ld, "bias_param", {}), bottom, top)
        elif ltype == "Reshape":
            tr.reshape(name, _one(ld, "reshape_param", {}), bottom, top)
        elif ltype == "Slice":
            tr.slice(name, _one(ld, "slice_param", {}), bottom, tops)
        elif ltype == "Deconvolution":
            tr.deconvolution(name, _one(ld, "convolution_param", {}),
                             bottom, top)
        else:
            raise UnsupportedCaffeLayer(ltype, name)

    produced = {o for n in tr.nodes for o in n.outputs}
    consumed = {i for n in tr.nodes for i in n.inputs}
    outs = [o for o in produced if o not in consumed] or \
        [tr.nodes[-1].outputs[0]]
    g = proto.Graph(
        name=str(_one(net, "name", "caffe_net")),
        nodes=tr.nodes, initializers=tr.inits,
        inputs=[proto.ValueInfo(name=n, shape=d) for n, d in inputs],
        outputs=[proto.ValueInfo(name=o) for o in sorted(outs)])
    return OnnxProgram(proto.Model(graph=g, producer="caffe-import"))


def load_caffe(def_path: str, model_path: str) -> OnnxProgram:
    """Load prototxt (``def_path``) + caffemodel (``model_path``) —
    the reference ``Net.loadCaffe(defPath, modelPath)``
    (api/Net.scala:169-189) signature."""
    with open(def_path) as f:
        text = f.read()
    with open(model_path, "rb") as f:
        buf = f.read()
    return load_caffe_parts(text, buf)
