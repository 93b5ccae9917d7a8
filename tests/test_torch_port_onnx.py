"""The port's ONNX importer (``analytics_zoo_tpu_torch.onnx``) against the
JAX package's, on the CPU.

Every graph is written once, as ONNX bytes, and read by both packages'
loaders; the same numpy inputs (seeded) go through the JAX
``OnnxProgram.call`` (eager: its Shape chains need concrete values) and
through the port's ``FunctionModel`` (the path that trains and serves).
Tolerance: rtol 1e-5 / atol 1e-5 elementwise, 1e-4 for convolutions
(sums in another order); integer outputs (Shape, ArgMax, Cast) equal.
Also: the codec both ways (equal bytes), the committed real-wire
fixture against its torch golden, the refusals, one ``fit`` step against
the JAX ``fit`` from the same bytes (SGD, atol 1e-5 on every parameter,
BatchNormalization's mean and var included: they are parameters in both
packages), and JAX-trained weights carried into the port by name.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.onnx import load_onnx_bytes as jax_load_bytes
from analytics_zoo_tpu.onnx import loader as jax_loader
from analytics_zoo_tpu.onnx import proto as jax_proto
from analytics_zoo_tpu.onnx import to_model as jax_to_model
from analytics_zoo_tpu.train import optimizers as jopt

from analytics_zoo_tpu_torch.convert import (export_params, load_jax_params,
                                             program_params)
from analytics_zoo_tpu_torch.nn.net import Net
from analytics_zoo_tpu_torch.onnx import (UnsupportedOnnxOp, load_onnx,
                                          load_onnx_bytes, proto, to_model)
from analytics_zoo_tpu_torch.onnx import loader as port_loader
from analytics_zoo_tpu_torch.train import optimizers as topt

ROOT = Path(__file__).resolve().parents[1]
FIXTURE_DIR = ROOT / "tests" / "fixtures"
TOL = dict(rtol=1e-5, atol=1e-5)
CONV_TOL = dict(rtol=1e-4, atol=1e-4)
INT64_MAX = 2 ** 63 - 1


def _vi(name, shape=()):
    return proto.ValueInfo(name=name, elem_type=1, shape=shape)


def N(op, ins, outs, **attrs):
    return proto.Node(op, f"{op.lower()}_{'_'.join(outs)}", list(ins),
                      list(outs), attrs)


def graph_bytes(nodes, inits, inputs, outputs, opset=13):
    g = proto.Graph(
        name="g", nodes=nodes,
        initializers=[proto.tensor_from_array(k, v)
                      for k, v in inits.items()],
        inputs=[_vi(k, v.shape) for k, v in inputs.items()],
        outputs=[_vi(o) for o in outputs])
    return proto.encode_model(proto.Model(graph=g, opset=opset))


def run_jax(buf, inputs):
    prog = jax_load_bytes(buf)
    out, _ = prog.call(prog.params, prog.state,
                       *[jnp.asarray(v) for v in inputs.values()])
    outs = out if isinstance(out, list) else [out]
    return [np.asarray(o) for o in outs]


def run_port(buf, inputs):
    model = to_model(load_onnx_bytes(buf)).eval()
    with torch.no_grad():
        out = model(*[torch.from_numpy(np.ascontiguousarray(v))
                      for v in inputs.values()])
    outs = out if isinstance(out, list) else [out]
    return [o.numpy() if isinstance(o, torch.Tensor) else np.asarray(o)
            for o in outs]


R = np.random.RandomState(0)


def f32(*shape, scale=1.0, positive=False):
    a = R.randn(*shape) * scale
    return (np.abs(a) + 0.1 if positive else a).astype(np.float32)


def i64(values):
    return np.asarray(values, np.int64)


def _x(*shape, **kw):
    return {"x": f32(*shape, **kw)}


# name: (nodes, initializers, inputs, outputs, tolerance)
CASES = {
    "conv2d_groups_dilation_asym": (
        [N("Conv", ["x", "w", "b"], ["y"], group=2, dilations=[2, 1],
           strides=[1, 2], pads=[1, 0, 2, 1])],
        {"w": f32(4, 2, 3, 3), "b": f32(4)}, _x(2, 4, 9, 9), ["y"],
        CONV_TOL),
    "conv1d": ([N("Conv", ["x", "w"], ["y"], pads=[1, 1])],
               {"w": f32(3, 2, 3)}, _x(2, 2, 7), ["y"], CONV_TOL),
    "conv3d": ([N("Conv", ["x", "w", "b"], ["y"], strides=[1, 2, 1])],
               {"w": f32(2, 3, 2, 2, 2), "b": f32(2)}, _x(1, 3, 4, 5, 4),
               ["y"], CONV_TOL),
    "conv_same_upper": (
        [N("Conv", ["x", "w"], ["y"], auto_pad=b"SAME_UPPER",
           strides=[2, 2])],
        {"w": f32(3, 2, 3, 3)}, _x(2, 2, 8, 7), ["y"], CONV_TOL),
    "maxpool_asym_pads": (
        [N("MaxPool", ["x"], ["y"], kernel_shape=[3, 3], strides=[2, 2],
           pads=[0, 1, 2, 1])], {}, _x(2, 3, 8, 8), ["y"], TOL),
    "maxpool_same_upper": (
        [N("MaxPool", ["x"], ["y"], kernel_shape=[3, 3], strides=[2, 2],
           auto_pad=b"SAME_UPPER")], {}, _x(2, 3, 7, 8), ["y"], TOL),
    "avgpool_exclude_pad": (
        [N("AveragePool", ["x"], ["y"], kernel_shape=[3, 3],
           strides=[1, 2], pads=[1, 1, 1, 1])], {}, _x(2, 3, 6, 7), ["y"],
        TOL),
    "avgpool_include_pad_asym": (
        [N("AveragePool", ["x"], ["y"], kernel_shape=[2, 3],
           strides=[2, 2], pads=[0, 0, 1, 1], count_include_pad=1)],
        {}, _x(2, 3, 7, 7), ["y"], TOL),
    "avgpool_1d": (
        [N("AveragePool", ["x"], ["y"], kernel_shape=[3], strides=[2])],
        {}, _x(2, 3, 9), ["y"], TOL),
    "global_pools": (
        [N("GlobalMaxPool", ["x"], ["a"]),
         N("GlobalAveragePool", ["x"], ["b"])], {}, _x(2, 3, 5, 4),
        ["a", "b"], TOL),
    "gemm_trans_alpha_beta": (
        [N("Gemm", ["x", "w", "c"], ["y"], transA=1, transB=1, alpha=0.5,
           beta=2.0)],
        {"w": f32(4, 3), "c": f32(4)}, _x(3, 5), ["y"], TOL),
    "batchnorm": (
        [N("BatchNormalization", ["x", "s", "b", "m", "v"], ["y"],
           epsilon=1e-3)],
        {"s": f32(3), "b": f32(3), "m": f32(3), "v": f32(3, positive=True)},
        _x(2, 3, 4, 4), ["y"], TOL),
    "dropout_inference": ([N("Dropout", ["x"], ["y"], ratio=0.3)], {},
                          _x(4, 5), ["y"], TOL),
    "matmul": ([N("MatMul", ["x", "w"], ["y"])], {"w": f32(4, 5)},
               _x(2, 3, 4), ["y"], TOL),
    "binary_broadcast": (
        [N("Add", ["x", "c"], ["a"]), N("Sub", ["a", "x"], ["b"]),
         N("Mul", ["b", "c"], ["m"]), N("Div", ["m", "d"], ["y"])],
        {"c": f32(4), "d": f32(4, positive=True)}, _x(3, 4), ["y"], TOL),
    "pow": ([N("Pow", ["x", "e"], ["y"])], {"e": f32(4)},
            _x(3, 4, positive=True), ["y"], TOL),
    "unary": (
        [N("Neg", ["x"], ["a"]), N("Abs", ["a"], ["b"]),
         N("Exp", ["x"], ["c"]), N("Log", ["b"], ["d"]),
         N("Sqrt", ["b"], ["e"]), N("Relu", ["x"], ["f"]),
         N("Sigmoid", ["x"], ["g"]), N("Tanh", ["x"], ["h"]),
         N("Softplus", ["x"], ["i"]), N("Identity", ["x"], ["j"]),
         N("Erf", ["x"], ["k"]), N("Reciprocal", ["b"], ["l"]),
         N("Floor", ["x"], ["m"]), N("Ceil", ["x"], ["n"])],
        {}, {"x": (f32(3, 5) * 3 + 0.01).astype(np.float32)},
        list("abcdefghijklmn"), TOL),
    "sum_max_min": (
        [N("Sum", ["x", "c", "x"], ["s"]),
         N("Max", ["x", "c", "d"], ["a"]), N("Min", ["x", "d"], ["b"])],
        {"c": f32(4), "d": f32(3, 1)}, _x(3, 4), ["s", "a", "b"], TOL),
    "softmax_family": (
        [N("Softmax", ["x"], ["a"], axis=1), N("LogSoftmax", ["x"], ["b"]),
         N("LeakyRelu", ["x"], ["c"], alpha=0.2),
         N("Elu", ["x"], ["d"], alpha=0.7),
         N("HardSigmoid", ["x"], ["e"], alpha=0.3, beta=0.4),
         N("PRelu", ["x", "slope"], ["f"])],
        {"slope": f32(4)}, _x(2, 3, 4), list("abcdef"), TOL),
    "clip_attrs": ([N("Clip", ["x"], ["y"], min=-0.5, max=0.5)], {},
                   _x(3, 4), ["y"], TOL),
    "clip_omitted_min": (
        [proto.Node("Constant", "c", [], ["mx"],
                    {"value": proto.tensor_from_array(
                        "mxv", np.asarray(0.25, np.float32))}),
         proto.Node("Clip", "cl", ["x", "", "mx"], ["y"])],
        {}, _x(3, 4), ["y"], TOL),
    "clip_min_input_only": (
        [N("Clip", ["x", "lo"], ["y"])],
        {"lo": np.asarray(-0.3, np.float32)}, _x(3, 4), ["y"], TOL),
    "flatten_reshape_transpose": (
        [N("Flatten", ["x"], ["a"], axis=2),
         N("Reshape", ["x", "shp"], ["b"]),
         N("Transpose", ["x"], ["c"], perm=[0, 2, 3, 1]),
         N("Transpose", ["x"], ["d"])],
        {"shp": i64([0, -1, 5])}, _x(2, 3, 4, 5), list("abcd"), TOL),
    "concat_squeeze_unsqueeze": (
        [N("Concat", ["x", "x"], ["a"], axis=1),
         N("Unsqueeze", ["x"], ["b"], axes=[0, 3]),
         N("Squeeze", ["b"], ["c"], axes=[0]),
         N("Unsqueeze", ["x", "ax"], ["d"]),
         N("Squeeze", ["d", "ax"], ["e"])],
        {"ax": i64([1])}, _x(2, 3, 4), list("abcde"), TOL),
    "gather": (
        [N("Gather", ["x", "idx"], ["a"], axis=1),
         N("Gather", ["tab", "ids"], ["b"]),
         N("Gather", ["x", "zero"], ["c"], axis=2)],
        {"idx": i64([[0, 2], [-1, 1]]), "tab": f32(7, 3),
         "zero": np.asarray(0, np.int64)},
        {"x": f32(2, 3, 4), "ids": np.asarray([[1, 6], [0, 3]], np.int64)},
        list("abc"), TOL),
    "constant": (
        [proto.Node("Constant", "k", [], ["c"],
                    {"value": proto.tensor_from_array("cv", f32(2, 3))}),
         N("Add", ["x", "c"], ["y"])], {}, _x(2, 3), ["y"], TOL),
    "pads": (
        [N("Pad", ["x", "p", "v"], ["a"]),
         N("Pad", ["x"], ["b"], mode=b"edge", pads=[0, 1, 2, 0, 2, 1]),
         N("Pad", ["x"], ["c"], mode=b"reflect", pads=[0, 2, 1, 0, 1, 2])],
        {"p": i64([0, 1, 2, 0, 0, 1]), "v": np.asarray(1.5, np.float32)},
        _x(2, 4, 5), list("abc"), TOL),
    "lrn": ([N("LRN", ["x"], ["y"], size=3, alpha=0.01, beta=0.6,
               bias=1.5)], {}, _x(2, 5, 4, 4), ["y"], TOL),
    "cast_shape": (
        [N("Mul", ["x", "three"], ["x3"]),
         N("Cast", ["x3"], ["a"], to=6), N("Shape", ["x"], ["b"]),
         N("Cast", ["a"], ["c"], to=1)],
        {"three": np.asarray(3.0, np.float32)}, _x(2, 3, 4), list("abc"),
        TOL),
    "reduces": (
        [N("ReduceMean", ["x"], ["a"], axes=[1], keepdims=0),
         N("ReduceSum", ["x", "ax"], ["b"], keepdims=1),
         N("ReduceMax", ["x"], ["c"], axes=[0, 2]),
         N("ReduceMin", ["x"], ["d"], keepdims=0)],
        {"ax": i64([2])}, _x(2, 3, 4), list("abcd"), TOL),
    "slices": (
        [N("Slice", ["x"], ["a"], starts=[1], ends=[3], axes=[1]),
         N("Slice", ["x", "st", "en", "ax", "sp"], ["b"]),
         N("Slice", ["x", "st2", "en2", "ax2", "sp2"], ["c"])],
        {"st": i64([0, 1]), "en": i64([5, 5]), "ax": i64([1, 2]),
         "sp": i64([2, 3]), "st2": i64([-1]), "en2": i64([-7]),
         "ax2": i64([2]), "sp2": i64([-2])},
        _x(2, 5, 6), list("abc"), TOL),
    "splits": (
        [N("Split", ["x"], ["a", "b"], axis=1, split=[1, 3]),
         N("Split", ["x", "sz"], ["c", "d"], axis=2),
         N("Split", ["x"], ["e", "f"], axis=2)],
        {"sz": i64([2, 4])}, _x(2, 4, 6), list("abcdef"), TOL),
    "expand_where": (
        [N("Expand", ["x", "shp"], ["a"]),
         N("Where", ["m", "a", "z"], ["b"])],
        {"shp": i64([2, 3, 4]), "m": np.asarray([[1, 0, 0, 1]], np.float32),
         "z": f32(3, 4)},
        _x(3, 1), ["a", "b"], TOL),
    "arg_extremes": (
        [N("ArgMax", ["x"], ["a"], axis=1, keepdims=0),
         N("ArgMin", ["x"], ["b"], axis=2)], {}, _x(2, 3, 4), ["a", "b"],
        TOL),
    "conv_transpose_2d": (
        [N("ConvTranspose", ["x", "w", "b"], ["y"], strides=[2, 2],
           pads=[1, 0, 0, 1])],
        {"w": f32(3, 4, 3, 3, scale=0.3), "b": f32(4)}, _x(2, 3, 5, 6),
        ["y"], CONV_TOL),
    "conv_transpose_1d": (
        [N("ConvTranspose", ["x", "w"], ["y"])],
        {"w": f32(3, 2, 4, scale=0.3)}, _x(2, 3, 7), ["y"], CONV_TOL),
    "shape_chain": (
        [N("Shape", ["x"], ["s"]),
         N("Gather", ["s", "zero"], ["b"]),
         N("Gather", ["s", "one"], ["h"]),
         N("Gather", ["s", "two"], ["w"]),
         N("Mul", ["h", "w"], ["hw"]),
         N("Unsqueeze", ["b"], ["bu"], axes=[0]),
         N("Unsqueeze", ["hw", "ax0"], ["hwu"]),
         N("Concat", ["bu", "hwu"], ["shape"], axis=0),
         N("Reshape", ["x", "shape"], ["y"])],
        {"zero": np.asarray(0, np.int64), "one": np.asarray(1, np.int64),
         "two": np.asarray(2, np.int64), "ax0": i64([0])},
        _x(3, 4, 5), ["y"], TOL),
}


def test_cases_cover_every_mapper():
    covered = {n.op_type for nodes, *_ in CASES.values() for n in nodes}
    assert set(port_loader._MAPPERS) == set(jax_loader._MAPPERS)
    assert covered == set(jax_loader._MAPPERS), (
        set(jax_loader._MAPPERS) - covered)


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_jax(case):
    nodes, inits, inputs, outputs, tol = CASES[case]
    buf = graph_bytes(nodes, inits, inputs, outputs)
    want = run_jax(buf, inputs)
    got = run_port(buf, inputs)
    assert len(got) == len(want)
    for name, g, w in zip(outputs, got, want):
        assert g.shape == w.shape, (name, g.shape, w.shape)
        if np.issubdtype(w.dtype, np.integer):
            assert np.issubdtype(g.dtype, np.integer), (name, g.dtype)
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, err_msg=name, **tol)


def test_slice_to_the_end_keeps_int64():
    """Exporters end an open Slice at INT64_MAX.  The JAX package holds
    int64 initializers in int32 (no x64), which wraps that end to -1 and
    drops the last element (ROADMAP C, the reference's fault 7); the port
    keeps the int64 value and slices as ONNX defines it."""
    buf = graph_bytes(
        [N("Slice", ["x", "st", "en", "ax", "sp"], ["y"])],
        {"st": i64([0, -1]), "en": i64([INT64_MAX, -INT64_MAX]),
         "ax": i64([1, 2]), "sp": i64([2, -1])}, _x(2, 5, 6), ["y"])
    x = {"x": f32(2, 5, 6)}
    (got,) = run_port(buf, x)
    np.testing.assert_array_equal(got, x["x"][:, 0::2, ::-1])
    (jgot,) = run_jax(buf, x)
    assert jgot.shape != got.shape          # the reference's fault 7


def test_shape_chain_stays_on_the_host():
    """The Shape -> Gather -> Mul -> Unsqueeze -> Concat -> Reshape chain
    runs on host values: nothing of it is copied to the tensors' device
    (a copy there would break a CUDA graph's capture)."""
    nodes, inits, inputs, outputs, _ = CASES["shape_chain"]
    prog = load_onnx_bytes(graph_bytes(nodes, inits, inputs, outputs))
    env = {"x": torch.from_numpy(inputs["x"])}
    env.update(prog.consts)
    for n, fn in prog.nodes:
        out = prog.run_node(n, fn, port_loader._resolve_inputs(env, n.inputs))
        env[n.outputs[0]] = out
        assert isinstance(out, torch.Tensor) == (n.op_type == "Reshape"), n
    assert prog._device_values == {}


def test_codec_roundtrip_and_equal_bytes():
    nodes, inits, inputs, outputs, _ = CASES["gemm_trans_alpha_beta"]
    buf = graph_bytes(nodes, inits, inputs, outputs)
    m = proto.decode_model(buf)
    assert proto.encode_model(m) == buf
    jm = jax_proto.decode_model(buf)
    assert jax_proto.encode_model(jm) == buf
    assert [n.op_type for n in m.graph.nodes] == ["Gemm"]
    assert m.graph.nodes[0].attrs == jm.graph.nodes[0].attrs
    for t, jt in zip(m.graph.initializers, jm.graph.initializers):
        assert t.name == jt.name and t.dims == jt.dims
        np.testing.assert_array_equal(t.array, jt.array)
    n = proto.Node("X", "n", ["a"], ["b"], {"f": 1.5, "i": 7, "s": b"hi",
                                            "fl": [1.0, 2.0], "il": [3, 4]})
    assert proto._encode_node(n) == jax_proto._encode_node(n)
    assert proto._decode_node(proto._encode_node(n)).attrs["il"] == [3, 4]


def test_real_wire_fixture_matches_golden():
    """The committed fixture (serialized by protoc-generated code,
    independent of both codecs) against its torch golden."""
    prog = load_onnx(str(FIXTURE_DIR / "tiny_convnet.onnx"))
    d = np.load(FIXTURE_DIR / "tiny_convnet_golden.npz")
    out = to_model(prog).eval()(torch.from_numpy(d["x"]))
    np.testing.assert_allclose(out.detach().numpy(), d["expected"],
                               atol=1e-5, rtol=1e-5)
    assert [n.op_type for n, _ in prog.nodes] == [
        "Conv", "Relu", "MaxPool", "Flatten", "Gemm"]


def test_refusals_match_jax():
    same_lower = graph_bytes(
        [N("Conv", ["x", "w"], ["y"], auto_pad=b"SAME_LOWER")],
        {"w": f32(2, 2, 3, 3)}, _x(1, 2, 5, 5), ["y"])
    x = {"x": f32(1, 2, 5, 5)}
    with pytest.raises(jax_loader.UnsupportedOnnxOp, match="SAME_LOWER"):
        run_jax(same_lower, x)
    with pytest.raises(UnsupportedOnnxOp, match="SAME_LOWER"):
        run_port(same_lower, x)
    ceil = graph_bytes(
        [N("MaxPool", ["x"], ["y"], kernel_shape=[2, 2], ceil_mode=1)], {},
        x, ["y"])
    with pytest.raises(jax_loader.UnsupportedOnnxOp, match="ceil_mode"):
        jax_load_bytes(ceil)
    with pytest.raises(UnsupportedOnnxOp, match="ceil_mode"):
        load_onnx_bytes(ceil)
    unknown = graph_bytes([N("NonMaxSuppression", ["x"], ["y"])], {}, x,
                          ["y"])
    with pytest.raises(jax_loader.UnsupportedOnnxOp,
                       match="NonMaxSuppression"):
        jax_load_bytes(unknown)
    with pytest.raises(UnsupportedOnnxOp, match="NonMaxSuppression"):
        load_onnx_bytes(unknown)
    deconv = graph_bytes(
        [N("ConvTranspose", ["x", "w"], ["y"], output_padding=[1, 1])],
        {"w": f32(2, 2, 3, 3)}, x, ["y"])
    with pytest.raises(UnsupportedOnnxOp, match="output_padding"):
        load_onnx_bytes(deconv)


def _mlp_bytes(seed=0):
    rs = np.random.RandomState(seed)
    return graph_bytes(
        [N("Gemm", ["x", "w1", "b1"], ["h1"]), N("Relu", ["h1"], ["h2"]),
         N("MatMul", ["h2", "w2"], ["h3"]), N("Add", ["h3", "b2"], ["y"])],
        {"w1": (rs.randn(6, 16) * 0.4).astype(np.float32),
         "b1": (rs.randn(16) * 0.1).astype(np.float32),
         "w2": (rs.randn(16, 3) * 0.4).astype(np.float32),
         "b2": np.zeros(3, np.float32)},
        {"x": np.zeros((1, 6), np.float32)}, ["y"])


def _convnet_bytes(seed=1):
    rs = np.random.RandomState(seed)
    return graph_bytes(
        [N("Conv", ["x", "k", "kb"], ["c"], pads=[1, 1, 1, 1]),
         N("BatchNormalization", ["c", "g", "be", "mu", "var"], ["bn"]),
         N("Relu", ["bn"], ["r"]),
         N("MaxPool", ["r"], ["p"], kernel_shape=[2, 2], strides=[2, 2]),
         N("Flatten", ["p"], ["f"]),
         N("Gemm", ["f", "w", "wb"], ["y"], transB=1)],
        {"k": (rs.randn(4, 3, 3, 3) * 0.3).astype(np.float32),
         "kb": (rs.randn(4) * 0.1).astype(np.float32),
         "g": (1 + 0.1 * rs.randn(4)).astype(np.float32),
         "be": (0.1 * rs.randn(4)).astype(np.float32),
         "mu": (0.1 * rs.randn(4)).astype(np.float32),
         "var": (1 + 0.1 * np.abs(rs.randn(4))).astype(np.float32),
         "w": (rs.randn(3, 4 * 4 * 4) * 0.2).astype(np.float32),
         "wb": np.zeros(3, np.float32)},
        {"x": np.zeros((1, 3, 8, 8), np.float32)}, ["y"])


@pytest.mark.parametrize("make,shape", [(_mlp_bytes, (16, 6)),
                                        (_convnet_bytes, (16, 3, 8, 8))],
                         ids=["mlp", "convnet_bn"])
def test_one_fit_step_matches_jax(zoo_ctx, make, shape):
    buf = make()
    rs = np.random.RandomState(7)
    x = rs.randn(*shape).astype(np.float32)
    y = rs.randint(0, 3, shape[0]).astype(np.int32)
    loss = "sparse_categorical_crossentropy_with_logits"
    jm = jax_to_model(jax_load_bytes(buf))
    jm.compile(optimizer=jopt.SGD(lr=0.1), loss=loss)
    jh = jm.fit(x, y, batch_size=16, nb_epoch=1, verbose=False)
    want = jax.tree_util.tree_map(np.asarray, jm.estimator.params)
    tm = to_model(load_onnx_bytes(buf))
    tm.compile(optimizer=topt.SGD(lr=0.1), loss=loss, device="cpu")
    th = tm.fit(x, y, batch_size=16, nb_epoch=1, verbose=False)
    got = export_params(tm)
    assert set(got) == set(want)
    before = load_onnx_bytes(buf).params
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=1e-5,
                                   err_msg=name)
        # every float initializer moved (BatchNormalization's mean and
        # var are parameters, as in the JAX package)
        assert not np.array_equal(got[name], before[name]) or \
            np.array_equal(w, before[name]), name
    np.testing.assert_allclose(th[-1]["loss"], jh[-1]["loss"], rtol=1e-5)


def test_params_tree_is_flat_onnx_names_and_jax_weights_carry(zoo_ctx):
    """``params()`` is the JAX FunctionModel's flat tree, dotted ONNX
    names included; a JAX-trained tree loads into the port by name
    (``convert.load_jax_params``) and answers as the JAX model does."""
    rs = np.random.RandomState(3)
    buf = graph_bytes(
        [N("MatMul", ["x", "layer1.0.fc.weight"], ["h"]),
         N("Add", ["h", "layer1.0.fc.bias"], ["y"])],
        {"layer1.0.fc.weight": rs.randn(5, 4).astype(np.float32),
         "layer1.0.fc.bias": rs.randn(4).astype(np.float32)},
        {"x": np.zeros((1, 5), np.float32)}, ["y"])
    jm = jax_to_model(jax_load_bytes(buf))
    jm.compile(optimizer=jopt.SGD(lr=0.5), loss="mse")
    x = rs.randn(16, 5).astype(np.float32)
    jm.fit(x, rs.randn(16, 4).astype(np.float32), batch_size=8,
           nb_epoch=2, verbose=False)
    trained = jax.tree_util.tree_map(np.asarray, jm.estimator.params)
    tm = to_model(load_onnx_bytes(buf))
    assert set(tm.params()) == {"layer1.0.fc.weight", "layer1.0.fc.bias"}
    load_jax_params(tm, program_params(jm))
    for k, v in trained.items():
        np.testing.assert_array_equal(tm.params()[k].numpy(), v)
    want = np.asarray(jm.predict(x, batch_size=8))
    tm.compile(optimizer="sgd", loss="mse", device="cpu")
    np.testing.assert_allclose(tm.predict(x, batch_size=8), want, **TOL)


def test_net_loaders(tmp_path):
    p = tmp_path / "m.onnx"
    p.write_bytes(_mlp_bytes())
    model = Net.load_onnx(str(p))
    assert set(model.params()) == {"w1", "b1", "w2", "b2"}
    with pytest.raises(NotImplementedError, match="ONNX"):
        Net.load_bigdl("x")
    with pytest.raises(NotImplementedError, match="A10"):
        Net.load_tf("x")
    with pytest.raises(NotImplementedError, match="A10"):
        Net.export_tf_saved_model(None, None, "x", [(1, 2)])
    with pytest.raises(FileNotFoundError):
        Net.load_caffe("/nonexistent.prototxt", "/nonexistent.caffemodel")


def test_new_modules_import_no_jax():
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from analytics_zoo_tpu_torch import onnx, caffe, bigdl, tfpark\n"
        "from analytics_zoo_tpu_torch.nn.net import Net, GraphNet\n"
        "from analytics_zoo_tpu_torch.ops.quantization import (int8_dot,"
        " Calibrator, QuantizedProgram, quantize_program)\n"
        "from analytics_zoo_tpu_torch.deploy import InferenceModel\n"
        "from analytics_zoo_tpu_torch.onnx import proto\n"
        "g = proto.Graph(nodes=[proto.Node('Relu', 'r', ['x'], ['y'])],"
        " inputs=[proto.ValueInfo('x', 1, (None, 2))],"
        " outputs=[proto.ValueInfo('y')])\n"
        "p = onnx.load_onnx_bytes(proto.encode_model(proto.Model(graph=g)))\n"
        "assert onnx.to_model(p).eval()(__import__('torch').ones(1, 2))"
        ".shape == (1, 2)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'analytics_zoo_tpu' or m.startswith('analytics_zoo_tpu.')"
        " or m == 'ml_dtypes']\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and "clean" in res.stdout, res.stderr


def test_entry_points_default_to_the_card():
    """``to_model(...).compile`` and ``load_onnx`` resolve ``cuda`` when
    no device is given: on a machine without one they raise rather than
    run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from analytics_zoo_tpu_torch.deploy import InferenceModel

    model = to_model(load_onnx_bytes(_mlp_bytes()))
    with pytest.raises(Exception, match="(?i)cuda"):
        model.compile("sgd", "mse")
    path = FIXTURE_DIR / "tiny_convnet.onnx"
    with pytest.raises(Exception, match="(?i)cuda"):
        InferenceModel.load_onnx(str(path))


# -- torch ingestion and GraphNet.new_graph ---------------------------------

def _vgg11(widths=(8, 16, 32, 32, 64, 64, 64, 64), size=32, classes=10,
           seed=0):
    """torchvision's VGG-11 layer sequence (configuration 'A'), narrow."""
    nn = torch.nn
    torch.manual_seed(seed)
    w = widths
    layers, cin = [], 3
    for i, c in enumerate(w):
        layers += [nn.Conv2d(cin, c, 3, padding=1), nn.ReLU()]
        if i in (0, 1, 3, 5, 7):
            layers.append(nn.MaxPool2d(2))
        cin = c
    side = size // 32
    layers += [nn.Flatten(), nn.Linear(cin * side * side, 64), nn.ReLU(),
               nn.Dropout(0.5), nn.Linear(64, 64), nn.ReLU(),
               nn.Dropout(0.5), nn.Linear(64, classes)]
    return nn.Sequential(*layers).eval()


def test_torch_model_matches_jax_and_torch(zoo_ctx):
    from analytics_zoo_tpu.tfpark import TorchModel as JTorchModel

    from analytics_zoo_tpu_torch.tfpark import TorchModel

    vgg = _vgg11()
    jtm = JTorchModel(vgg)
    tm = TorchModel(vgg, device="cpu")
    want_tree = jtm.model.program.params
    got_tree = export_params(tm.model)
    assert set(got_tree) == set(want_tree)
    for layer, leaves in want_tree.items():
        for leaf, v in leaves.items():
            np.testing.assert_array_equal(got_tree[layer][leaf], v)
    x = np.random.RandomState(1).randn(4, 3, 32, 32).astype(np.float32)
    with torch.no_grad():
        ref = vgg(torch.from_numpy(x)).numpy()
    got = tm.predict(x, batch_size=4)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jtm.predict(x, batch_size=4)),
                               rtol=1e-4, atol=1e-5)


def test_torch_criterion_maps_as_jax(zoo_ctx):
    from analytics_zoo_tpu.tfpark import TorchCriterion as JCrit

    from analytics_zoo_tpu_torch.tfpark import TorchCriterion

    nn = torch.nn
    rs = np.random.RandomState(2)
    logits = rs.randn(8, 5).astype(np.float32)
    probs = 1 / (1 + np.exp(-rs.randn(8, 1))).astype(np.float32)
    labels = rs.randint(0, 5, 8).astype(np.int32)
    targets = rs.randn(8, 5).astype(np.float32)
    bits = rs.randint(0, 2, (8, 1)).astype(np.float32)
    cases = [(nn.MSELoss(), targets, logits), (nn.L1Loss(), targets, logits),
             (nn.SmoothL1Loss(), targets, logits),
             (nn.CrossEntropyLoss(), labels, logits),
             (nn.NLLLoss(), labels, np.log(np.abs(logits) + 0.1)),
             (nn.BCELoss(), bits, probs),
             (nn.BCEWithLogitsLoss(), bits, logits[:, :1])]
    for loss, yt, yp in cases:
        jc, tc = JCrit(loss), TorchCriterion(loss)
        assert tc.name == jc.name
        want = float(jc(jnp.asarray(yt), jnp.asarray(yp)))
        got = float(tc(torch.from_numpy(yt), torch.from_numpy(yp)))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=tc.name)
    from analytics_zoo_tpu_torch.tfpark import UnsupportedLayerError
    with pytest.raises(UnsupportedLayerError, match="HingeEmbeddingLoss"):
        TorchCriterion(nn.HingeEmbeddingLoss())


def test_torch_model_trains_like_jax(zoo_ctx):
    from analytics_zoo_tpu.tfpark import TorchCriterion as JCrit
    from analytics_zoo_tpu.tfpark import TorchModel as JTorchModel

    from analytics_zoo_tpu_torch.tfpark import TorchCriterion, TorchModel

    nn = torch.nn
    torch.manual_seed(3)
    seq = nn.Sequential(nn.Conv2d(3, 4, 3, padding=1), nn.ReLU(),
                        nn.MaxPool2d(2), nn.Flatten(),
                        nn.Linear(4 * 4 * 4, 5)).eval()
    jtm = JTorchModel(seq, optimizer=jopt.SGD(lr=0.1),
                      loss=JCrit(nn.CrossEntropyLoss()))
    tm = TorchModel(seq, optimizer=topt.SGD(lr=0.1),
                    loss=TorchCriterion(nn.CrossEntropyLoss()),
                    device="cpu")
    rs = np.random.RandomState(4)
    x = rs.randn(16, 3, 8, 8).astype(np.float32)
    y = rs.randint(0, 5, 16).astype(np.int32)
    jh = jtm.fit(x, y, batch_size=16, epochs=2, verbose=False)
    th = tm.fit(x, y, batch_size=16, epochs=2, verbose=False)
    np.testing.assert_allclose([r["loss"] for r in th],
                               [r["loss"] for r in jh], rtol=1e-5)
    want = jax.tree_util.tree_map(np.asarray, jtm.model.estimator.params)
    got = export_params(tm.model)
    for layer, leaves in want.items():
        for leaf, v in leaves.items():
            np.testing.assert_allclose(got[layer][leaf], v, rtol=0,
                                       atol=1e-5, err_msg=f"{layer}.{leaf}")


def _graph_models():
    from analytics_zoo_tpu.nn import reset_name_scope as jreset
    from analytics_zoo_tpu.nn.autograd import Input as JInput
    from analytics_zoo_tpu.nn.layers import Dense as JDense
    from analytics_zoo_tpu.nn.topology import Model as JModel

    from analytics_zoo_tpu_torch.nn import Input, Model, reset_name_scope
    from analytics_zoo_tpu_torch.nn.layers import Dense

    def build(inp_cls, dense, model):
        inp = inp_cls(shape=(6,))
        h1 = dense(8, activation="relu", name="backbone1")(inp)
        h2 = dense(4, activation="relu", name="backbone2")(h1)
        return model(inp, dense(2, activation="softmax", name="head")(h2))

    jreset()
    jm = build(JInput, JDense, JModel)
    reset_name_scope()
    tm = build(Input, Dense, Model)
    return jm, tm


def test_new_graph_matches_jax_and_carries_weights(zoo_ctx):
    from analytics_zoo_tpu.nn.net import GraphNet as JGraphNet

    from analytics_zoo_tpu_torch.nn.net import GraphNet

    jm, tm = _graph_models()
    tm.build(torch.Generator().manual_seed(0))
    rs = np.random.RandomState(5)
    init = {k: {leaf: (rs.randn(*v.shape) * 0.5).astype(np.float32)
                for leaf, v in sub.items()}
            for k, sub in export_params(tm).items()}
    load_jax_params(tm, init)
    loss = "sparse_categorical_crossentropy"
    jm.compile(optimizer=jopt.SGD(lr=0.1), loss=loss)
    jm.estimator.set_initial_weights(init)
    tm.compile(optimizer=topt.SGD(lr=0.1), loss=loss, device="cpu")
    x = rs.randn(32, 6).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int32)
    jm.fit(x, y, batch_size=16, nb_epoch=2, verbose=False)
    tm.fit(x, y, batch_size=16, nb_epoch=2, verbose=False)
    jgn = JGraphNet(jm).new_graph("backbone2")
    gn = GraphNet(tm).new_graph("backbone2")
    want = np.asarray(jgn.predict(x[:8], batch_size=8))
    got = gn.predict(x[:8], batch_size=8)          # compiled on the cut
    assert got.shape == (8, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    carried = export_params(gn.model)
    assert set(carried) == {"backbone1", "backbone2"}
    jcarried = jax.tree_util.tree_map(np.asarray,
                                      jgn.model.estimator.params)
    for layer in carried:
        for leaf, v in carried[layer].items():
            np.testing.assert_array_equal(v, export_params(tm)[layer][leaf])
            np.testing.assert_allclose(v, jcarried[layer][leaf], atol=1e-6)
    # the features are the source net's intermediate output, and the cut
    # trains apart from the source
    with torch.no_grad():
        h = torch.relu(torch.from_numpy(x[:8]) @ tm.layers[0].leaf("kernel")
                       + tm.layers[0].leaf("bias"))
        h = torch.relu(h @ tm.layers[1].leaf("kernel")
                       + tm.layers[1].leaf("bias"))
    np.testing.assert_allclose(got, h.numpy(), rtol=1e-6, atol=1e-7)
    before = export_params(tm)
    gn.model.compile(optimizer=topt.SGD(lr=0.5), loss="mse", device="cpu")
    gn.model.fit(x, rs.randn(32, 4).astype(np.float32), batch_size=16,
                 nb_epoch=1, verbose=False)
    after = export_params(tm)
    for layer in before:
        for leaf in before[layer]:
            np.testing.assert_array_equal(after[layer][leaf],
                                          before[layer][leaf])
    with pytest.raises(ValueError, match="unknown"):
        GraphNet(tm).new_graph("nope")
