"""The port's int8 compute path (``ops/quantization.py``: ``int8_dot``,
``int8_matmul``, ``Calibrator``, ``QuantizedProgram``,
``quantize_program``) and ``InferenceModel.load_onnx(int8=...)`` against
the JAX package's, on the CPU.

- ``int8_dot``, dynamic and static: bit for bit (the int32 accumulation
  is exact and the rescale is the same f32 operations in the same
  order).  Weight-only (the dequantize-matmul): bit for bit where every
  product and partial sum is exact in f32 (integer x, power-of-two
  scales), and within rtol 1e-6 on seeded normal x, where only the f32
  summation order differs.
- ``Calibrator``: scales within 1e-6 relative of the JAX package's (the
  port takes numpy's linear percentile, in numpy's f32 arithmetic, from
  two order statistics).
- ``quantize_program``: the same ``quantized_nodes`` (transposed Gemms
  and shared initializers stay float) and ``act_scales`` within 1e-6
  relative; a program fully quantized gives the JAX answers bit for bit
  when both run with the same scales.
- ``load_onnx(int8=True)`` with the same calibration batches: within one
  activation quantization step's effect of the JAX answers — every
  activation element one step of its scale away, carried through the
  network: ``(s1 * |W1|_1 + s2) * |W2|_1``, ``|W|_1`` the largest column
  L1 norm (ReLU is 1-Lipschitz); with dynamic scales within 1e-6 (the
  JAX forward is jitted).  ``load_onnx`` in f32 within 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from analytics_zoo_tpu.deploy.inference import InferenceModel as JaxIM
from analytics_zoo_tpu.onnx import load_onnx_bytes as jax_load_bytes
from analytics_zoo_tpu.ops import quantization as jq

from analytics_zoo_tpu_torch.deploy import InferenceModel
from analytics_zoo_tpu_torch.onnx import load_onnx_bytes, proto, to_model
from analytics_zoo_tpu_torch.ops import quantization as tq


def _mlp_bytes(seed=0, hidden=64, head="gemm"):
    """x(16) -> Gemm(hidden) -> Relu -> a head of 4: Gemm, MatMul + Add,
    a transposed Gemm, or two MatMuls sharing ``w2`` (which keeps it
    float)."""
    rs = np.random.RandomState(seed)
    w1 = (rs.randn(16, hidden) * 0.2).astype(np.float32)
    b1 = (rs.randn(hidden) * 0.05).astype(np.float32)
    w2 = (rs.randn(hidden, 4) * 0.2).astype(np.float32)
    b2 = (rs.randn(4) * 0.05).astype(np.float32)
    nodes = [proto.Node("Gemm", "g1", ["x", "w1", "b1"], ["h1"]),
             proto.Node("Relu", "r", ["h1"], ["h2"])]
    outputs = ["y"]
    if head == "gemm":
        nodes.append(proto.Node("Gemm", "g2", ["h2", "w2", "b2"], ["y"]))
    elif head == "matmul":
        nodes += [proto.Node("MatMul", "m2", ["h2", "w2"], ["h3"]),
                  proto.Node("Add", "a2", ["h3", "b2"], ["y"])]
    elif head == "transposed":
        w2 = np.ascontiguousarray(w2.T)
        nodes.append(proto.Node("Gemm", "g2", ["h2", "w2", "b2"], ["y"],
                                {"transB": 1}))
    elif head == "shared":
        nodes += [proto.Node("MatMul", "m2", ["h2", "w2"], ["y"]),
                  proto.Node("MatMul", "m3", ["h2", "w2"], ["z"])]
        outputs = ["y", "z"]
    g = proto.Graph(
        name="mlp", nodes=nodes,
        initializers=[proto.tensor_from_array(k, v) for k, v in
                      (("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2))],
        inputs=[proto.ValueInfo("x", 1, (None, 16))],
        outputs=[proto.ValueInfo(o, 1, (None, 4)) for o in outputs])
    return proto.encode_model(proto.Model(graph=g)), (w1, w2)


def _wq(seed, k, n):
    w = np.random.RandomState(seed).randn(k, n).astype(np.float32)
    jwq, jws = jq.quantize_tensor(jnp.asarray(w), axis=-1)
    twq, tws = tq.quantize_tensor(torch.from_numpy(w), axis=-1)
    np.testing.assert_array_equal(twq.numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(tws.numpy(), np.asarray(jws))
    return (jwq, jws), (twq, tws)


@pytest.mark.parametrize("shape", [(6, 48), (2, 5, 48), (40, 48)])
@pytest.mark.parametrize("static", [False, True])
def test_int8_dot_bit_for_bit(shape, static):
    (jwq, jws), (twq, tws) = _wq(1, 48, 24)
    x = (np.random.RandomState(2).randn(*shape) * 3).astype(np.float32)
    scale = 0.037 if static else None
    want = np.asarray(jq.int8_dot(jnp.asarray(x), jwq, jws.reshape(-1),
                                  x_scale=scale))
    got = tq.int8_dot(torch.from_numpy(x), twq, tws.reshape(-1),
                      x_scale=scale).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_int8_dot_zero_input_takes_unit_scale():
    (jwq, jws), (twq, tws) = _wq(3, 16, 8)
    x = np.zeros((4, 16), np.float32)
    got = tq.int8_dot(torch.from_numpy(x), twq, tws.reshape(-1)).numpy()
    want = np.asarray(jq.int8_dot(jnp.asarray(x), jwq, jws.reshape(-1)))
    np.testing.assert_array_equal(got, want)
    assert not np.any(got)


def test_int8_dot_weight_only():
    rs = np.random.RandomState(4)
    q = rs.randint(-127, 128, (40, 24)).astype(np.int8)
    scale = (2.0 ** rs.randint(-8, -2, (1, 24))).astype(np.float32)
    exact_x = rs.randint(-8, 9, (5, 40)).astype(np.float32)
    want = np.asarray(jq.int8_dot(jnp.asarray(exact_x), jnp.asarray(q),
                                  jnp.asarray(scale), weight_only=True))
    got = tq.int8_dot(torch.from_numpy(exact_x), torch.from_numpy(q),
                      torch.from_numpy(scale), weight_only=True).numpy()
    np.testing.assert_array_equal(got, want)
    x = rs.randn(5, 40).astype(np.float32)
    want = np.asarray(jq.int8_dot(jnp.asarray(x), jnp.asarray(q),
                                  jnp.asarray(scale), weight_only=True))
    got = tq.int8_dot(torch.from_numpy(x), torch.from_numpy(q),
                      torch.from_numpy(scale), weight_only=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_int8_matmul_cpu_is_exact_and_checks_operands():
    rs = np.random.RandomState(5)
    a = rs.randint(-127, 128, (7, 40)).astype(np.int8)
    b = rs.randint(-127, 128, (40, 3)).astype(np.int8)
    got = tq.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64))
    with pytest.raises(TypeError):
        tq.int8_matmul(torch.from_numpy(a).float(), torch.from_numpy(b))
    with pytest.raises(ValueError):
        tq.int8_matmul(torch.from_numpy(a), torch.from_numpy(b[:5]))


@pytest.mark.parametrize("percentile", [99.9, 50.0, None])
def test_calibrator_scales_match_jax(percentile):
    rs = np.random.RandomState(6)
    jcal, tcal = jq.Calibrator(percentile), tq.Calibrator(percentile)
    for i in range(3):
        a = (rs.randn(64, 37) * (i + 1)).astype(np.float32)
        a[0, 0] = 40.0 * (i + 1)                    # an outlier
        jcal.observe("a", a)
        tcal.observe("a", torch.from_numpy(a))
        jcal.observe("b", a[:3, :5])
        tcal.observe("b", a[:3, :5])                # numpy is taken too
    assert tcal.names() == jcal.names() == ["a", "b"]
    for k in ("a", "b"):
        np.testing.assert_allclose(tcal.scale(k), jcal.scale(k), rtol=1e-6)
    with pytest.raises(KeyError, match="no calibration data"):
        tcal.scale("c")


@pytest.mark.parametrize("head,quantized", [
    ("gemm", ["g1", "g2"]), ("matmul", ["g1", "m2"]),
    ("transposed", ["g1"]), ("shared", ["g1"])])
def test_quantize_program_matches_jax(head, quantized):
    buf, _ = _mlp_bytes(head=head)
    rs = np.random.RandomState(7)
    cal = [rs.randn(16, 16).astype(np.float32) for _ in range(4)]
    jqp = jq.quantize_program(jax_load_bytes(buf), cal, min_size=1)
    tqp = tq.quantize_program(load_onnx_bytes(buf), cal, min_size=1,
                              device="cpu")
    assert tqp.quantized_nodes == jqp.quantized_nodes == quantized
    assert set(tqp.params) == set(jqp.params)
    assert set(tqp.act_scales) == set(jqp.act_scales)
    for k, v in jqp.act_scales.items():
        np.testing.assert_allclose(tqp.act_scales[k], v, rtol=1e-6)
    for k, (q, s) in jqp.qweights.items():
        np.testing.assert_array_equal(tqp.qweights[k][0].numpy(),
                                      np.asarray(q))
        np.testing.assert_array_equal(tqp.qweights[k][1].numpy(),
                                      np.asarray(s))
    # the same scales on both sides: the answers are the JAX ones
    x = rs.randn(32, 16).astype(np.float32)
    for scales in (jqp.act_scales, None):
        jp = jq.QuantizedProgram(jax_load_bytes(buf), scales, min_size=1)
        tp = tq.QuantizedProgram(load_onnx_bytes(buf), scales, min_size=1)
        want, _ = jp.call(jp.params, jp.state, jnp.asarray(x))
        with torch.no_grad():
            got = to_model(tp).eval()(torch.from_numpy(x))
        want = want if isinstance(want, list) else [want]
        got = got if isinstance(got, list) else [got]
        for g, w in zip(got, want):
            if head in ("gemm", "matmul"):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            else:   # a float head: f32 sums in another order
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-5, atol=1e-5)


def test_jax_quantized_weights_carry_into_the_port(zoo_ctx):
    """``convert.program_params`` of a JAX int8 program (its int8
    weights as ``{"q", "scale"}`` leaves) loads into the port's model of
    the same graph, and the two answer alike (bit for bit: the same
    int8 weights and scales)."""
    from analytics_zoo_tpu_torch.convert import (load_jax_params,
                                                 program_params)

    buf, _ = _mlp_bytes(seed=3)
    jqp = jq.quantize_program(jax_load_bytes(buf), min_size=1)
    other, _ = _mlp_bytes(seed=4)               # other weights, same graph
    model = to_model(tq.quantize_program(load_onnx_bytes(other),
                                         min_size=1))
    load_jax_params(model, program_params(jqp))
    for k, (q, s) in jqp.qweights.items():
        np.testing.assert_array_equal(model.params()[k]["q"].numpy(),
                                      np.asarray(q))
    x = np.random.RandomState(9).randn(8, 16).astype(np.float32)
    want, _ = jqp.call(jqp.params, jqp.state, jnp.asarray(x))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_function_model_holds_quantized_leaves():
    buf, _ = _mlp_bytes()
    tp = tq.quantize_program(load_onnx_bytes(buf), min_size=1)
    params = to_model(tp).params()
    assert set(params) == {"w1", "b1", "w2", "b2"}
    assert set(params["w1"]) == {"q", "scale"}
    assert params["w1"]["q"].dtype == torch.int8
    assert params["b1"].dtype == torch.float32


def test_load_onnx_matches_jax(tmp_path, zoo_ctx):
    buf, (w1, w2) = _mlp_bytes(hidden=128)
    p = tmp_path / "m.onnx"
    p.write_bytes(buf)
    rs = np.random.RandomState(8)
    cal = [rs.randn(8, 16).astype(np.float32) for _ in range(3)]
    x = rs.randn(20, 16).astype(np.float32)
    j32 = JaxIM.load_onnx(str(p), batch_buckets=(8, 32))
    t32 = InferenceModel.load_onnx(str(p), batch_buckets=(8, 32),
                                   device="cpu")
    np.testing.assert_allclose(t32.predict(x), np.asarray(j32.predict(x)),
                               rtol=1e-5, atol=1e-5)
    j8 = JaxIM.load_onnx(str(p), int8=True, calibration_inputs=cal,
                         batch_buckets=(8, 32))
    t8 = InferenceModel.load_onnx(str(p), int8=True, calibration_inputs=cal,
                                  batch_buckets=(8, 32), device="cpu")
    assert t8._int8 and t8.onnx_program.quantized_nodes == ["g1", "g2"]
    want = np.asarray(j8.predict(x))
    got = t8.predict(x)
    s1, s2 = (j8._program.act_scales[k] for k in ("g1", "g2"))
    col1 = float(np.abs(w1).sum(axis=0).max())
    col2 = float(np.abs(w2).sum(axis=0).max())
    bound = (s1 * col1 + s2) * col2
    assert np.abs(got - want).max() <= bound, (np.abs(got - want).max(),
                                               bound)
    rel = np.abs(got - t32.predict(x)).max() / np.abs(t32.predict(x)).max()
    assert rel < 0.08, rel
    # dynamic scales: one scale over the padded batch, as in JAX; the JAX
    # model runs under jit, whose fused multiply-adds round once, so the
    # two part in the last bits only
    jd = JaxIM.load_onnx(str(p), int8=True, batch_buckets=(8, 32))
    td = InferenceModel.load_onnx(str(p), int8=True, batch_buckets=(8, 32),
                                  device="cpu")
    np.testing.assert_allclose(td.predict(x), np.asarray(jd.predict(x)),
                               rtol=1e-6, atol=1e-6)


def _tiny_bert_onnx(tmp_path):
    """A BERTClassifier (2 blocks, hidden 32) written as ONNX by the
    smoke's exporter-vocabulary writer (``chip_smoke.bert_onnx_bytes``),
    with (ids, segments, mask) rows at L = 16."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier

    net = BERTClassifier(2, bert_config=dict(
        vocab=100, hidden_size=32, n_block=2, nhead=4, intermediate_size=64,
        max_position_len=40, hidden_drop=0.0, attn_drop=0.0),
        generator=torch.Generator().manual_seed(0))
    path = tmp_path / "bert.onnx"
    path.write_bytes(cs.bert_onnx_bytes(net.params(), 4))
    cs.BERT_BASE = dict(cs.BERT_BASE, vocab=100)
    cs.IMPORT_BERT = dict(cs.IMPORT_BERT, length=16)
    return net, path, cs


def test_bert_onnx_slice_matches_jax(tmp_path, zoo_ctx):
    """The slice as a whole on a narrow BERT: the exported graph (Shape
    chains, decomposed LayerNorm, masked attention, tanh GELU) through
    the JAX program (eagerly: its jitted ``load_onnx`` cannot take the
    Shape chains, the reference's fault 8) and the port's ``load_onnx``
    (graphed on the card, eager here): f32 within 1e-5, and the native
    port model within 1e-5; int8 from the same calibration batches
    within 2% of the largest f32 logit of the JAX int8 answer, with the
    same quantized nodes (every Dense of the blocks, 2 x 6, and the
    pooler; the (32, 2) head is under ``min_size`` = 512 elements)."""
    net, path, cs = _tiny_bert_onnx(tmp_path)
    xs = cs.rows_of(cs.import_bert_requests(8, 1))
    cal = [cs.rows_of(cs.import_bert_requests(8, 10 + i)) for i in range(3)]
    jprog = jax_load_bytes(path.read_bytes())
    want, _ = jprog.call(jprog.params, jprog.state,
                         *[jnp.asarray(x) for x in xs])
    want = np.asarray(want)
    t32 = InferenceModel.load_onnx(str(path), batch_buckets=(8,),
                                   device="cpu")
    np.testing.assert_allclose(t32.predict(xs), want, rtol=1e-5, atol=1e-5)
    native = InferenceModel.from_keras_net(net, batch_buckets=(8,),
                                           device="cpu")
    np.testing.assert_allclose(native.predict(xs), want, rtol=1e-5,
                               atol=1e-5)
    jq8 = jq.quantize_program(jax_load_bytes(path.read_bytes()), cal)
    jwant, _ = jq8.call(jq8.params, jq8.state, *[jnp.asarray(x) for x in xs])
    t8 = InferenceModel.load_onnx(str(path), int8=True,
                                  calibration_inputs=cal,
                                  batch_buckets=(8,), device="cpu")
    assert t8.onnx_program.quantized_nodes == jq8.quantized_nodes
    assert len(jq8.quantized_nodes) == 13
    for k, v in jq8.act_scales.items():
        np.testing.assert_allclose(t8.onnx_program.act_scales[k], v,
                                   rtol=1e-5)
    got8 = t8.predict(xs)
    assert np.abs(got8 - np.asarray(jwant)).max() <= \
        0.02 * np.abs(want).max()


def test_jax_jit_cannot_serve_a_shape_chain(tmp_path, zoo_ctx):
    """The reference's fault 8: the JAX package's ``load_onnx`` jits the
    program, and a Shape -> Gather -> ... -> Reshape chain then reads a
    traced value on the host and raises; the port keeps those values on
    the host and serves the graph."""
    net, path, cs = _tiny_bert_onnx(tmp_path)
    xs = cs.rows_of(cs.import_bert_requests(8, 2))
    with pytest.raises(Exception, match="Tracer"):
        JaxIM.load_onnx(str(path), batch_buckets=(8,)).predict(xs)
    got = InferenceModel.load_onnx(str(path), batch_buckets=(8,),
                                   device="cpu").predict(xs)
    assert got.shape == (8, 2) and np.all(np.isfinite(got))


def _split_bytes(split: bool):
    """x(16) -> MatMul(12) -> two halves -> Add: the halves by one Split
    node (two outputs), or by two Slices of the same product."""
    rs = np.random.RandomState(3)
    w = (rs.randn(16, 12) * 0.2).astype(np.float32)
    inits = [proto.tensor_from_array("w", w)]
    nodes = [proto.Node("MatMul", "m", ["x", "w"], ["h"])]
    if split:
        nodes.append(proto.Node("Split", "s", ["h"], ["a", "b"],
                                {"axis": 1, "split": [6, 6]}))
    else:
        for name, lo, hi in (("a", 0, 6), ("b", 6, 12)):
            for k, v in (("starts", lo), ("ends", hi), ("axes", 1)):
                inits.append(proto.tensor_from_array(
                    f"{name}_{k}", np.asarray([v], np.int64)))
            nodes.append(proto.Node(
                "Slice", f"slice_{name}",
                ["h", f"{name}_starts", f"{name}_ends", f"{name}_axes"],
                [name]))
    nodes.append(proto.Node("Add", "add", ["a", "b"], ["y"]))
    g = proto.Graph(name="split", nodes=nodes, initializers=inits,
                    inputs=[proto.ValueInfo("x", 1, (None, 16))],
                    outputs=[proto.ValueInfo("y", 1, (None, 6))])
    return proto.encode_model(proto.Model(graph=g))


@pytest.mark.parametrize("calibrated", [False, True])
def test_quantized_split_binds_each_output(calibrated):
    """A quantized program binds a multi-output node's values one per
    output, as the f32 program does: MatMul -> Split -> Add, quantized
    with and without calibration, equals (bit for bit) the same graph
    with the Split written as two Slices.  The JAX package stores the
    Split's tuple under its first output (its fault 9), so it has no
    answer to match here."""
    rs = np.random.RandomState(5)
    cal = ([rs.randn(8, 16).astype(np.float32) for _ in range(3)]
           if calibrated else None)
    x = torch.from_numpy(rs.randn(8, 16).astype(np.float32))
    got, want = [], []
    for split, out in ((True, got), (False, want)):
        prog = load_onnx_bytes(_split_bytes(split))
        f32, _ = prog.call(prog.params, prog.state, x)
        qp = tq.quantize_program(prog, cal, min_size=1, device="cpu")
        assert qp.quantized_nodes == ["m"]
        assert bool(qp.act_scales) == calibrated
        with torch.no_grad():
            q, _ = qp.call(qp.params, qp.state, x)
            served = to_model(qp).eval()(x)
        out += [f32, q, served]
    for g, w in zip(got, want):
        assert tuple(g.shape) == (8, 6)
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    # int8 against f32: within the quantization's error, not equal
    assert 0 < float((got[1] - got[0]).abs().max()) < 0.05
