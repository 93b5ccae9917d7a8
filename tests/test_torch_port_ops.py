"""The PyTorch port's kernel modules against the JAX package.

Inputs come from ``np.random.RandomState``; the same arrays go through
the JAX function (the Pallas kernel in interpret mode) and the port's
counterpart on the CPU, where the port's wrapper takes its plain PyTorch
version.  Tolerance for f32: rtol 1e-5, atol 1e-6 — the two sum in
different orders.  Quantization and int4 packing must be bit-identical.

The kernels themselves are held against these plain versions on the
card by ``tests/test_torch_port_cuda.py`` and ``chip_smoke.py``.
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.deploy.inference import quantize_pytree as jax_qtree
from analytics_zoo_tpu.ops.quantization import quantize_tensor as jax_qt

from analytics_zoo_tpu_torch.core import context
from analytics_zoo_tpu_torch.deploy.inference import (
    dequantize_pytree, quantize_pytree)
from analytics_zoo_tpu_torch.observe.metrics import METRICS
from analytics_zoo_tpu_torch.ops import _build, dispatch
from analytics_zoo_tpu_torch.ops import dequant_matmul as tdq
from analytics_zoo_tpu_torch.ops import embedding_bag as teb
from analytics_zoo_tpu_torch.ops.quantization import quantize_tensor

# the JAX package's ops/__init__ re-exports functions under the module
# names, so the modules are fetched by path
jdq = importlib.import_module("analytics_zoo_tpu.ops.dequant_matmul")
jeb = importlib.import_module("analytics_zoo_tpu.ops.embedding_bag")

RTOL, ATOL = 1e-5, 1e-6


def _selected(window):
    """``ops_kernel_selected_total`` increments since ``window``, as
    {(kernel, path): n}."""
    out = {}
    for series, n in METRICS.delta(window)["counters"].items():
        if series.startswith("ops_kernel_selected_total{"):
            labels = dict(kv.split("=") for kv in series[
                len("ops_kernel_selected_total{"):-1].split(","))
            out[(labels["kernel"].strip('"'), labels["path"].strip('"'))] = n
    return out


@pytest.fixture(autouse=True)
def fresh_context():
    context.set_zoo_context(None)
    yield
    context.set_zoo_context(None)


def _bag_inputs(v, d, b, n, pad_id, seed):
    rs = np.random.RandomState(seed)
    table = rs.randn(v, d).astype(np.float32)
    ids = rs.randint(0, v, size=(b, n)).astype(np.int32)
    if pad_id is not None:
        ids[rs.rand(b, n) < 0.3] = pad_id
        ids[0, :] = pad_id                        # one all-pad bag
    return table, ids


# ---------------------------------------------------------------------------
# embedding bag


# ragged bag counts: 9 does not fill the TPU kernel's 8-bag block twice,
# 1 is the singleton bag the NCF lookups use
@pytest.mark.parametrize("combiner", teb.COMBINERS)
@pytest.mark.parametrize("pad_id,b,n", [(0, 9, 2), (-1, 9, 2), (None, 9, 2),
                                        (None, 1, 1)])
def test_embedding_bag_matches_jax(combiner, pad_id, b, n):
    table, ids = _bag_inputs(37, 7, b, n, pad_id, seed=b * 7 + n)
    want = np.asarray(jeb.embedding_bag(
        jnp.asarray(table), jnp.asarray(ids), combiner, pad_id=pad_id,
        interpret=True))
    t, i = torch.from_numpy(table), torch.from_numpy(ids)
    plain = teb.embedding_bag_reference(t, i, combiner, pad_id)
    routed = teb.embedding_bag(t, i, combiner, pad_id)
    np.testing.assert_allclose(plain.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(routed.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", [(6,), (3, 4), (2, 1, 3)])
def test_embedding_gather_matches_jax(shape):
    rs = np.random.RandomState(len(shape))
    table = rs.randn(29, 5).astype(np.float32)
    ids = rs.randint(0, 29, size=shape).astype(np.int32)
    want = np.asarray(jeb.embedding_gather(jnp.asarray(table),
                                           jnp.asarray(ids), interpret=True))
    got = teb.embedding_gather(torch.from_numpy(table), torch.from_numpy(ids))
    assert tuple(got.shape) == shape + (5,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_out_of_range_ids_clip():
    """The clip rule of the TPU kernel, which the port's plain version
    keeps: ids below 0 read row 0, ids past the table its last row."""
    rs = np.random.RandomState(3)
    table = torch.from_numpy(rs.randn(10, 4).astype(np.float32))
    ids = torch.tensor([[-5, 3], [10, 99], [2, -1]], dtype=torch.int32)
    clipped = ids.clamp(0, 9)
    got = teb.embedding_bag(table, ids, "sum", pad_id=None)
    np.testing.assert_array_equal(
        got.numpy(), (table[clipped.long()].sum(1)).numpy())
    want = np.asarray(jeb.embedding_bag(
        jnp.asarray(table.numpy()), jnp.asarray(ids.numpy()), "sum",
        pad_id=None, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(
        teb.embedding_gather(table, ids).numpy(), table[clipped.long()])


def test_int64_ids_and_empty_batch():
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    ids = torch.tensor([[1, 2]], dtype=torch.int64)
    np.testing.assert_array_equal(
        teb.embedding_bag(table, ids, "mean", pad_id=None).numpy(),
        [[4.5, 5.5, 6.5]])
    empty = teb.embedding_bag(table, torch.zeros((0, 3), dtype=torch.int32))
    assert tuple(empty.shape) == (0, 3)


def test_bad_bag_arguments_raise():
    table = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="combiner"):
        teb.embedding_bag(table, torch.zeros((2, 2), dtype=torch.int32), "max")
    with pytest.raises(ValueError, match="ids must be"):
        teb.embedding_bag(table, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="table must be"):
        teb.embedding_gather(torch.zeros(4), torch.zeros(2, dtype=torch.int32))


HALF_RTOL = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}


def _close_half(got, want, dtype, terms):
    """One rounding into the table's type apart (2^-7 of |want| in bf16,
    2^-10 in f16; both sides round an f32 result once), on top of f32
    sums in another order (1e-6 of the summed magnitude ``terms``)."""
    assert str(got.dtype).replace("torch.", "") == dtype
    got = got.double().numpy()
    want = np.asarray(want).astype(np.float64)
    assert np.all(np.abs(got - want)
                  <= HALF_RTOL[dtype] * np.abs(want) + 1e-6 * terms)


def _half_table(rs, v, d, dtype):
    """A (v, d) table in ``dtype`` for both packages: the JAX array and
    the torch tensor holding the same values."""
    jt = jnp.asarray(rs.randn(v, d).astype(np.float32)).astype(
        getattr(jnp, dtype))
    tt = torch.from_numpy(np.array(jt.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return jt, tt


@pytest.mark.parametrize("dtype,combiner,pad_id", [
    ("bfloat16", "mean", 0), ("bfloat16", "sqrtn", None),
    ("float16", "sum", 0), ("float16", "sqrtn", None)])
def test_embedding_bag_half_precision_matches_jax(dtype, combiner, pad_id):
    """bf16 and f16 tables: the output in the table's type (an f32 sum
    rounded once) and the table's gradient (f32 scatter, then the
    table's type) as the JAX kernel's ``custom_vjp`` gives them, in
    interpret mode."""
    rs = np.random.RandomState(len(dtype) + len(combiner))
    jt, tt = _half_table(rs, 37, 7, dtype)
    _, ids = _bag_inputs(37, 7, 9, 2, pad_id, seed=5)
    cot = rs.randn(9, 7).astype(np.float32)

    def jloss(t):
        out = jeb.embedding_bag(t, jnp.asarray(ids), combiner,
                                pad_id=pad_id, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * cot)

    want = jeb.embedding_bag(jt, jnp.asarray(ids), combiner, pad_id=pad_id,
                             interpret=True)
    want_grad = jax.grad(jloss)(jt)
    assert str(want.dtype) == str(want_grad.dtype) == dtype
    leaf = tt.clone().requires_grad_(True)
    got = teb.embedding_bag(leaf, torch.from_numpy(ids), combiner, pad_id)
    (got.float() * torch.from_numpy(cot)).sum().backward()
    terms = teb.embedding_bag_reference(tt.double().abs(),
                                        torch.from_numpy(ids), combiner,
                                        pad_id).numpy()
    _close_half(got.detach(), want.astype(jnp.float32), dtype, terms)
    grad_terms = teb.embedding_bag_backward_reference(
        37, torch.from_numpy(ids), torch.from_numpy(np.abs(cot)).double(),
        combiner, pad_id).numpy()
    _close_half(leaf.grad, want_grad.astype(jnp.float32), dtype, grad_terms)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_embedding_gather_half_precision_matches_jax(dtype):
    """A gather from a bf16 or f16 table and its table gradient, against
    the JAX package's gather through its Pallas kernel (interpret mode):
    each output is one row, so the forward is exact; duplicate ids sum
    their cotangents in f32 before the one rounding."""
    rs = np.random.RandomState(len(dtype))
    jt, tt = _half_table(rs, 29, 5, dtype)
    ids = rs.randint(0, 29, size=(4, 3)).astype(np.int32)
    cot = rs.randn(4, 3, 5).astype(np.float32)
    want = jeb.embedding_gather(jt, jnp.asarray(ids), interpret=True)
    want_grad = jax.grad(lambda t: jnp.sum(jeb.embedding_gather(
        t, jnp.asarray(ids), interpret=True).astype(jnp.float32) * cot))(jt)
    leaf = tt.clone().requires_grad_(True)
    got = teb.embedding_gather(leaf, torch.from_numpy(ids))
    (got.float() * torch.from_numpy(cot)).sum().backward()
    assert got.dtype == tt.dtype and tuple(got.shape) == (4, 3, 5)
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    terms = teb.embedding_bag_backward_reference(
        29, torch.from_numpy(ids.reshape(-1, 1)),
        torch.from_numpy(np.abs(cot).reshape(-1, 5)).double(), "sum",
        None).numpy()
    _close_half(leaf.grad, want_grad.astype(jnp.float32), dtype, terms)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_embedding_layer_half_precision_matches_jax(dtype):
    """``Embedding(dtype=bf16/f16)`` with the JAX layer's weights carried
    across by ``load_jax_params`` (the JAX tree's bf16 array as it is):
    the lookup and the table's gradient match the JAX layer's.  Ids are
    distinct, so each gradient row is one cotangent rounded once on both
    sides."""
    from analytics_zoo_tpu.nn.layers.embedding import Embedding as JEmb

    from analytics_zoo_tpu_torch.convert import load_jax_params
    from analytics_zoo_tpu_torch.nn.layers import Embedding

    rs = np.random.RandomState(7)
    jt, _ = _half_table(rs, 40, 6, dtype)
    ids = rs.permutation(40)[:12].reshape(3, 4).astype(np.int32)
    cot = rs.randn(3, 4, 6).astype(np.float32)
    jemb = JEmb(40, 6, dtype=getattr(jnp, dtype))
    params = {"table": jt}
    want, _ = jemb.call(params, {}, jnp.asarray(ids))
    want_grad = jax.grad(lambda p: jnp.sum(jemb.call(
        p, {}, jnp.asarray(ids))[0].astype(jnp.float32) * cot))(params)
    emb = Embedding(40, 6, dtype=getattr(torch, dtype))
    emb.build(torch.Generator().manual_seed(0), (3, 4))
    load_jax_params(emb, {"table": np.asarray(jt)})
    got = emb(torch.from_numpy(ids))
    (got.float() * torch.from_numpy(cot)).sum().backward()
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    grad = emb.leaf("table").grad
    assert grad.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(
        grad.float().numpy(),
        np.asarray(want_grad["table"].astype(jnp.float32)))


# ---------------------------------------------------------------------------
# dequantize-matmul


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("k", [12, 13])
@pytest.mark.parametrize("lead", [(5,), (2, 3)])
def test_dequant_matmul_matches_jax(bits, k, lead):
    rs = np.random.RandomState(bits * 100 + k)
    w = rs.randn(k, 9).astype(np.float32)
    x = rs.randn(*lead, k).astype(np.float32)
    q, s = jdq.quantize_weights(w, bits=bits)
    want = np.asarray(jdq.dequant_matmul(jnp.asarray(x), q, s, bits=bits,
                                         rows=k, interpret=True))
    tq, ts = torch.from_numpy(np.array(q)), torch.from_numpy(np.array(s))
    got = tdq.dequant_matmul(torch.from_numpy(x), tq, ts, bits=bits, rows=k)
    assert tuple(got.shape) == lead + (9,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    plain = tdq.dequant_matmul_reference(torch.from_numpy(x), tq, ts.reshape(-1),
                                         bits=bits, rows=k)
    np.testing.assert_allclose(plain.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_dequant_matmul_half_precision_matches_jax(bits, dtype):
    """bf16 and f16 x answer in x's type, as the JAX kernel does (it widens
    x to f32 in its body); the values within one rounding to that type
    (2^-7 or 2^-10 of |y|) of each other, the f32 sums differing in
    order."""
    rs = np.random.RandomState(bits + len(dtype))
    k = 13
    w = rs.randn(k, 9).astype(np.float32)
    x = rs.randn(2, 5, k).astype(np.float32)
    q, s = jdq.quantize_weights(w, bits=bits)
    want = jdq.dequant_matmul(jnp.asarray(x).astype(getattr(jnp, dtype)), q,
                              s, bits=bits, rows=k, interpret=True)
    assert str(want.dtype) == dtype
    want = np.asarray(want.astype(jnp.float32))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = tdq.dequant_matmul(xt, torch.from_numpy(np.array(q)),
                             torch.from_numpy(np.array(s)), bits=bits, rows=k)
    assert got.dtype == xt.dtype and tuple(got.shape) == (2, 5, 9)
    rtol = 2.0 ** -7 if dtype == "bfloat16" else 2.0 ** -10
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=1e-6)


@pytest.mark.parametrize("k", [6, 7])
def test_pack_int4_bit_identical(k):
    rs = np.random.RandomState(k)
    q4 = rs.randint(-8, 8, size=(k, 11)).astype(np.int8)
    want = np.asarray(jdq.pack_int4(jnp.asarray(q4)))
    got = tdq.pack_int4(torch.from_numpy(q4)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tdq.unpack_int4(torch.from_numpy(got), k).numpy(), q4)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_weights_bit_identical(bits):
    rs = np.random.RandomState(bits)
    w = (rs.randn(40, 40) * 0.3).astype(np.float32)
    w[:, 3] = 0.0                                  # an all-zero channel
    jq, js = jdq.quantize_weights(w, bits=bits)
    tq, ts = tdq.quantize_weights(torch.from_numpy(w), bits=bits)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("axis", [-1, 0])
def test_quantize_tensor_bit_identical(axis):
    w = np.random.RandomState(5).uniform(0, 0.05, (6041, 20)).astype(
        np.float32)
    jq, js = jax_qt(w, axis=axis)
    tq, ts = quantize_tensor(torch.from_numpy(w), axis=axis)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_pytree_bit_identical(bits):
    rs = np.random.RandomState(bits)
    tree = {"dense": {"kernel": rs.randn(40, 40).astype(np.float32),
                      "bias": rs.randn(40).astype(np.float32)},
            "odd": {"table": rs.randn(41, 30).astype(np.float32)},
            "vec": {"w": rs.randn(2048).astype(np.float32)},
            "ids": {"lut": np.arange(2048, dtype=np.int32)},
            "flat": {}}
    want = jax_qtree(tree, bits=bits)
    got = quantize_pytree(tree, bits=bits)
    assert set(got) == set(want)
    for lname, sub in want.items():
        assert set(got[lname]) == set(sub)
        for leaf, w in sub.items():
            g = got[lname][leaf]
            if isinstance(w, dict):
                assert set(g) == set(w), (lname, leaf)
                for k in w:
                    np.testing.assert_array_equal(np.asarray(g[k]),
                                                  np.asarray(w[k]))
            else:
                assert g is tree[lname][leaf]            # passed through
    # the round trip is within half a quantization step per channel
    back = dequantize_pytree(got)["dense"]["kernel"].numpy()
    step = got["dense"]["kernel"]["scale"].numpy()
    assert np.all(np.abs(back - tree["dense"]["kernel"]) <= step / 2 + 1e-6)


def test_dequant_matmul_bad_arguments_raise():
    x = torch.zeros(2, 4)
    q, s = tdq.quantize_weights(torch.zeros(4, 3))
    with pytest.raises(ValueError, match="bits"):
        tdq.dequant_matmul(x, q, s, bits=2)
    with pytest.raises(ValueError, match="weights must be"):
        tdq.quantize_weights(torch.zeros(4))


# ---------------------------------------------------------------------------
# dispatch


@pytest.mark.parametrize("device,knob,shapes_ok,force,want", [
    ("cpu", None, True, None, "reference"),
    ("cpu", "on", True, None, "reference"),
    ("cuda", None, True, None, "cuda"),
    ("cuda", "auto", True, None, "cuda"),
    ("cuda", "on", True, None, "cuda"),
    ("cuda", "off", True, None, "reference"),
    ("cuda", "off", False, None, "reference"),
    ("cpu", None, False, None, "reference"),
    ("cpu", "off", True, "cuda", "cuda"),
    ("cuda", None, True, "reference", "reference"),
])
def test_select_path_matrix(device, knob, shapes_ok, force, want):
    kernel = f"matrix_{device}_{knob}_{shapes_ok}_{force}"
    window = METRICS.snapshot()
    got = dispatch.select_path(kernel, device=torch.device(device),
                               shapes_ok=shapes_ok, knob=knob, force=force)
    assert got == want
    assert _selected(window) == {(kernel, want): 1}


def test_select_path_rejects_unknown_force():
    with pytest.raises(ValueError, match="unknown kernel path"):
        dispatch.select_path("x", device=torch.device("cpu"), force="pallas")
    with pytest.raises(ValueError, match="unknown kernel path"):
        with dispatch.forced("pallas"):
            pass


def test_select_path_raises_for_bad_shapes_on_cuda():
    """Shapes a kernel cannot take never send a CUDA tensor to the plain
    version: the call raises, naming the kernel and the shape, and no
    routing is counted."""
    window = METRICS.snapshot()
    with pytest.raises(ValueError, match=r"dequant_matmul CUDA kernel "
                                         r"cannot take q \(2, 3, 4\)"):
        dispatch.select_path("dequant_matmul", device=torch.device("cuda"),
                             shapes_ok=False, shape="q (2, 3, 4)")
    assert _selected(window) == {}


def test_forced_routes_every_call_for_the_block_only():
    cuda = torch.device("cuda")
    assert dispatch.select_path("forced_probe", device=cuda) == "cuda"
    with dispatch.forced("reference"):
        assert dispatch.select_path("forced_probe", device=cuda) == "reference"
        # a bad shape inside the block takes the forced path, as force does
        assert dispatch.select_path("forced_probe", device=cuda,
                                    shapes_ok=False) == "reference"
        with dispatch.forced("cuda"):
            assert dispatch.select_path("forced_probe",
                                        device=torch.device("cpu")) == "cuda"
        assert dispatch.select_path("forced_probe", device=cuda) == "reference"
    assert dispatch.select_path("forced_probe", device=cuda) == "cuda"


def test_wrappers_count_cpu_routing_and_no_launch():
    """On CPU tensors both wrappers take the plain version: routing is
    counted under path=reference and no kernel launch is counted."""
    window = METRICS.snapshot()
    l0, m0 = teb.LAUNCHES.value, tdq.LAUNCHES.value
    teb.embedding_bag(torch.zeros(3, 2), torch.zeros((1, 1), dtype=torch.int32))
    teb.embedding_gather(torch.zeros(3, 2), torch.zeros(4, dtype=torch.int32))
    q, s = tdq.quantize_weights(torch.ones(4, 2))
    tdq.dequant_matmul(torch.ones(1, 4), q, s)
    assert _selected(window) == {("embedding_bag", "reference"): 1,
                                 ("embedding_gather", "reference"): 1,
                                 ("dequant_matmul", "reference"): 1}
    assert (teb.LAUNCHES.value, tdq.LAUNCHES.value) == (l0, m0)


def test_launch_refuses_cpu_tensors():
    """The kernel wrappers launch on CUDA tensors or raise — there is no
    quiet route to the plain version."""
    with pytest.raises(ValueError, match="CUDA device"):
        teb._launch(torch.zeros(3, 2), torch.zeros((1, 1), dtype=torch.int32),
                    "sum", None)
    q, s = tdq.quantize_weights(torch.ones(4, 2))
    with pytest.raises(ValueError, match="CUDA device"):
        tdq._launch(torch.ones(1, 4), q, s, 8)


def test_build_without_nvcc_names_the_kernels(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="embedding_bag"):
        _build.build()


def test_build_target_is_keyed_by_source():
    a, b = _build.target("embedding_bag"), _build.target("dequant_matmul")
    assert a != b and a.parent == b.parent == _build.BUILD_DIR
    assert a == _build.target("embedding_bag")
    with pytest.raises(ValueError, match="unknown kernel"):
        _build.target("flash")


def test_build_target_is_keyed_by_headers(monkeypatch, tmp_path):
    """Editing a header in ``csrc/`` (a copy) changes the library path of
    every kernel, so no stale library built from the old header loads;
    editing one source changes only its own."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    assert list(csrc.glob("*.cuh"))
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.target(n) for n in _build.KERNELS}
    header = csrc / "mma_tiles.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.target(n) for n in _build.KERNELS}
    assert all(before[n] != after[n] for n in _build.KERNELS)
    src = csrc / "flash_attention.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    again = {n: _build.target(n) for n in _build.KERNELS}
    assert again["flash_attention"] != after["flash_attention"]
    assert all(again[n] == after[n] for n in _build.KERNELS
               if n != "flash_attention")


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    """A compiler that exits non-zero fails the build, naming the kernel
    and carrying its output."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: bad kernel' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}/usr/bin:/bin")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="(?s)dequant_matmul .*bad kernel"):
        _build.build(["dequant_matmul"])
    assert not list((tmp_path / "build").glob("*.so"))


def test_csrc_targets_sm90a():
    for name in _build.KERNELS:
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert "extern \"C\"" in src and "cudaGetLastError" in src
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
