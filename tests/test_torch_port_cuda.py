"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips without a CUDA
device.  The file imports no JAX, so on the GPU machine (which has none)
it runs without the JAX package's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.ops import _build
from analytics_zoo_tpu_torch.ops import dequant_matmul as tdq
from analytics_zoo_tpu_torch.ops import embedding_bag as teb

RTOL = 1e-5


@pytest.fixture
def cuda_device():
    """The card, built kernels included; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bag_inputs(v, d, b, n, pad_id, seed):
    rs = np.random.RandomState(seed)
    table = rs.randn(v, d).astype(np.float32)
    ids = rs.randint(0, v, size=(b, n)).astype(np.int32)
    if pad_id is not None:
        ids[rs.rand(b, n) < 0.3] = pad_id
        ids[0, :] = pad_id                        # one all-pad bag
    return table, ids



@pytest.mark.cuda
@pytest.mark.parametrize("combiner", teb.COMBINERS)
@pytest.mark.parametrize("pad_id", [0, None])
def test_bag_kernel_matches_plain_on_card(cuda_device, combiner, pad_id):
    table, ids = _bag_inputs(6041, 20, 257, 3, pad_id, seed=1)
    ids[1, 0], ids[2, 1] = -7, 10 ** 6                 # the clip rule
    t = torch.from_numpy(table).to(cuda_device)
    i = torch.from_numpy(ids).to(cuda_device)
    n0 = teb.LAUNCHES.value
    got = teb.embedding_bag(t, i, combiner, pad_id)
    torch.cuda.synchronize()
    assert teb.LAUNCHES.value == n0 + 1
    want = teb.embedding_bag_reference(t, i, combiner, pad_id)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m,k,n", [(1, 40, 40), (65, 41, 70)])
def test_dq_kernel_matches_plain_on_card(cuda_device, bits, m, k, n):
    rs = np.random.RandomState(m + k)
    q, s = tdq.quantize_weights(torch.from_numpy(
        rs.randn(k, n).astype(np.float32)), bits=bits)
    x = torch.from_numpy(rs.randn(m, k).astype(np.float32)).to(cuda_device)
    q, s = q.to(cuda_device), s.to(cuda_device)
    n0 = tdq.LAUNCHES.value
    got = tdq.dequant_matmul(x, q, s, bits=bits, rows=k)
    torch.cuda.synchronize()
    assert tdq.LAUNCHES.value == n0 + 1
    want = tdq.dequant_matmul_reference(x, q, s, bits=bits, rows=k)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=1e-4)


def _dq_inputs(device, m, k, n, bits, dtype, seed):
    rs = np.random.RandomState(seed)
    q, s = tdq.quantize_weights(torch.from_numpy(
        rs.randn(k, n).astype(np.float32)), bits=bits)
    x = torch.from_numpy(rs.randn(m, k).astype(np.float32)).to(device)
    return x.to(dtype), q.to(device), s.to(device)


def _check_dq(got, want):
    """Half precision: one rounding of an f32 result to x's type (2^-7 of
    |y| in bf16, 2^-10 in f16) on top of f32 sums in another order; f32
    and f64: the chip's max |err| <= 1e-4 * max |plain|."""
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.double(), want.double()
    top = float(w.abs().max())
    if got.dtype in (torch.bfloat16, torch.float16):
        rtol = 2.0 ** -7 if got.dtype == torch.bfloat16 else 2.0 ** -10
        assert bool(torch.all((g - w).abs() <= rtol * w.abs() + 1e-5 * top))
    else:
        assert float((g - w).abs().max()) <= 1e-4 * top


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float64])
@pytest.mark.parametrize("m,k,n", [(65, 41, 70), (300, 256, 200)])
def test_dq_kernel_takes_every_float_type_on_card(cuda_device, bits, dtype,
                                                  m, k, n):
    """bf16, f16 and f64 x launch the kernel once and answer in x's type
    (f64 through f32, as the JAX kernel widens x to f32)."""
    x, q, s = _dq_inputs(cuda_device, m, k, n, bits, dtype, seed=m + bits)
    n0 = tdq.LAUNCHES.value
    got = tdq.dequant_matmul(x, q, s, bits=bits, rows=k)
    torch.cuda.synchronize()
    assert tdq.LAUNCHES.value == n0 + 1
    _check_dq(got, tdq.dequant_matmul_reference(x, q, s, bits=bits, rows=k))


@pytest.mark.cuda
def test_dq_kernel_takes_rows_past_the_old_grid_limit_on_card(cuda_device):
    """M = 4,194,305 needs 65,537 tiles of 64 rows: more than a grid's y
    dimension holds."""
    x, q, s = _dq_inputs(cuda_device, 4194305, 40, 40, 8, torch.float32, 3)
    n0 = tdq.LAUNCHES.value
    got = tdq.dequant_matmul(x, q, s, bits=8, rows=40)
    torch.cuda.synchronize()
    assert tdq.LAUNCHES.value == n0 + 1
    _check_dq(got, tdq.dequant_matmul_reference(x, q, s, bits=8, rows=40))
    del x, got
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
def test_dq_kernel_at_a_bert_base_dense_on_card(cuda_device, bits):
    """BERT-Base's intermediate Dense, 768 -> 3072, at M = B L = 4096."""
    x, q, s = _dq_inputs(cuda_device, 4096, 768, 3072, bits, torch.float32,
                         seed=bits)
    got = tdq.dequant_matmul(x, q, s, bits=bits, rows=768)
    torch.cuda.synchronize()
    _check_dq(got, tdq.dequant_matmul_reference(x, q, s, bits=bits,
                                                 rows=768))


@pytest.mark.cuda
def test_wrappers_raise_for_shapes_the_kernels_cannot_take(cuda_device):
    """A CUDA tensor the kernel cannot take raises; it is never answered
    by the plain version on the card."""
    x = torch.ones(2, 4, device=cuda_device)
    q = torch.ones(3, 4, 5, dtype=torch.int8, device=cuda_device)
    s = torch.ones(5, device=cuda_device)
    n0 = tdq.LAUNCHES.value
    with pytest.raises(ValueError, match=r"dequant_matmul .*\(3, 4, 5\)"):
        tdq.dequant_matmul(x, q, s)
    assert tdq.LAUNCHES.value == n0
    ids = torch.zeros((2, 1), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match=r"embedding_bag .*\(0, 4\)"):
        teb.embedding_bag(torch.ones(0, 4, device=cuda_device), ids)


@pytest.mark.cuda
@pytest.mark.parametrize("weight_dtype", ["float32", "int8", "int4"])
def test_ncf_serving_on_card_matches_cpu(cuda_device, weight_dtype):
    """NeuralCF served on the card (through both kernels) answers as the
    same weights served on the CPU (through the plain versions)."""
    from analytics_zoo_tpu_torch.deploy import InferenceModel
    from analytics_zoo_tpu_torch.models import NeuralCF

    ncf = NeuralCF(200, 150, user_embed=16, item_embed=16, mf_embed=16,
                   hidden_layers=(64, 16), device="cpu")
    rs = np.random.RandomState(0)
    params = {layer: {leaf: (rs.randn(*v.shape) * 0.5).astype(np.float32)
                      for leaf, v in sub.items()}
              for layer, sub in ncf.model.params().items()}
    u = rs.randint(1, 201, (70, 1)).astype(np.int32)
    i = rs.randint(1, 151, (70, 1)).astype(np.int32)
    cpu = InferenceModel.from_keras_net(ncf.model, params, device="cpu",
                                        weight_dtype=weight_dtype)
    card = InferenceModel.from_keras_net(ncf.model, params,
                                         device=cuda_device,
                                         weight_dtype=weight_dtype)
    b0, d0 = teb.LAUNCHES.value, tdq.LAUNCHES.value
    got = card.predict([u, i])
    # 70 rows pad to the 256-row bucket: one forward, four tables, and
    # two Dense kernels (32x64, 64x16) at quantize_pytree's 1024 floor
    assert teb.LAUNCHES.value - b0 == 4
    assert tdq.LAUNCHES.value - d0 == (0 if weight_dtype == "float32"
                                       else 2)
    np.testing.assert_allclose(got, cpu.predict([u, i]), rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("combiner", teb.COMBINERS)
@pytest.mark.parametrize("pad_id", [0, None])
def test_bag_backward_kernel_matches_plain_on_card(cuda_device, combiner,
                                                   pad_id):
    """The backward kernel against the plain backward: duplicates within
    and across bags, the clip rule, an all-pad bag.  The kernel sums the
    duplicates in another fixed order than ``index_add_``: rtol 1e-5,
    atol 1e-6."""
    _, ids = _bag_inputs(6041, 20, 515, 4, pad_id, seed=2)
    ids[1, :] = 7
    ids[2:40, 0] = 7
    ids[3, 1], ids[4, 2] = -7, 10 ** 6
    rs = np.random.RandomState(3)
    g = torch.from_numpy(rs.randn(515, 20).astype(np.float32)).to(cuda_device)
    i = torch.from_numpy(ids).to(cuda_device)
    n0 = teb.BWD_LAUNCHES.value
    got = teb.embedding_bag_backward(6041, i, g, combiner, pad_id)
    torch.cuda.synchronize()
    assert teb.BWD_LAUNCHES.value == n0 + 1
    want = teb.embedding_bag_backward_reference(6041, i, g, combiner, pad_id)
    # rtol against the summed magnitude of each element's contributions
    # (|dT| itself where a row gets one add): the order of adds differs
    mass = teb.embedding_bag_backward_reference(6041, i, g.abs(), combiner,
                                                pad_id)
    assert bool(((got - want).abs() <= 1e-6 + RTOL * mass).all())
    empty = teb.embedding_bag_backward(6041, i[:0], g[:0], combiner, pad_id)
    assert teb.BWD_LAUNCHES.value == n0 + 1 and not empty.any()


def _replayed(fn):
    """``fn()``'s result from one replay of a CUDA graph that captured it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return out


def _front_padded_ids(docs, length, vocab, seed):
    """(docs * length, 1) ids of documents of 100 .. length Zipf words,
    front-padded with id 0 (``TextSet.shape_sequence``'s rule), as the
    TextClassifier's gather flattens them."""
    rs = np.random.RandomState(seed)
    ids = np.zeros((docs, length), np.int32)
    for d in range(docs):
        n = rs.randint(100, length + 1)
        ids[d, length - n:] = 1 + (rs.zipf(1.2, n) - 1) % (vocab - 1)
    return ids.reshape(-1, 1)


def _routes(vocab, dim, bags, nnz):
    """The backward's ways that take this shape: the tile way where it
    fits, and the lists way with and without owned rows."""
    tile = teb.bag_bwd_plan(vocab, dim, bags, nnz).route == "tile"
    return (["tile"] if tile else []) + ["lists", "owned"]


def _check_deterministic(vocab, ids, g, combiner, pad_id, routes):
    """Each route: two calls and a graph replay give the same bits, within
    1e-6 + 1e-5 of the summed magnitude of the plain version.  Returns
    the first route's gradient."""
    want = teb.embedding_bag_backward_reference(vocab, ids, g, combiner,
                                                pad_id)
    mass = teb.embedding_bag_backward_reference(vocab, ids, g.abs(),
                                                combiner, pad_id)
    first = None
    for route in routes:
        def call(route=route):
            return teb._launch_bwd(vocab, ids, g, combiner, pad_id, route)
        got = call()
        assert torch.equal(call(), got), route
        assert torch.equal(_replayed(call), got), route
        assert bool(((got - want).abs() <= 1e-6 + RTOL * mass).all()), route
        first = got if first is None else first
    return first


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["text_front_padded", "one_row",
                                  "all_pad"])
def test_bag_backward_is_deterministic_on_card(cuda_device, case):
    """The backward's bits depend on its inputs alone: two calls, and a
    CUDA graph's replay against the eager call, at the TextClassifier's
    front-padded shape (64,000 gathers into a (5001, 200) table, about
    40% of them into row 0), with 65,536 ids all 7 (one row takes every
    slot), and on an all-pad batch with ``pad_id=0`` (a zero gradient)."""
    rs = np.random.RandomState(11)
    if case == "text_front_padded":
        vocab, dim, combiner, pad_id = 5001, 200, "sum", None
        ids = _front_padded_ids(128, 500, vocab, 12)
    elif case == "one_row":
        vocab, dim, combiner, pad_id = 5001, 20, "sum", None
        ids = np.full((65536, 1), 7, np.int32)
    else:
        vocab, dim, combiner, pad_id = 6041, 20, "mean", 0
        ids = np.zeros((515, 4), np.int32)
    i = torch.from_numpy(ids).to(cuda_device)
    g = torch.from_numpy(rs.randn(len(ids), dim).astype(np.float32)).to(
        cuda_device)
    got = _check_deterministic(vocab, i, g, combiner, pad_id,
                               _routes(vocab, dim, *ids.shape))
    if case == "all_pad":
        assert not got.any()
    if case == "one_row":
        assert not torch.cat([got[:7], got[8:]]).any()


@pytest.mark.cuda
@pytest.mark.parametrize("combiner", teb.COMBINERS)
@pytest.mark.parametrize("pad_id", [0, None])
def test_bag_backward_routes_are_deterministic_on_card(cuda_device,
                                                        combiner, pad_id):
    """The tile and lists ways of the backward (with and without owned
    rows), each deterministic and within tolerance at one shape, with
    clipped ids -7 and 10^6 and an all-pad bag among the slots."""
    _, ids = _bag_inputs(6041, 20, 515, 4, pad_id, seed=6)
    ids[1, :] = 7
    ids[2:40, 0] = 7
    ids[3, 1], ids[4, 2] = -7, 10 ** 6
    rs = np.random.RandomState(7)
    g = torch.from_numpy(rs.randn(515, 20).astype(np.float32)).to(cuda_device)
    i = torch.from_numpy(ids).to(cuda_device)
    assert teb.bag_bwd_plan(6041, 20, 515, 4).route == "tile"
    _check_deterministic(6041, i, g, combiner, pad_id,
                         ["tile", "lists", "owned"])


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [1, 2, 20, 200])
@pytest.mark.parametrize("bags,nnz", [(1000, 3), (40000, 1)])
def test_bag_backward_widths_and_ragged_chunks_on_card(cuda_device, dim,
                                                       bags, nnz):
    """Row widths of 1, 2, 20 and 200 floats (one, two and four columns a
    lane), and slot counts that are no multiple of the 256-slot chunk
    (3,000 through both ways where the row fits the tile way; 40,000
    through the lists way), Zipf ids with a pad id, the mean combiner."""
    rs = np.random.RandomState(dim + bags)
    vocab = 3001
    ids = ((rs.zipf(1.3, (bags, nnz)) - 1) % vocab).astype(np.int32)
    ids[rs.rand(bags, nnz) < 0.2] = 3
    i = torch.from_numpy(ids).to(cuda_device)
    g = torch.from_numpy(rs.randn(bags, dim).astype(np.float32)).to(
        cuda_device)
    _check_deterministic(vocab, i, g, "mean", 3,
                         _routes(vocab, dim, bags, nnz))


@pytest.mark.cuda
def test_gradient_through_the_function_on_card(cuda_device):
    """Autograd through the bag and the gather on the card (both kernels)
    equals the same graph under ``forced("reference")``."""
    from analytics_zoo_tpu_torch.ops import dispatch

    table, ids = _bag_inputs(3707, 20, 300, 3, 0, seed=4)
    t = torch.from_numpy(table).to(cuda_device)
    i = torch.from_numpy(ids).to(cuda_device)
    cot = torch.randn(300, 20, device=cuda_device)

    def grad():
        leaf = t.clone().requires_grad_(True)
        out = (teb.embedding_bag(leaf, i, "mean", 0) * cot).sum() \
            + teb.embedding_gather(leaf, i[:, :1]).square().sum()
        out.backward()
        return leaf.grad

    b0, f0 = teb.BWD_LAUNCHES.value, teb.LAUNCHES.value
    got = grad()
    assert (teb.LAUNCHES.value - f0, teb.BWD_LAUNCHES.value - b0) == (2, 2)
    with dispatch.forced(dispatch.PATH_REFERENCE):
        want = grad()
    assert teb.BWD_LAUNCHES.value - b0 == 2
    torch.testing.assert_close(got, want, rtol=RTOL, atol=1e-5)


@pytest.mark.cuda
def test_ncf_fit_on_card_matches_plain_path(cuda_device):
    """A few NCF steps on the card change all four tables (the gradients
    reach them through the backward kernel) and agree with the same steps
    through the plain versions on the card: losses within rtol 1e-4, and
    one step's weights within atol 1e-6.  Weights after many steps are
    not compared: duplicate ids add in a free atomic order on both paths,
    and Adam can grow those last-bit differences on a few elements."""
    from analytics_zoo_tpu_torch.convert import export_params, load_jax_params
    from analytics_zoo_tpu_torch.models import NeuralCF
    from analytics_zoo_tpu_torch.nn import reset_name_scope
    from analytics_zoo_tpu_torch.ops import dispatch

    rs = np.random.RandomState(0)
    u = rs.randint(1, 201, (512, 1)).astype(np.int32)
    i = rs.randint(1, 151, (512, 1)).astype(np.int32)
    y = rs.randint(0, 5, 512).astype(np.int32)
    params = None

    def run(rows=512, epochs=2):
        nonlocal params
        reset_name_scope()
        ncf = NeuralCF(200, 150, device=cuda_device)
        if params is None:
            params = export_params(ncf.model)
        load_jax_params(ncf.model, params)
        ncf.compile("adam", "sparse_categorical_crossentropy")
        hist = ncf.fit([u[:rows], i[:rows]], y[:rows], batch_size=128,
                       epochs=epochs, verbose=False)
        return [h["loss"] for h in hist], export_params(ncf.model)

    b0 = teb.BWD_LAUNCHES.value
    loss, trained = run()
    assert teb.BWD_LAUNCHES.value - b0 == 4 * 8          # 4 tables x 8 steps
    for name in ("mlp_user_embed", "mlp_item_embed", "mf_user_embed",
                 "mf_item_embed"):
        assert not np.array_equal(trained[name]["table"],
                                  params[name]["table"]), name
    _, one = run(rows=128, epochs=1)
    with dispatch.forced(dispatch.PATH_REFERENCE):
        ref_loss, _ = run()
        _, ref_one = run(rows=128, epochs=1)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-4)
    for layer, leaves in ref_one.items():
        for leaf, w in leaves.items():
            np.testing.assert_allclose(one[layer][leaf], w, rtol=0,
                                       atol=1e-6)


# ---------------------------------------------------------------------------
# the bag forward's table types, piece widths and grid


HALF_RTOL = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}


def _check_bag(table, ids, combiner, pad_id):
    """One launch of the bag forward kernel, held to its plain version:
    f32 rtol 1e-5 / atol 1e-5; bf16 and f16 one rounding of an f32 sum
    into the table's type (2^-7 or 2^-10 of |plain|) plus 1e-5 of the
    summed magnitude of the terms; f64 1e-12 of that magnitude."""
    n0 = teb.LAUNCHES.value
    got = teb.embedding_bag(table, ids, combiner, pad_id)
    torch.cuda.synchronize()
    assert teb.LAUNCHES.value == n0 + 1
    want = teb.embedding_bag_reference(table, ids, combiner, pad_id)
    assert got.dtype == want.dtype == table.dtype
    if table.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=RTOL, atol=1e-5)
        return got
    terms = teb.embedding_bag_reference(table.double().abs(), ids, combiner,
                                        pad_id)
    err = (got.double() - want.double()).abs()
    if table.dtype == torch.float64:
        assert bool((err <= 1e-12 * terms).all())
    else:
        assert bool((err <= HALF_RTOL[table.dtype] * want.double().abs()
                     + 1e-5 * terms).all())
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float64])
@pytest.mark.parametrize("combiner,pad_id,dim,nnz", [
    ("sum", None, 64, 32), ("mean", 0, 20, 1), ("sqrtn", 0, 72, 33)])
def test_bag_kernel_takes_every_float_table_on_card(cuda_device, dtype,
                                                    combiner, pad_id, dim,
                                                    nnz):
    """bf16, f16 and f64 tables launch the kernel once and answer in the
    table's type; out-of-range ids clip."""
    table, ids = _bag_inputs(6041, dim, 300, nnz, pad_id, seed=dim + nnz)
    ids[1, 0], ids[2, -1] = -7, 10 ** 6
    _check_bag(torch.from_numpy(table).to(cuda_device, dtype),
               torch.from_numpy(ids).to(cuda_device), combiner, pad_id)


@pytest.mark.cuda
def test_half_precision_tables_no_longer_raise_on_card(cuda_device):
    """The fault repaired: ``Embedding(dtype=bf16 / f16)`` and a bf16
    ``EmbeddingBag`` on the card raised TypeError in the bag wrapper; they
    now launch the kernel and answer in the table's type."""
    from analytics_zoo_tpu_torch.nn.layers import Embedding, EmbeddingBag

    ids = torch.randint(0, 100, (16, 4), device=cuda_device)
    for dtype in (torch.bfloat16, torch.float16):
        emb = Embedding(100, 24, dtype=dtype)
        emb.build(torch.Generator().manual_seed(0), (16, 4))
        emb.to(cuda_device)
        n0 = teb.LAUNCHES.value
        out = emb(ids)
        torch.cuda.synchronize()
        assert teb.LAUNCHES.value == n0 + 1
        assert out.dtype == dtype and tuple(out.shape) == (16, 4, 24)
        torch.testing.assert_close(
            out, emb.leaf("table").detach()[ids.long()], rtol=0, atol=0)
    bag = EmbeddingBag(100, 24, combiner="mean", pad_id=0)
    bag.build(torch.Generator().manual_seed(0), (16, 4))
    bag.set_leaf("table", bag.leaf("table").detach().to(torch.bfloat16))
    bag.to(cuda_device)
    n0 = teb.LAUNCHES.value
    out = bag(ids)
    torch.cuda.synchronize()
    assert teb.LAUNCHES.value == n0 + 1 and out.dtype == torch.bfloat16


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_half_precision_table_gradient_on_card(cuda_device, dtype):
    """A bf16 (f16) table's gradient through ``_Bag``: the bf16 output's
    gradient widened to f32 for the backward kernel, its f32 result cast
    to the table's type; against the same graph under
    ``forced("reference")`` (both round the same f32 sums once, up to
    the atomics' order: one unit of the table's type)."""
    from analytics_zoo_tpu_torch.ops import dispatch

    table, ids = _bag_inputs(3707, 20, 300, 3, 0, seed=6)
    t = torch.from_numpy(table).to(cuda_device, dtype)
    i = torch.from_numpy(ids).to(cuda_device)
    cot = torch.randn(300, 20, device=cuda_device)

    def grad():
        leaf = t.clone().requires_grad_(True)
        (teb.embedding_bag(leaf, i, "mean", 0).float() * cot).sum().backward()
        return leaf.grad

    f0, b0 = teb.LAUNCHES.value, teb.BWD_LAUNCHES.value
    got = grad()
    torch.cuda.synchronize()
    assert (teb.LAUNCHES.value - f0, teb.BWD_LAUNCHES.value - b0) == (1, 1)
    with dispatch.forced(dispatch.PATH_REFERENCE):
        want = grad()
    assert got.dtype == want.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=HALF_RTOL[dtype], atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,dim,offset", [
    (torch.float32, 5, 0),        # 20-byte rows: 4-byte pieces
    (torch.bfloat16, 3, 0),       # 6-byte rows: 2-byte pieces
    (torch.float32, 64, 1),       # rows on 4 bytes: a storage offset
    (torch.bfloat16, 64, 3),      # rows on 2 bytes
    (torch.float32, 130, 2),      # 65 pieces of 8 bytes: 3 column chunks
])
def test_bag_kernel_takes_rows_off_16_bytes_on_card(cuda_device, dtype,
                                                    dim, offset):
    """Rows whose byte width or address is off 16 bytes take narrower
    pieces (``piece_bytes``) and still match the plain version."""
    vocab = 2000
    buf = torch.randn(vocab * dim + offset, device=cuda_device).to(dtype)
    table = buf[offset:].view(vocab, dim)
    piece = teb.piece_bytes(table.element_size(), dim, table.data_ptr())
    assert piece < 16
    _, ids = _bag_inputs(vocab, dim, 129, 7, 0, seed=dim)
    for combiner in teb.COMBINERS:
        _check_bag(table, torch.from_numpy(ids).to(cuda_device), combiner, 0)


@pytest.mark.cuda
def test_bag_kernel_takes_257_slot_bags_on_card(cuda_device):
    """Bags of N = 257 slots: nine id windows, the last of one slot."""
    table, ids = _bag_inputs(6041, 64, 130, 257, 0, seed=9)
    for dtype in (torch.float32, torch.bfloat16):
        _check_bag(torch.from_numpy(table).to(cuda_device, dtype),
                   torch.from_numpy(ids).to(cuda_device), "mean", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("nnz,dim", [(1, 20), (32, 64)])
def test_bag_kernel_takes_bags_past_one_wave_on_card(cuda_device, nnz, dim):
    """2^17 + 5 bags: more warps than the card holds at once, and a last
    block and round that are part full."""
    g = torch.Generator(device=cuda_device).manual_seed(nnz)
    table = torch.randn(1 << 16, dim, device=cuda_device, generator=g)
    ids = torch.randint(0, 1 << 16, ((1 << 17) + 5, nnz), device=cuda_device,
                        generator=g, dtype=torch.int32)
    _check_bag(table, ids, "sum", None)


# ---------------------------------------------------------------------------
# flash attention


FLASH_CASES = [
    # (b, h, lq, lk, d, causal, dtype, offset); offset 1: q, k, v are
    # x[..., 1:d + 1] of a (B, L, H, d + 1) buffer seen as (B, H, L, d),
    # rows that do not start on 16 bytes
    (2, 12, 128, 128, 64, False, torch.float32, 0),     # BERT-Base heads
    (1, 4, 512, 512, 64, False, torch.float32, 0),
    (1, 2, 77, 77, 64, True, torch.float32, 0),         # ragged tiles
    (1, 2, 128, 384, 64, True, torch.float32, 0),       # causal Lq < Lk
    (1, 2, 200, 72, 64, True, torch.float32, 0),        # causal Lq > Lk
    (1, 2, 256, 256, 128, True, torch.float32, 0),
    (2, 3, 33, 65, 24, False, torch.float32, 0),        # D < 64, not a power
    (2, 4, 256, 256, 64, False, torch.bfloat16, 0),
    (1, 2, 100, 130, 128, True, torch.bfloat16, 0),
    (2, 3, 97, 131, 64, True, torch.float32, 1),        # misaligned rows
    (2, 3, 97, 131, 64, False, torch.bfloat16, 1),
    (2, 3, 90, 70, 72, True, torch.bfloat16, 0),        # D = 72 in bf16
]


# The share of bf16 outputs that may differ from the plain version's bf16
# value: the kernel's p enters P.V as two bf16 terms, and p rounded once
# to bf16 moves many more outputs to a neighbouring value while keeping
# within the tolerance (on an H100: 0.13-0.25% against 26-39%)
BF16_MISMATCH_LIMIT = 0.02


def _check_bf16_split_p(got, want):
    if got.dtype == torch.bfloat16:
        assert float((got != want).float().mean()) <= BF16_MISMATCH_LIMIT


def _flash_inputs(device, b, h, lq, lk, d, dtype, seed, offset=0):
    g = torch.Generator(device=device).manual_seed(seed)
    if offset:
        return tuple(torch.randn(b, n, h, d + offset, device=device,
                                 generator=g).to(dtype)[..., offset:]
                     .transpose(1, 2) for n in (lq, lk, lk))
    return tuple(torch.randn(b, h, n, d, device=device, generator=g)
                 .to(dtype) for n in (lq, lk, lk))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,lq,lk,d,causal,dtype,offset", FLASH_CASES)
def test_flash_kernel_matches_plain_on_card(cuda_device, b, h, lq, lk, d,
                                            causal, dtype, offset):
    """The kernel against its plain version on the same inputs: f32 atol
    2e-5 + rtol 1e-4 (split-TF32 products and sums in another order);
    bf16 outputs differ by at most one bf16 rounding of an f32 result
    (atol 8e-3 + rtol 8e-3), and at most ``BF16_MISMATCH_LIMIT`` of them
    differ from the plain version's bf16 value.  Rows with no live key
    are exactly 0."""
    from analytics_zoo_tpu_torch.ops import flash_attention as tfa

    q, k, v = _flash_inputs(cuda_device, b, h, lq, lk, d, dtype, lq + lk,
                            offset)
    n0 = tfa.LAUNCHES.value
    got = tfa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES.value == n0 + 1 and got.dtype == dtype
    want = tfa.flash_attention_reference(q, k, v, causal=causal)
    tol = 8e-3 if dtype == torch.bfloat16 else None
    torch.testing.assert_close(got.float(), want.float(),
                               atol=tol or 2e-5, rtol=tol or 1e-4)
    _check_bf16_split_p(got, want)
    if causal and lq > lk:
        assert not got[:, :, :lq - lk].any()


@pytest.mark.cuda
def test_flash_kernel_takes_strided_heads_on_card(cuda_device):
    """q, k, v as the transposed head views MultiHeadAttention makes
    (D contiguous, other strides free): no copy, the same answer."""
    from analytics_zoo_tpu_torch.ops import flash_attention as tfa

    x = torch.randn(3, 97, 12 * 64, device=cuda_device)
    q = x.reshape(3, 97, 12, 64).transpose(1, 2)
    assert not q.is_contiguous()
    got = tfa.flash_attention(q, q, q)
    want = tfa.flash_attention_reference(q.contiguous(), q.contiguous(),
                                         q.contiguous())
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)


def _bwd_tol(dtype):
    """f32: atol 2e-5 + rtol 1e-4 (sums in another order); bf16 inputs
    run in f32 in both, so the gradients differ by at most one bf16
    rounding of an f32 result: atol 8e-3 + rtol 8e-3."""
    return (8e-3, 8e-3) if dtype == torch.bfloat16 else (2e-5, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,lq,lk,d,causal,dtype,offset", FLASH_CASES)
def test_flash_lse_kernel_matches_plain_on_card(cuda_device, b, h, lq, lk, d,
                                                causal, dtype, offset):
    """The lse kernel's (out, lse) against the plain version: out as the
    forward kernel's; lse f32 atol 2e-5 + rtol 1e-5 on rows with a live
    key, and -1e30 on rows with none."""
    from analytics_zoo_tpu_torch.ops import flash_attention as tfa

    q, k, v = _flash_inputs(cuda_device, b, h, lq, lk, d, dtype, lq + lk,
                            offset)
    n0 = tfa.LSE_LAUNCHES.value
    out, lse = tfa._launch(q, k, v, causal, d ** -0.5, with_lse=True)
    torch.cuda.synchronize()
    assert tfa.LSE_LAUNCHES.value == n0 + 1
    assert lse.dtype == torch.float32 and lse.shape == (b, h, lq)
    want, want_lse = tfa.flash_attention_lse_reference(q, k, v, causal)
    atol, rtol = _bwd_tol(dtype)
    torch.testing.assert_close(out.float(), want.float(), atol=atol,
                               rtol=rtol)
    _check_bf16_split_p(out, want)
    live = want_lse > -1e29
    torch.testing.assert_close(lse[live], want_lse.float()[live], atol=2e-5,
                               rtol=1e-5)
    assert bool((lse[~live] <= -1e29).all())


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,lq,lk,d,causal,dtype,offset", FLASH_CASES)
def test_flash_bwd_kernels_match_plain_on_card(cuda_device, b, h, lq, lk, d,
                                               causal, dtype, offset):
    """The dQ and dK/dV kernels against the plain backward on the same
    (q, k, v, out, lse, dO), with q, k, v as transposed head views and dO
    a non-contiguous view, at the forward's tolerances (bf16: at most
    ``BF16_MISMATCH_LIMIT`` of each gradient off the plain version's bf16
    value, split P and dS); two runs give the same bits (no atomics), and
    query rows with no live key get a zero dQ."""
    from analytics_zoo_tpu_torch.ops import flash_attention as tfa

    g = torch.Generator(device=cuda_device).manual_seed(lq * 3 + lk + d)

    def heads(n):
        x = torch.randn(b, n, h, d + offset, device=cuda_device, generator=g)
        return x.to(dtype)[..., offset:].transpose(1, 2)  # (b, h, n, d)

    q, k, v = heads(lq), heads(lk), heads(lk)
    do = torch.randn(b, h, d, lq, device=cuda_device,
                     generator=g).to(dtype).transpose(2, 3)
    assert not q.is_contiguous() and do.stride(-1) != 1
    out, lse = tfa._launch(q, k, v, causal, d ** -0.5, with_lse=True)
    n0 = (tfa.BWD_DQ_LAUNCHES.value, tfa.BWD_DKV_LAUNCHES.value)
    got = tfa.flash_attention_bwd(q, k, v, out, lse, do, causal)
    again = tfa.flash_attention_bwd(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    assert (tfa.BWD_DQ_LAUNCHES.value - n0[0],
            tfa.BWD_DKV_LAUNCHES.value - n0[1]) == (2, 2)
    want = tfa.flash_attention_bwd_reference(q, k, v, out, lse, do, causal)
    atol, rtol = _bwd_tol(dtype)
    for x, y, z in zip(got, again, want):
        assert x.dtype == dtype and x.is_contiguous()
        assert torch.equal(x, y)
        torch.testing.assert_close(x.float(), z.float(), atol=atol,
                                   rtol=rtol)
        _check_bf16_split_p(x, z)
    if causal and lq > lk:
        assert not got[0][:, :, :lq - lk].any()


@pytest.mark.cuda
def test_flash_function_trains_through_the_kernels_on_card(cuda_device):
    """A loss through ``flash_attention`` on the card launches the lse
    kernel, then the dQ and dK/dV kernels (a stride-0 gradient from
    ``sum``), and its gradient equals the same graph under
    ``forced("reference")``; without grad the forward kernel runs and
    the output carries no graph."""
    from analytics_zoo_tpu_torch.ops import dispatch
    from analytics_zoo_tpu_torch.ops import flash_attention as tfa

    counts = (tfa.LAUNCHES, tfa.LSE_LAUNCHES, tfa.BWD_DQ_LAUNCHES,
              tfa.BWD_DKV_LAUNCHES)

    def grads():
        xs = [t.clone().requires_grad_(True) for t in _flash_inputs(
            cuda_device, 2, 3, 97, 131, 64, torch.float32, 0)]
        tfa.flash_attention(*xs, causal=True).sum().backward()
        return [x.grad for x in xs]

    n0 = [c.value for c in counts]
    got = grads()
    torch.cuda.synchronize()
    assert [c.value - n for c, n in zip(counts, n0)] == [0, 1, 1, 1]
    with dispatch.forced(dispatch.PATH_REFERENCE):
        want = grads()
    assert [c.value - n for c, n in zip(counts, n0)] == [0, 1, 1, 1]
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, atol=2e-5, rtol=1e-4)
    q, k, v = (t.requires_grad_(True) for t in _flash_inputs(
        cuda_device, 1, 2, 64, 64, 32, torch.float32, 1))
    with torch.inference_mode():
        assert tfa.flash_attention(q, k, v).grad_fn is None
    assert [c.value - n for c, n in zip(counts, n0)] == [1, 1, 1, 1]


@pytest.mark.cuda
def test_flash_rejects_what_the_kernel_cannot_take(cuda_device):
    from analytics_zoo_tpu_torch.ops import flash_attention as tfa

    n0 = tfa.LAUNCHES.value
    for d, dtype in ((160, torch.float32), (64, torch.float16)):
        q = torch.zeros(1, 1, 8, d, device=cuda_device, dtype=dtype)
        with pytest.raises(ValueError, match="flash_attention CUDA kernel"):
            tfa.flash_attention(q, q, q)
    assert tfa.LAUNCHES.value == n0


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype", [(160, torch.float32),
                                     (256, torch.float32),
                                     (64, torch.float16)])
def test_router_answers_what_the_kernel_cannot_take_on_card(cuda_device, d,
                                                            dtype):
    """``dot_product_attention`` on a head width or dtype the flash kernel
    cannot take answers on the card by the JAX package's other route, as
    the JAX router does: it equals ``reference_attention`` on the same
    tensors (atol 2e-5 + rtol 1e-4), counts one flash_attention/reference
    selection and launches no flash kernel, while ``flash_attention``
    itself still raises there."""
    from analytics_zoo_tpu_torch.observe.metrics import METRICS
    from analytics_zoo_tpu_torch.ops import attention as tops
    from analytics_zoo_tpu_torch.ops import flash_attention as tfa

    g = torch.Generator(device=cuda_device).manual_seed(d)
    q, k, v = (torch.randn(2, 3, n, d, device=cuda_device, generator=g)
               .to(dtype) for n in (40, 56, 56))
    counts = (tfa.LAUNCHES, tfa.LSE_LAUNCHES, tfa.BWD_DQ_LAUNCHES,
              tfa.BWD_DKV_LAUNCHES)
    n0 = [c.value for c in counts]
    window = METRICS.snapshot()
    got = tops.dot_product_attention(q, k, v, causal=True)
    selected = {key: n for key, n in METRICS.delta(window)["counters"].items()
                if key.startswith("ops_kernel_selected_total{")}
    assert selected == {'ops_kernel_selected_total{kernel="flash_attention",'
                        'path="reference"}': 1}
    want = tops.reference_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.device == q.device
    torch.testing.assert_close(got.float(), want.float(), atol=2e-5,
                               rtol=1e-4)
    with pytest.raises(ValueError, match="flash_attention CUDA kernel"):
        tfa.flash_attention(q, k, v)
    assert [c.value for c in counts] == n0
    del q, k, v, got, want
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_multihead_attention_wider_than_the_kernel_on_card(cuda_device):
    """MultiHeadAttention(nhead=2, hidden_size=512), head width 256, runs a
    forward on the card (the reference route) and answers as the same
    weights on the CPU (atol 1e-4)."""
    from analytics_zoo_tpu_torch.nn.layers.attention import MultiHeadAttention
    from analytics_zoo_tpu_torch.ops import flash_attention as tfa

    mha = MultiHeadAttention(2, 512, name="mha_wide")
    mha.build(torch.Generator().manual_seed(0), (2, 24, 512))
    mha.eval()
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 24, 512)
                         .astype(np.float32))
    with torch.no_grad():
        want = mha(x)
        n0 = tfa.LAUNCHES.value
        got = mha.to(cuda_device)(x.to(cuda_device))
    torch.cuda.synchronize()
    assert got.shape == (2, 24, 512) and tfa.LAUNCHES.value == n0
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=1e-4)
    del mha, got
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_bag_backward_takes_a_table_past_2_31_elements_on_card(cuda_device):
    """The backward kernel on a (2^25 + 3, 64) table, V * D just past 2^31
    (an 8 GiB gradient): one launch, and the plain version's gradient on
    every touched row -- row 0, row V - 1 and the first rows past 2^31
    elements among them -- and in the sum of the whole gradient; every
    other row stays 0; a second call gives the same bits."""
    vocab, dim = (1 << 25) + 3, 64
    rs = np.random.RandomState(5)
    ids = rs.randint(0, vocab, (256, 8)).astype(np.int32)
    past = -(-(1 << 31) // dim)                    # first row at 2^31
    ids[0, :4] = (0, vocab - 1, past, past + 1)
    ids[1, :2] = (vocab - 1, past)                 # duplicates across bags
    i = torch.from_numpy(ids).to(cuda_device)
    g = torch.from_numpy(rs.randn(256, dim).astype(np.float32)).to(
        cuda_device)
    n0 = teb.BWD_LAUNCHES.value
    got = teb.embedding_bag_backward(vocab, i, g, "mean", None)
    torch.cuda.synchronize()
    assert teb.BWD_LAUNCHES.value == n0 + 1
    assert got.shape == (vocab, dim)
    assert torch.equal(teb.embedding_bag_backward(vocab, i, g, "mean", None),
                       got)
    rows = torch.unique(i.long()).to(cuda_device)
    total = float(got.sum(dtype=torch.float64))
    touched = got[rows].clone()
    got[rows] = 0
    untouched_zero = not bool(got.any())
    del got
    torch.cuda.empty_cache()
    want = teb.embedding_bag_backward_reference(vocab, i, g, "mean", None)
    assert untouched_zero
    torch.testing.assert_close(touched, want[rows], rtol=RTOL, atol=1e-6)
    assert abs(total - float(want.sum(dtype=torch.float64))) <= 1e-4
    del want
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("stacked", [False, True])
def test_bert_serving_on_card_matches_cpu(cuda_device, stacked):
    """BERTClassifier served on the card launches the flash kernel once
    per block and forward, and answers as the same weights on the CPU
    (atol 1e-4); a masked request takes the reference route and launches
    nothing."""
    from analytics_zoo_tpu_torch.convert import export_params
    from analytics_zoo_tpu_torch.deploy import InferenceModel
    from analytics_zoo_tpu_torch.nn import reset_name_scope
    from analytics_zoo_tpu_torch.ops import flash_attention as tfa
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier

    reset_name_scope()
    net = BERTClassifier(3, bert_config=dict(vocab=500, n_block=3,
                                             stacked=stacked))
    params = export_params(net)
    rs = np.random.RandomState(1)
    ids = rs.randint(0, 500, (5, 40)).astype(np.int32)
    seg = rs.randint(0, 2, (5, 40)).astype(np.int32)
    cpu = InferenceModel.from_keras_net(net, params, device="cpu")
    card = InferenceModel.from_keras_net(net, params, device=cuda_device)
    n0 = tfa.LAUNCHES.value
    got = card.predict([ids, seg])
    assert tfa.LAUNCHES.value - n0 == 3
    np.testing.assert_allclose(got, cpu.predict([ids, seg]), rtol=0,
                               atol=1e-4)
    mask = np.ones_like(ids)
    mask[:, 30:] = 0
    got = card.predict([ids, seg, mask])
    assert tfa.LAUNCHES.value - n0 == 3
    np.testing.assert_allclose(got, cpu.predict([ids, seg, mask]), rtol=0,
                               atol=1e-4)


@pytest.mark.cuda
def test_bert_fit_on_card_matches_plain_path(cuda_device):
    """BERTClassifier (3 blocks, no attention dropout, hidden dropout 0.1
    from the Estimator's seeded generator) trains on the card with every
    block's attention on the lse, dQ and dK/dV kernels — 3 of each per
    step, no forward-only kernel — and one step from the same weights and
    batch gives the plain path's loss (rtol 1e-4) and every leaf's
    gradient within 1e-4 of that leaf's largest plain |g| plus 1e-6 of
    the largest over all leaves (f32 sums in another order through 3
    blocks; the floor is for the key bias, whose gradient is 0 in exact
    arithmetic, so both paths hold only rounding noise there)."""
    from analytics_zoo_tpu_torch.convert import export_params, load_jax_params
    from analytics_zoo_tpu_torch.nn import reset_name_scope
    from analytics_zoo_tpu_torch.ops import dispatch
    from analytics_zoo_tpu_torch.ops import flash_attention as tfa
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier
    from analytics_zoo_tpu_torch.train.optimizers import AdamWeightDecay

    cfg = dict(vocab=500, n_block=3, attn_drop=0.0, hidden_drop=0.1)
    rs = np.random.RandomState(2)
    ids = rs.randint(0, 500, (16, 40)).astype(np.int32)
    seg = (np.arange(40)[None, :] >= rs.randint(1, 40, (16, 1))).astype(
        np.int32)
    y = (ids[:, 1] < 250).astype(np.int32)
    reset_name_scope()
    init = export_params(BERTClassifier(2, bert_config=cfg))

    def step():
        reset_name_scope()
        net = BERTClassifier(2, bert_config=cfg)
        load_jax_params(net, init)
        grads = {}
        for name, p in net.named_parameters():
            p.register_hook(lambda g, name=name: grads.__setitem__(
                name, g.detach().clone()))
        net.compile(AdamWeightDecay(1e-3), "sparse_categorical_crossentropy"
                    "_with_logits", device=cuda_device)
        hist = net.fit([ids, seg], y, batch_size=16, epochs=1, verbose=False)
        return hist[0]["loss"], grads

    counts = (tfa.LAUNCHES, tfa.LSE_LAUNCHES, tfa.BWD_DQ_LAUNCHES,
              tfa.BWD_DKV_LAUNCHES)
    n0 = [c.value for c in counts]
    loss, got = step()
    assert [c.value - n for c, n in zip(counts, n0)] == [0, 3, 3, 3]
    with dispatch.forced(dispatch.PATH_REFERENCE):
        ref_loss, want = step()
    assert [c.value - n for c, n in zip(counts, n0)] == [0, 3, 3, 3]
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-4)
    assert set(got) == set(want) and len(got) > 40
    g_all = max(float(g.abs().max()) for g in want.values())
    for name, g in want.items():
        err = float((got[name] - g).abs().max())
        assert err <= 1e-4 * float(g.abs().max()) + 1e-6 * g_all, (name, err)


def _spy_flash_dtypes(monkeypatch, tfa):
    """Record the dtype of q at every launch of the lse, dQ and dK/dV
    kernels."""
    seen = {"fwd": [], "lse": [], "dq": [], "dkv": []}
    launch, dq, dkv = tfa._launch, tfa.launch_bwd_dq, tfa.launch_bwd_dkv

    def spy_launch(q, *a, with_lse=False, **kw):
        seen["lse" if with_lse else "fwd"].append(q.dtype)
        return launch(q, *a, with_lse=with_lse, **kw)

    def spy(name, fn):
        def run(q, *a):
            seen[name].append(q.dtype)
            return fn(q, *a)
        return run

    monkeypatch.setattr(tfa, "_launch", spy_launch)
    monkeypatch.setattr(tfa, "launch_bwd_dq", spy("dq", dq))
    monkeypatch.setattr(tfa, "launch_bwd_dkv", spy("dkv", dkv))
    return seen


@pytest.mark.cuda
def test_bf16_bert_fit_runs_the_bf16_kernels_on_card(cuda_device,
                                                     monkeypatch):
    """``compute_dtype="bfloat16"``: every block's attention in a training
    step launches the lse, dQ and dK/dV kernels on bf16 q, k, v — 3 of
    each for 3 blocks — the masters stay f32, and one step from the same
    weights and batch gives the plain path's loss within one bf16 step
    (2^-8: the forwards round attention's output to bf16 apart on a few
    elements) and every leaf's gradient within 2^-5 of that leaf's
    largest plain |g| plus 2^-8 of the largest over all leaves (bf16
    products through 3 blocks rounded apart; the floor is for the key
    bias, whose gradient is 0 in exact arithmetic)."""
    from analytics_zoo_tpu_torch.convert import export_params, load_jax_params
    from analytics_zoo_tpu_torch.nn import reset_name_scope
    from analytics_zoo_tpu_torch.ops import dispatch
    from analytics_zoo_tpu_torch.ops import flash_attention as tfa
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier
    from analytics_zoo_tpu_torch.train.optimizers import AdamWeightDecay

    cfg = dict(vocab=500, n_block=3, attn_drop=0.0, hidden_drop=0.1)
    rs = np.random.RandomState(2)
    ids = rs.randint(0, 500, (32, 40)).astype(np.int32)
    seg = (np.arange(40)[None, :] >= rs.randint(1, 40, (32, 1))).astype(
        np.int32)
    y = (ids[:, 1] < 250).astype(np.int32)
    reset_name_scope()
    init = export_params(BERTClassifier(2, bert_config=cfg))

    def step():
        reset_name_scope()
        net = BERTClassifier(2, bert_config=cfg)
        load_jax_params(net, init)
        grads = {}
        for name, p in net.named_parameters():
            p.register_hook(lambda g, name=name: grads.__setitem__(
                name, g.detach().clone()))
        net.compile(AdamWeightDecay(1e-3), "sparse_categorical_crossentropy"
                    "_with_logits", device=cuda_device,
                    compute_dtype="bfloat16")
        hist = net.fit([ids, seg], y, batch_size=32, epochs=1, verbose=False)
        assert all(p.dtype == torch.float32 for p in net.parameters())
        assert all(g.dtype == torch.float32 for g in grads.values())
        return hist[0]["loss"], grads

    seen = _spy_flash_dtypes(monkeypatch, tfa)
    loss, got = step()
    assert seen == {"fwd": [], "lse": [torch.bfloat16] * 3,
                    "dq": [torch.bfloat16] * 3,
                    "dkv": [torch.bfloat16] * 3}, seen
    with dispatch.forced(dispatch.PATH_REFERENCE):
        ref_loss, want = step()
    assert len(seen["lse"]) == 3
    np.testing.assert_allclose(loss, ref_loss, rtol=2.0 ** -8)
    assert set(got) == set(want) and len(got) > 40
    g_all = max(float(g.abs().max()) for g in want.values())
    for name, g in want.items():
        err = float((got[name] - g).abs().max())
        assert err <= 2.0 ** -5 * float(g.abs().max()) + 2.0 ** -8 * g_all, (
            name, err)


@pytest.mark.cuda
def test_save_async_copies_off_live_tensors_on_card(cuda_device, tmp_path):
    """On the card the snapshot is a device clone queued after the steps
    already issued: steps trained right after ``save_async`` (in-place
    updates) do not reach it, and the restore equals the state at the
    save bit for bit."""
    from analytics_zoo_tpu_torch.convert import export_params
    from analytics_zoo_tpu_torch.models import NeuralCF
    from analytics_zoo_tpu_torch.nn import reset_name_scope
    from analytics_zoo_tpu_torch.train.checkpoint import CheckpointManager

    rs = np.random.RandomState(0)
    u = rs.randint(1, 301, (4096, 1)).astype(np.int32)
    i = rs.randint(1, 201, (4096, 1)).astype(np.int32)
    y = rs.randint(0, 5, 4096).astype(np.int32)
    reset_name_scope()
    ncf = NeuralCF(300, 200, device=cuda_device)
    ncf.compile("adam", "sparse_categorical_crossentropy")
    ncf.fit([u, i], y, batch_size=256, nb_epoch=1, verbose=False)
    est = ncf.estimator
    mgr = CheckpointManager(str(tmp_path))
    snapshot = est._snapshot()
    mgr.save_async(est.global_step, snapshot)
    want = export_params(ncf.model)
    state = [t.cpu() for t in est.opt_state]
    gen = est._dropout_gen.get_state()
    ncf.fit([u, i], y, batch_size=256, nb_epoch=3, verbose=False)
    mgr.wait()
    _, tree = mgr.restore()
    moved = export_params(ncf.model)
    for layer, leaves in want.items():
        for leaf, w in leaves.items():
            np.testing.assert_array_equal(tree["params"][layer][leaf], w)
            assert not np.array_equal(moved[layer][leaf], w)
    for a, b in zip(tree["opt_state"], state):
        np.testing.assert_array_equal(a, b.numpy())
    np.testing.assert_array_equal(tree["meta"]["torch_rng"], gen.numpy())


@pytest.mark.cuda
def test_dropout_generator_state_round_trips_on_card(cuda_device, tmp_path):
    """The CUDA dropout generator's state is captured at the flush's step
    boundary and restored by ``load_checkpoint`` (at the model's build,
    here the first ``predict``): the restored generator's next draws
    equal the ones the preempted run would make."""
    from analytics_zoo_tpu_torch.models import NeuralCF
    from analytics_zoo_tpu_torch.nn import reset_name_scope
    from analytics_zoo_tpu_torch.robust import (FaultInjector,
                                                TrainingPreempted)

    rs = np.random.RandomState(1)
    u = rs.randint(1, 51, (512, 1)).astype(np.int32)
    i = rs.randint(1, 41, (512, 1)).astype(np.int32)
    y = rs.randint(0, 5, 512).astype(np.int32)

    def model():
        reset_name_scope()
        ncf = NeuralCF(50, 40, dropout=0.3, device=cuda_device)
        ncf.compile("adam", "sparse_categorical_crossentropy")
        ncf.set_checkpoint(str(tmp_path))
        return ncf

    ncf = model()
    with FaultInjector().plan("estimator.preempt", at=21):
        with pytest.raises(TrainingPreempted):
            ncf.fit([u, i], y, batch_size=32, nb_epoch=3, verbose=False)
    at_flush = ncf.estimator._dropout_gen.get_state()
    want = torch.rand(1000, device=cuda_device,
                      generator=ncf.estimator._dropout_gen)
    again = model()
    est = again.estimator
    est.load_checkpoint(str(tmp_path))
    again.predict([u[:4], i[:4]])
    assert est.global_step == 21
    assert torch.equal(est._dropout_gen.get_state(), at_flush)
    got = torch.rand(1000, device=cuda_device, generator=est._dropout_gen)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# CUDA graphs: whole training steps and serving buckets (core/graphs.py)


def _tree_rel_diff(got, want):
    """The largest |got - want| over every leaf, relative to that leaf's
    largest |want|."""
    worst = 0.0
    for layer, leaves in want.items():
        for leaf, w in leaves.items():
            if isinstance(w, dict):
                worst = max(worst, _tree_rel_diff({"x": got[layer][leaf]},
                                                  {"x": w}))
                continue
            w = np.asarray(w, np.float64)
            d = np.abs(np.asarray(got[layer][leaf], np.float64) - w).max()
            worst = max(worst, float(d / max(np.abs(w).max(), 1e-30)))
    return worst


def _program_counts(est, counter):
    """(steps of the programs' eager warm-up dispatches, launches of
    ``counter`` their replays made) over ``est``'s step programs."""
    eager = replayed = 0
    for key, prog in est._programs.items():
        eager += key[1]
        if prog.graph.captured:
            replayed += (prog.graph.record.launches.get(counter, 0)
                         * prog.graph.replays)
    return eager, replayed


def _small_bert(seed=2, rows=64, length=40):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 500, (rows, length)).astype(np.int32)
    seg = (np.arange(length)[None, :] >= rs.randint(1, length, (rows, 1))
           ).astype(np.int32)
    y = (ids[:, 1] < 250).astype(np.int32)
    return ids, seg, y


@pytest.mark.cuda
def test_bf16_bert_fit_graphed_matches_eager_on_card(cuda_device):
    """BERT (3 blocks, hidden dropout 0.1) fine-tuned in bf16 for two
    epochs of 4 steps: one eager warm-up step, then one graph replay a
    step, 3 lse/dQ/dK-dV launches per replay; against the same run with
    graphs off (``graphs.disabled``): every loss, weight and optimizer
    state tensor equal, bit for bit (the same kernels in the same order
    on the same inputs and dropout bits; a looser bound, such as bf16
    fine-tuning's 2^-5 on the losses, would let replays that redraw one
    dropout mask pass).  The differences are printed."""
    from analytics_zoo_tpu_torch.convert import export_params, load_jax_params
    from analytics_zoo_tpu_torch.core import graphs
    from analytics_zoo_tpu_torch.nn import reset_name_scope
    from analytics_zoo_tpu_torch.ops import flash_attention as tfa
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier
    from analytics_zoo_tpu_torch.train.optimizers import AdamWeightDecay

    cfg = dict(vocab=500, n_block=3, attn_drop=0.0, hidden_drop=0.1)
    ids, seg, y = _small_bert()
    reset_name_scope()
    init = export_params(BERTClassifier(2, bert_config=cfg))

    def run():
        reset_name_scope()
        net = BERTClassifier(2, bert_config=cfg)
        load_jax_params(net, init)
        net.compile(AdamWeightDecay(1e-3, warmup_portion=0.1, total=8),
                    "sparse_categorical_crossentropy_with_logits",
                    device=cuda_device, compute_dtype="bfloat16")
        hist = net.fit([ids, seg], y, batch_size=16, epochs=2,
                       verbose=False)
        return [h["loss"] for h in hist], export_params(net), net.estimator

    n0 = tfa.BWD_DKV_LAUNCHES.value
    loss, got, est = run()
    assert tfa.BWD_DKV_LAUNCHES.value - n0 == 3 * 8
    (prog,) = est._programs.values()
    assert prog.graph.captured and prog.graph.replays == 7
    assert prog.graph.record.per_replay() == {
        "flash_attention_lse": 3, "flash_attention_bwd_dq": 3,
        "flash_attention_bwd_dkv": 3}
    with graphs.disabled():
        eager_loss, want, eager_est = run()
    assert not any(p.graph.captured for p in eager_est._programs.values())
    loss_diff = max(abs(a - b) / abs(b) for a, b in zip(loss, eager_loss))
    weight_diff = _tree_rel_diff(got, want)
    print(f"bf16 BERT graphed vs eager: loss rel {loss_diff:.3e}, "
          f"weights rel {weight_diff:.3e}")
    assert loss == eager_loss and weight_diff == 0.0
    for a, b in zip(est.opt_state, eager_est.opt_state):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_dropout_replays_draw_the_eager_masks_on_card(cuda_device):
    """A Dropout captured with its generator registered: each call (the
    eager warm-up, then capture and replays) draws the mask an eager call
    from the same generator state draws, no two calls the same mask, and
    the generator ends where the eager calls leave it."""
    import contextlib

    from analytics_zoo_tpu_torch.core import graphs
    from analytics_zoo_tpu_torch.nn import reset_name_scope
    from analytics_zoo_tpu_torch.nn.layers.core import Dropout

    reset_name_scope()
    drop = Dropout(0.5)
    x = torch.ones(4096, device=cuda_device)

    def calls(graphed):
        drop.generator = torch.Generator(cuda_device).manual_seed(7)
        g = graphs.StepGraph(lambda: drop(x), cuda_device,
                             generators=(drop.generator,), name="dropout")
        with contextlib.nullcontext() if graphed else graphs.disabled():
            outs = [g().clone() for _ in range(4)]
        return outs, g, drop.generator.get_state()

    want, _, want_state = calls(False)
    got, g, got_state = calls(True)
    assert g.captured and g.replays == 3
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not any(torch.equal(want[i], want[j])
                   for i in range(4) for j in range(i + 1, 4))
    assert torch.equal(got_state, want_state)


@pytest.mark.cuda
@pytest.mark.parametrize("path,k", [("host", 1), ("host", 4),
                                    ("resident", 1), ("resident", 4)])
def test_ncf_fit_graphed_matches_eager_on_card(cuda_device, path, k):
    """NCF for two epochs of 8 steps, one graph replay per ``k`` steps on
    the host and the device-resident paths, against graphs off: losses
    and every leaf within 1e-6 relative (the bag backward's atomics add
    duplicate ids in a free order).  The launch counters equal the
    launches per replay times the replays, plus the eager warm-up
    dispatch's."""
    from analytics_zoo_tpu_torch.convert import export_params, load_jax_params
    from analytics_zoo_tpu_torch.core import context, graphs
    from analytics_zoo_tpu_torch.models import NeuralCF
    from analytics_zoo_tpu_torch.nn import reset_name_scope

    rs = np.random.RandomState(0)
    u = rs.randint(1, 201, (1024, 1)).astype(np.int32)
    i = rs.randint(1, 151, (1024, 1)).astype(np.int32)
    y = rs.randint(0, 5, 1024).astype(np.int32)
    data = ([u, i], y) if path == "host" else (
        [torch.from_numpy(u).to(cuda_device),
         torch.from_numpy(i).to(cuda_device)],
        torch.from_numpy(y).to(cuda_device))
    reset_name_scope()
    init = export_params(NeuralCF(200, 150, device=cuda_device).model)

    def run():
        reset_name_scope()
        ncf = NeuralCF(200, 150, device=cuda_device)
        load_jax_params(ncf.model, init)
        ncf.compile("adam", "sparse_categorical_crossentropy")
        hist = ncf.fit(*data, batch_size=128, epochs=2, verbose=False)
        return [h["loss"] for h in hist], export_params(ncf.model), \
            ncf.estimator

    context.init_zoo_context(steps_per_execution=k)
    try:
        b0, f0 = teb.BWD_LAUNCHES.value, teb.LAUNCHES.value
        loss, got, est = run()
        assert teb.BWD_LAUNCHES.value - b0 == 4 * 16
        assert teb.LAUNCHES.value - f0 == 4 * 16
        eager_steps, replayed = _program_counts(est, teb.BWD_LAUNCHES)
        assert (eager_steps, replayed) == (k, 4 * (16 - k))
        assert all(p.graph.record.launches[teb.BWD_LAUNCHES] == 4 * key[1]
                   for key, p in est._programs.items())
        with graphs.disabled():
            eager_loss, want, _ = run()
    finally:
        context.set_zoo_context(None)
    np.testing.assert_allclose(loss, eager_loss, rtol=1e-6)
    diff = _tree_rel_diff(got, want)
    print(f"NCF {path} K={k} graphed vs eager: weights rel {diff:.3e}")
    assert diff <= 1e-6


@pytest.mark.cuda
def test_graphed_resume_after_sigterm_is_bit_exact_on_card(cuda_device,
                                                           tmp_path):
    """BERT (3 blocks, hidden dropout 0.1, bf16) for three epochs of 4
    steps, graphed: a real SIGTERM before epoch 2's third step flushes a
    checkpoint; a fresh net resumed with ``fit(resume=True)`` (its first
    step eager, then replays) equals the uninterrupted graphed run in
    every loss and weight, bit for bit."""
    from analytics_zoo_tpu_torch.convert import export_params, load_jax_params
    from analytics_zoo_tpu_torch.nn import reset_name_scope
    from analytics_zoo_tpu_torch.robust import (FaultInjector,
                                                TrainingPreempted)
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier
    from analytics_zoo_tpu_torch.train.optimizers import AdamWeightDecay

    cfg = dict(vocab=500, n_block=3, attn_drop=0.0, hidden_drop=0.1)
    ids, seg, y = _small_bert()
    reset_name_scope()
    init = export_params(BERTClassifier(2, bert_config=cfg))

    def net(ckpt=None):
        reset_name_scope()
        n = BERTClassifier(2, bert_config=cfg)
        load_jax_params(n, init)
        n.compile(AdamWeightDecay(1e-3, warmup_portion=0.1, total=12),
                  "sparse_categorical_crossentropy_with_logits",
                  device=cuda_device, compute_dtype="bfloat16")
        if ckpt is not None:
            n.set_checkpoint(ckpt)
        return n

    whole = net()
    want = whole.fit([ids, seg], y, batch_size=16, epochs=3, verbose=False)
    cut = net(str(tmp_path))
    with FaultInjector().plan("estimator.preempt", at=6, action="sigterm"):
        with pytest.raises(TrainingPreempted):
            cut.fit([ids, seg], y, batch_size=16, epochs=3, verbose=False)
    resumed = net(str(tmp_path))
    got = resumed.fit([ids, seg], y, batch_size=16, epochs=3,
                      verbose=False, resume=True)
    assert resumed.estimator.global_step == 12
    assert [h["loss"] for h in got] == [h["loss"] for h in want[1:]]
    a, b = export_params(resumed), export_params(whole)
    assert _tree_rel_diff(a, b) == 0.0
    for x, w in zip(resumed.estimator.opt_state, whole.estimator.opt_state):
        assert torch.equal(x, w)


def _ncf_serving(cuda_device):
    from analytics_zoo_tpu_torch.convert import export_params, load_jax_params
    from analytics_zoo_tpu_torch.models import NeuralCF
    from analytics_zoo_tpu_torch.nn import reset_name_scope

    reset_name_scope()
    ncf = NeuralCF(200, 150, device=cuda_device)
    rs = np.random.RandomState(4)
    load_jax_params(ncf.model, {
        layer: {leaf: (rs.randn(*v.shape) * 0.1).astype(np.float32)
                for leaf, v in sub.items()}
        for layer, sub in export_params(ncf.model).items()})
    u = rs.randint(1, 201, (64, 1)).astype(np.int32)
    i = rs.randint(1, 151, (64, 1)).astype(np.int32)
    return ncf.model, [u, i]


@pytest.mark.cuda
def test_warm_bucket_graphs_serve_threads_on_card(cuda_device, tmp_path):
    """int8 NCF: a first model captures buckets 1, 8 and 64 and fills a
    compile cache; a second, after ``warm()``, holds one captured graph
    per bucket and answers eight threads' 240 requests with the eager
    answers exactly (graphs off), with zero live captures; every request
    replays 4 bag forwards and one dequantize-matmul."""
    from analytics_zoo_tpu_torch.core import graphs
    from analytics_zoo_tpu_torch.deploy import CompileCache, InferenceModel

    net, x = _ncf_serving(cuda_device)

    def model():
        return InferenceModel.from_keras_net(
            net, weight_dtype="int8", batch_buckets=(1, 8, 64),
            device=cuda_device).attach_compile_cache(
                CompileCache(str(tmp_path)))

    cold = model()
    for b in (1, 8, 64):
        cold.predict([a[:b] for a in x])
    assert cold.compile_count == 3
    m = model()
    assert m.warm() == 3 and m.warm_count == 3
    assert all(p.graph.captured for p in m._programs.values())
    with graphs.disabled():
        want = {b: m.predict([a[:b] for a in x]) for b in (1, 8, 64)}
    f0, q0 = teb.LAUNCHES.value, tdq.LAUNCHES.value
    got, errors = [], []

    def worker(t):
        try:
            for r in range(30):
                b = (1, 8, 64)[(t + r) % 3]
                got.append((b, m.predict([a[:b] for a in x])))
        except Exception as e:   # surfaced below
            errors.append(e)

    import threading
    threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(got) == 240 and m.compile_count == 0
    for b, out in got:
        np.testing.assert_array_equal(out, want[b])
    assert teb.LAUNCHES.value - f0 == 4 * 240
    assert tdq.LAUNCHES.value - q0 == 240


@pytest.mark.cuda
def test_threads_on_a_new_signature_capture_it_once_on_card(cuda_device,
                                                            tmp_path):
    """int8 NCF: eight threads send one new signature at the same time.
    One of them runs the eager warm-up; the others wait for one capture,
    made alone, and replay.  One capture counted, one cache entry stored,
    every answer the eager one exactly."""
    import threading

    from analytics_zoo_tpu_torch.core import graphs
    from analytics_zoo_tpu_torch.deploy import CompileCache, InferenceModel
    from analytics_zoo_tpu_torch.observe.metrics import METRICS

    net, x = _ncf_serving(cuda_device)
    cache = CompileCache(str(tmp_path))
    m = InferenceModel.from_keras_net(
        net, weight_dtype="int8", batch_buckets=(1, 8),
        device=cuda_device).attach_compile_cache(cache)
    xs = [a[:8] for a in x]
    with graphs.disabled():
        want = InferenceModel.from_keras_net(
            net, weight_dtype="int8", batch_buckets=(1, 8),
            device=cuda_device).predict(xs)
    window = METRICS.snapshot()
    f0 = teb.LAUNCHES.value
    start = threading.Barrier(8)
    got, errors = [], []

    def worker():
        try:
            start.wait(timeout=60)
            got.append(m.predict(xs))
        except Exception as e:   # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    (prog,) = m._programs.values()
    captures = METRICS.delta(window)["counters"].get(
        'graph_captures_total{kind="serving"}')
    assert prog.graph.captured and captures == 1
    # one eager warm-up (a caller's, or the capture's own), then replays
    assert prog.graph.replays in (7, 8)
    assert teb.LAUNCHES.value - f0 == 4 * (1 + prog.graph.replays)
    assert m.compile_count == 1 and cache.stats()["events"] == {"miss": 1}
    assert len(got) == 8
    for out in got:
        np.testing.assert_array_equal(out, want)


@pytest.mark.cuda
def test_bert_bucket_graphs_match_eager_on_card(cuda_device):
    """BERT (2 blocks) served from bucket graphs: 2 flash launches per
    replay, the eager answers exactly."""
    from analytics_zoo_tpu_torch.core import graphs
    from analytics_zoo_tpu_torch.deploy import InferenceModel
    from analytics_zoo_tpu_torch.nn import reset_name_scope
    from analytics_zoo_tpu_torch.ops import flash_attention as tfa
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier

    reset_name_scope()
    net = BERTClassifier(2, bert_config=dict(vocab=500, n_block=2))
    ids, seg, _ = _small_bert(rows=8)
    m = InferenceModel.from_keras_net(net, batch_buckets=(1, 8),
                                      device=cuda_device)
    for b in (1, 8):
        m.predict([ids[:b], seg[:b]])
    n0 = tfa.LAUNCHES.value
    got = {b: m.predict([ids[:b], seg[:b]]) for b in (1, 8)}
    assert tfa.LAUNCHES.value - n0 == 2 * 2
    assert all(p.graph.captured and p.graph.record.per_replay()
               == {"flash_attention": 2} for p in m._programs.values())
    with graphs.disabled():
        for b in (1, 8):
            np.testing.assert_array_equal(got[b],
                                          m.predict([ids[:b], seg[:b]]))


def _pair_batches(x, rows, seed):
    """Two different ``rows``-row (user, item) batches of ``x``'s pairs."""
    rs = np.random.RandomState(seed)
    pick = [rs.permutation(len(x[0]))[:rows] for _ in range(2)]
    return [[a[p] for a in x] for p in pick]


@pytest.mark.cuda
def test_two_flights_of_one_bucket_keep_their_answers_on_card(cuda_device):
    """int8 NCF replica: two different 8-row batches dispatched through
    one captured bucket graph before either is harvested (the second
    replay overwrites the graph's static outputs) each get their own
    answers, the eager ones exactly."""
    from analytics_zoo_tpu_torch.core import graphs
    from analytics_zoo_tpu_torch.deploy import InferenceModel

    net, x = _ncf_serving(cuda_device)
    m = InferenceModel.from_keras_net(net, weight_dtype="int8",
                                      batch_buckets=(1, 8),
                                      device=cuda_device)
    (rep,) = m.replica_forwards(1)
    a, b = _pair_batches(x, 8, seed=5)
    for _ in range(2):                  # eager warm-up, then the capture
        rep.harvest(rep.dispatch(a))
    (prog,) = m._programs.values()
    assert prog.graph.captured
    with graphs.disabled():
        want_a, want_b = m.predict(a), m.predict(b)
    assert not np.array_equal(want_a, want_b)
    for _ in range(20):
        fa, fb = rep.dispatch(a), rep.dispatch(b)
        got_b, got_a = rep.harvest(fb), rep.harvest(fa)
        np.testing.assert_array_equal(got_a[0], want_a)
        np.testing.assert_array_equal(got_b[0], want_b)


@pytest.mark.cuda
def test_replica_rebuilt_beside_replays_captures_cleanly_on_card(
        cuda_device):
    """While a thread replays a BERT replica's bucket graph, fresh int8
    NCF models are built (hot reload) and served: each new model's first
    run is eager and its second captures, alone under its gate, beside
    the BERT replays; then its slot's replica is rebuilt (the
    supervisor's rebuild), which replays the program already captured.
    Every answer of both models equals the eager one exactly, and no
    thread raises."""
    import threading

    from analytics_zoo_tpu_torch.core import graphs
    from analytics_zoo_tpu_torch.deploy import InferenceModel
    from analytics_zoo_tpu_torch.nn import reset_name_scope
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier

    net, x = _ncf_serving(cuda_device)

    def ncf_model():
        return InferenceModel.from_keras_net(net, weight_dtype="int8",
                                             batch_buckets=(1, 8),
                                             device=cuda_device)

    reset_name_scope()
    bert = InferenceModel.from_keras_net(
        BERTClassifier(2, bert_config=dict(vocab=500, n_block=2)),
        batch_buckets=(8,), device=cuda_device)
    ids, _, _ = _small_bert(rows=8)
    (brep,) = bert.replica_forwards(1, top_n=2)
    for _ in range(2):
        brep.harvest(brep.dispatch([ids]))
    a, _ = _pair_batches(x, 8, seed=6)
    with graphs.disabled():
        want_bert = brep.harvest(brep.dispatch([ids]))
        want_ncf = ncf_model().predict(a)
    stop, errors, replays = threading.Event(), [], []

    def replay_bert():
        try:
            while not stop.is_set():
                got = brep.harvest(brep.dispatch([ids]))
                for g, w in zip(got, want_bert):
                    np.testing.assert_array_equal(g, w)
                replays.append(1)
        except Exception as e:   # surfaced below
            errors.append(e)

    t = threading.Thread(target=replay_bert)
    t.start()
    try:
        for _ in range(3):                 # three reloads
            ncf = ncf_model()
            (rep,) = ncf.replica_forwards(1)
            for _ in range(3):             # eager, capture, replay
                np.testing.assert_array_equal(
                    rep.harvest(rep.dispatch(a))[0], want_ncf)
            (prog,) = ncf._programs.values()
            shared = torch.cuda.graph.default_capture_stream   # fit's
            assert prog.graph.captured and (
                shared is None
                or prog.capture_stream.cuda_stream != shared.cuda_stream)
            replays0 = prog.graph.replays
            (rep,) = ncf.replica_forwards(1)   # the slot's rebuild
            np.testing.assert_array_equal(
                rep.harvest(rep.dispatch(a))[0], want_ncf)
            assert len(ncf._programs) == 1
            assert prog.graph.replays == replays0 + 1
    finally:
        stop.set()
        t.join(timeout=120)
    assert not t.is_alive() and not errors, errors
    assert replays


@pytest.mark.cuda
def test_serving_launch_waits_for_the_callers_stream_on_card(cuda_device):
    """A replica's launch goes on the serving stream after the work the
    caller's stream holds: the card is kept busy on the default stream,
    the served weights are then halved there, and the launch that follows
    at once answers with the halved weights (the eager answer after a
    synchronize), for a captured graph and for the eager warm-up."""
    from analytics_zoo_tpu_torch.core import graphs
    from analytics_zoo_tpu_torch.deploy import InferenceModel

    net, x = _ncf_serving(cuda_device)
    m = InferenceModel.from_keras_net(net, batch_buckets=(8, 64),
                                      device=cuda_device)
    (rep,) = m.replica_forwards(1)
    a, _ = _pair_batches(x, 8, seed=9)
    for _ in range(2):                     # the 8-row graph is captured
        rep.harvest(rep.dispatch(a))
    for xs in (a, x):                      # replay; the 64-row warm-up
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)     # about 0.1 s on the card
        with torch.no_grad():
            for p in m._net.parameters():
                p.mul_(0.5)
        got = rep.harvest(rep.dispatch(xs))[0]
        torch.cuda.synchronize()
        with graphs.disabled():
            want = m.predict(xs)
        np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_recommender_recommends_right_after_fit_on_card(cuda_device):
    """An int8 Recommender on the card recommends, fits two graphed
    steps, and recommends again at once: the second answer is the
    trained weights' (the rebuilt serving model, launched on the serving
    stream right after the training replays on the default stream),
    equal to the eager answer of a serving model built from them after a
    synchronize, and differs from the first."""
    from analytics_zoo_tpu_torch.convert import export_params, load_jax_params
    from analytics_zoo_tpu_torch.core import graphs
    from analytics_zoo_tpu_torch.deploy import InferenceModel
    from analytics_zoo_tpu_torch.models import NeuralCF
    from analytics_zoo_tpu_torch.nn import reset_name_scope

    reset_name_scope()
    ncf = NeuralCF(200, 150, device=cuda_device)
    rs = np.random.RandomState(11)
    load_jax_params(ncf.model, {
        layer: {leaf: (rs.randn(*v.shape) * 0.1).astype(np.float32)
                for leaf, v in sub.items()}
        for layer, sub in export_params(ncf.model).items()})
    ncf.compile("adam", "sparse_categorical_crossentropy")
    items = np.arange(1, 151)
    ncf.inference_model(weight_dtype="int8")
    for _ in range(2):                     # the 256-row graph is captured
        first = ncf.recommend_for_user(3, items, max_items=150)
    u = rs.randint(1, 201, (64, 1)).astype(np.int32)
    i = rs.randint(1, 151, (64, 1)).astype(np.int32)
    y = rs.randint(0, 5, 64).astype(np.int32)
    ncf.fit([u, i], y, batch_size=32, nb_epoch=1, verbose=False)
    second = ncf.recommend_for_user(3, items, max_items=150)
    torch.cuda.synchronize()
    with graphs.disabled():
        im = InferenceModel.from_keras_net(ncf.model, weight_dtype="int8",
                                           device=cuda_device)
        probs = im.predict([np.full((150, 1), 3, np.int32),
                            items.reshape(-1, 1).astype(np.int32)])
    assert second == ncf._ranked(items, probs, 150)
    assert [s for _, s in second] != [s for _, s in first]


@pytest.mark.cuda
def test_serving_beside_fit_matches_eager_on_card(cuda_device):
    """BERT bucket graphs replay on the serving stream in one thread
    while the main thread fits NCF through its step graphs on the
    default stream; both capture on the main thread, on different capture
    streams, so they share no library workspace.  Every BERT answer
    equals the eager one exactly and the fit's losses are finite."""
    import threading

    from analytics_zoo_tpu_torch.core import graphs
    from analytics_zoo_tpu_torch.deploy import InferenceModel
    from analytics_zoo_tpu_torch.models import NeuralCF
    from analytics_zoo_tpu_torch.nn import reset_name_scope
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier

    reset_name_scope()
    bert = InferenceModel.from_keras_net(
        BERTClassifier(2, bert_config=dict(vocab=500, n_block=2)),
        batch_buckets=(32,), device=cuda_device)
    ids, _, _ = _small_bert(rows=32)
    (brep,) = bert.replica_forwards(1, top_n=2)
    for _ in range(2):
        brep.harvest(brep.dispatch([ids]))
    with graphs.disabled():
        want = brep.harvest(brep.dispatch([ids]))
    reset_name_scope()
    ncf = NeuralCF(200, 150, hidden_layers=(256, 256, 128),
                   device=cuda_device)
    ncf.compile("adam", "sparse_categorical_crossentropy")
    rs = np.random.RandomState(12)
    u = rs.randint(1, 201, (4096, 1)).astype(np.int32)
    i = rs.randint(1, 151, (4096, 1)).astype(np.int32)
    y = rs.randint(0, 5, 4096).astype(np.int32)
    stop, errors, replays = threading.Event(), [], []

    def serve():
        try:
            while not stop.is_set():
                got = brep.harvest(brep.dispatch([ids]))
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g, w)
                replays.append(1)
        except Exception as e:   # surfaced below
            errors.append(e)

    t = threading.Thread(target=serve)
    t.start()
    try:
        hist = ncf.fit([u, i], y, batch_size=128, epochs=4, verbose=False)
    finally:
        stop.set()
        t.join(timeout=120)
    assert not t.is_alive() and not errors, errors
    assert replays and np.isfinite([h["loss"] for h in hist]).all()


@pytest.mark.cuda
def test_top_n_on_card_equals_reference_top_n(cuda_device):
    """The top-2 fused into the bucket graph (int32 indices, values)
    against the top-2 of the plain path's scores (``forced("reference")``)
    on tie-free rows: equal indices, values within 1e-6."""
    from analytics_zoo_tpu_torch.deploy import InferenceModel
    from analytics_zoo_tpu_torch.ops import dispatch

    net, x = _ncf_serving(cuda_device)
    m = InferenceModel.from_keras_net(net, weight_dtype="int8",
                                      batch_buckets=(8, 64),
                                      device=cuda_device)
    (rep,) = m.replica_forwards(1, top_n=2)
    for _ in range(2):
        idx, vals = rep.harvest(rep.dispatch(x))
    with dispatch.forced("reference"):
        probs = m.predict(x)
    top = np.argsort(-probs, axis=1)[:, :2]
    srt = np.sort(probs, axis=1)
    assert np.all(srt[:, -1] - srt[:, -2] > 1e-5), "inputs hold a tie"
    assert idx.dtype == np.int32 and idx.shape == (64, 2)
    np.testing.assert_array_equal(idx, top)
    np.testing.assert_allclose(vals, np.take_along_axis(probs, top, 1),
                               rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_two_models_flights_in_flight_match_eager_on_card(cuda_device):
    """int8 NCF and BERT replicas (top-2 fused), their bucket graphs
    captured by one thread: 40 flights of both models dispatched back to
    back before any is harvested, then harvested in turn, each equal to
    the eager answer.  Graphs captured on one stream share cuBLAS's
    workspace, so their replays must not overlap; the serving stream
    orders them."""
    from analytics_zoo_tpu_torch.core import graphs
    from analytics_zoo_tpu_torch.deploy import InferenceModel
    from analytics_zoo_tpu_torch.nn import reset_name_scope
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier

    net, x = _ncf_serving(cuda_device)
    ncf = InferenceModel.from_keras_net(net, weight_dtype="int8",
                                        batch_buckets=(8,),
                                        device=cuda_device)
    reset_name_scope()
    bert = InferenceModel.from_keras_net(
        BERTClassifier(2, bert_config=dict(vocab=500, n_block=2)),
        batch_buckets=(8,), device=cuda_device)
    ids, _, _ = _small_bert(rows=16)
    (nrep,) = ncf.replica_forwards(1, top_n=2)
    (brep,) = bert.replica_forwards(1, top_n=2)
    a, b = _pair_batches(x, 8, seed=7)
    work = [(nrep, a), (brep, [ids[:8]]), (nrep, b), (brep, [ids[8:]])]
    for rep, xs in work:
        for _ in range(2):                 # eager, then the capture
            rep.harvest(rep.dispatch(xs))
    with graphs.disabled():
        want = [rep.harvest(rep.dispatch(xs)) for rep, xs in work]
    flights = [(k % 4, rep.dispatch(xs))
               for k, (rep, xs) in enumerate(work * 10)]
    for k, f in flights:
        got = work[k][0].harvest(f)
        for g, w in zip(got, want[k]):
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the image slice: conv, pooling, BatchNormalization, ResNet-50


def _image_layer_cases():
    from analytics_zoo_tpu_torch.nn.layers import (AveragePooling2D,
                                                   BatchNormalization,
                                                   Convolution2D,
                                                   MaxPooling2D,
                                                   SeparableConvolution2D,
                                                   SpaceToDepthStemConv)

    return [
        ("stem_plain", lambda: Convolution2D(64, 7, 7, subsample=2,
                                             border_mode="same"),
         (4, 224, 224, 3)),
        ("stem_s2d", lambda: SpaceToDepthStemConv(64), (4, 224, 224, 3)),
        ("conv3x3_s2_th", lambda: Convolution2D(
            32, 3, 3, subsample=2, border_mode="same", dim_ordering="th"),
         (4, 16, 15, 15)),
        ("conv1x1_s2", lambda: Convolution2D(64, 1, 1, subsample=2,
                                             border_mode="same"),
         (4, 28, 28, 32)),
        ("separable", lambda: SeparableConvolution2D(
            24, 3, 3, subsample=2, border_mode="same"), (4, 17, 17, 16)),
        ("maxpool_same", lambda: MaxPooling2D((3, 3), strides=(2, 2),
                                              border_mode="same"),
         (4, 112, 112, 8)),
        ("avgpool_same", lambda: AveragePooling2D((3, 3), strides=(2, 2),
                                                  border_mode="same"),
         (4, 15, 15, 8)),
        ("bn", lambda: BatchNormalization(), (8, 7, 7, 64)),
        ("bn_ghost_th", lambda: BatchNormalization(
            dim_ordering="th", stats_fraction=0.5), (8, 64, 7, 7)),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [
    "stem_plain", "stem_s2d", "conv3x3_s2_th", "conv1x1_s2", "separable",
    "maxpool_same", "avgpool_same", "bn", "bn_ghost_th"])
def test_image_layers_on_card_match_cpu(cuda_device, case, dtype):
    """Each image layer on the card (cuDNN / ATen's CUDA kernels, TF32
    off) against the same layer's plain f32 form on the CPU, on the same
    inputs (rounded to bf16 first in the bf16 case): the training
    forward, the gradient of a seeded projection of it, (BN) the new
    moving statistics, and the eval forward.  f32 within 1e-5 of the
    largest |value| (sums in another order); bf16 within 2^-6 of it (the
    card rounds each result to bf16, a relative 2^-8, over f32 sums)."""
    import copy

    from analytics_zoo_tpu_torch.nn import reset_name_scope

    torch.backends.cudnn.allow_tf32 = False
    make, shape = {c[0]: (c[1], c[2]) for c in _image_layer_cases()}[case]
    dt = getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -6
    reset_name_scope()
    cpu = make()
    cpu.build(torch.Generator().manual_seed(0), shape)
    card = copy.deepcopy(cpu).to(cuda_device)
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dt)
    proj = torch.from_numpy(rs.randn(*cpu.output_shape(shape)).astype(
        np.float32))

    def run(layer, x, training):
        layer.train(training)
        x = x.clone().requires_grad_(training)
        out = layer(x)
        grads = (torch.autograd.grad((out.float() * proj.to(x.device))
                                     .sum(), [x])[0]
                 if training else None)
        return out.detach(), grads

    def close(got, want, what):
        want = want.float().cpu()
        top = max(float(want.abs().max()), 1e-6)
        err = float((got.float().cpu() - want).abs().max())
        assert err <= tol * top, (case, dtype, what, err, top)

    for training in (True, False):
        got, g_got = run(card, x.to(cuda_device), training)
        want, g_want = run(cpu, x.float(), training)
        assert got.dtype == dt
        close(got, want, f"forward training={training}")
        if training:
            close(g_got, g_want, "input gradient")
            for k, v in cpu.state().items():
                close(card.state()[k], v, k)


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_resnet_fit_graphed_matches_eager_on_card(cuda_device,
                                                  compute_dtype):
    """ResNet-50 (10 classes, 32x32) for two epochs of 2 steps, one graph
    replay per step, against graphs off, both with cuDNN's deterministic
    algorithms: losses, every leaf and every moving statistic within
    1e-6 relative (the same kernels on the same inputs); the BN state
    moved and stayed f32."""
    from analytics_zoo_tpu_torch.convert import (export_params, export_state,
                                                 load_jax_params)
    from analytics_zoo_tpu_torch.core import graphs
    from analytics_zoo_tpu_torch.models.image import resnet50
    from analytics_zoo_tpu_torch.nn import reset_name_scope

    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.rand(32, 32, 32, 3).astype(np.float32)).to(
        cuda_device)
    y = torch.from_numpy(rs.randint(0, 10, 32)).to(cuda_device)
    reset_name_scope()
    net = resnet50(10, (32, 32, 3))
    init = (export_params(net), export_state(net))

    def run():
        reset_name_scope()
        net = resnet50(10, (32, 32, 3))
        load_jax_params(net, *init)
        net.compile("adam", "sparse_categorical_crossentropy_with_logits",
                    device=cuda_device, compute_dtype=compute_dtype)
        hist = net.fit(x, y, batch_size=16, epochs=2, verbose=False)
        return ([h["loss"] for h in hist], export_params(net),
                export_state(net), net)

    torch.backends.cudnn.deterministic = True
    try:
        loss, got_p, got_s, net = run()
        assert net.estimator._programs and all(
            p.graph.captured for p in net.estimator._programs.values())
        assert all(t.dtype == torch.float32 for s in net.state().values()
                   for t in s.values())
        with graphs.disabled():
            eager_loss, want_p, want_s, _ = run()
    finally:
        torch.backends.cudnn.deterministic = False
    np.testing.assert_allclose(loss, eager_loss, rtol=1e-6)
    assert _tree_rel_diff(got_p, want_p) <= 1e-6
    assert _tree_rel_diff(got_s, want_s) <= 1e-6
    assert _tree_rel_diff(got_s, init[1]) > 1e-3


# ---------------------------------------------------------------------------
# the other recommenders: WideAndDeep and SessionRecommender


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bag_kernels_at_the_wide_tower_shape_on_card(cuda_device, dtype):
    """WideAndDeep's wide tower: a (2000, 2) table, 8192 bags of 2 ids,
    no pad id.  Its rows are 8 bytes (f32) or 4 (bf16), the narrowest
    lane layout the forward has: one piece per row.  Forward within
    1e-5 (f32) or 2^-7 of |plain| (bf16: one rounding of an f32 sum on
    each side); the backward's 16,384 contributions to 2000 rows within
    1e-6 + 1e-5 of their summed magnitude (f32 atomics in a free
    order)."""
    dt = getattr(torch, dtype)
    table, ids = _bag_inputs(2000, 2, 8192, 2, None, seed=11)
    t = torch.from_numpy(table).to(cuda_device).to(dt)
    i = torch.from_numpy(ids).to(cuda_device)
    assert teb.piece_bytes(t.element_size(), 2, t.data_ptr()) == (
        8 if dtype == "float32" else 4)
    n0 = teb.LAUNCHES.value
    got = teb.embedding_bag(t, i, "sum", None)
    torch.cuda.synchronize()
    assert teb.LAUNCHES.value == n0 + 1 and got.dtype == dt
    want = teb.embedding_bag_reference(t, i, "sum", None)
    err = (got.double() - want.double()).abs()
    rtol = 1e-5 if dtype == "float32" else 2.0 ** -7
    assert bool(torch.all(err <= 1e-5 + rtol * want.double().abs()))
    g = torch.randn(8192, 2, device=cuda_device)
    b0 = teb.BWD_LAUNCHES.value
    dtab = teb.embedding_bag_backward(2000, i, g, "sum", None)
    torch.cuda.synchronize()
    assert teb.BWD_LAUNCHES.value == b0 + 1
    ref = teb.embedding_bag_backward_reference(2000, i, g, "sum", None)
    mass = teb.embedding_bag_backward_reference(2000, i, g.abs(), "sum",
                                                None)
    assert bool(torch.all((dtab - ref).abs() <= 1e-6 + 1e-5 * mass))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,bits", [
    (64, 40, 37484, 8), (64, 40, 37484, 4), (1, 40, 37484, 8),
    (64, 25, 2, 8), (64, 26, 2, 4), (256, 139, 100, 8), (256, 100, 75, 4)])
def test_dq_kernel_at_the_recommender_shapes_on_card(cuda_device, m, k, n,
                                                     bits):
    """Kernel 3 at the session head (K = 40, N = 37,484: ``dq_wgmma`` at
    M = 64, K under one wgmma K tile), at N = 2 (under any tile) and at
    WideAndDeep's first two Dense layers (K = 139 and 100), against its
    plain version within 1e-4 of the largest |plain| (K-long f32 sums in
    another order)."""
    x, q, s = _dq_inputs(cuda_device, m, k, n, bits, torch.float32,
                         seed=m + k + n)
    n0 = tdq.LAUNCHES.value
    got = tdq.dequant_matmul(x, q, s, bits=bits, rows=k)
    torch.cuda.synchronize()
    assert tdq.LAUNCHES.value == n0 + 1
    want = tdq.dequant_matmul_reference(x, q, s, bits=bits, rows=k)
    top = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * top


def _recurrent_cases():
    from analytics_zoo_tpu_torch.nn.layers import core, recurrent as r

    return {
        "gru_seq": (lambda: r.GRU(40, return_sequences=True), (64, 10, 100)),
        "gru_last": (lambda: r.GRU(20), (64, 10, 40)),
        "lstm_back": (lambda: r.LSTM(32, go_backwards=True), (16, 8, 24)),
        "simple_rnn": (lambda: r.SimpleRNN(16, return_sequences=True),
                       (16, 8, 24)),
        "bidirectional": (lambda: r.Bidirectional(
            r.GRU(16, return_sequences=True)), (16, 8, 24)),
        "highway": (lambda: r.Highway(), (32, 48)),
        "time_distributed": (lambda: r.TimeDistributed(core.Dense(12)),
                             (16, 8, 24)),
        "convlstm2d": (lambda: r.ConvLSTM2D(8, 3, return_sequences=True),
                       (4, 5, 9, 9, 3)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["gru_seq", "gru_last", "lstm_back",
                                  "simple_rnn", "bidirectional", "highway",
                                  "time_distributed", "convlstm2d"])
def test_recurrent_layers_on_card_match_cpu(cuda_device, case, dtype):
    """Each recurrent layer on the card against its f32 form on the CPU,
    on the same inputs (rounded to bf16 first in the bf16 case, with the
    weights cast to bf16 as ``compute_dtype="bfloat16"`` casts them):
    the forward and the input gradient of a seeded projection.  f32
    within 1e-5 of the largest |value| (sums in another order).  bf16:
    the forward within 2^-6 of it (the hoisted projection rounds to bf16
    once, the carry stays f32); the input gradient within 2^-4 of it
    (the backward rounds the projection's gradient to bf16 and sums G·H
    products of bf16 factors into each element, with cancellation:
    2.1% of the largest |value| seen for the GRU on an H100)."""
    import copy

    from analytics_zoo_tpu_torch.nn import reset_name_scope
    from analytics_zoo_tpu_torch.nn.module import cast_floats

    torch.backends.cudnn.allow_tf32 = False
    make, shape = _recurrent_cases()[case]
    dt = getattr(torch, dtype)
    tols = ((1e-5, 1e-5) if dtype == "float32"
            else (2.0 ** -6, 2.0 ** -4))
    reset_name_scope()
    cpu = make()
    cpu.build(torch.Generator().manual_seed(0), shape)
    card = copy.deepcopy(cpu).to(cuda_device)
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dt)
    proj = torch.from_numpy(rs.randn(*cpu.output_shape(shape)).astype(
        np.float32))

    def run(layer, x, cast):
        x = x.clone().requires_grad_(True)
        weights = cast_floats(layer, cast) if cast is not None else None
        out = (torch.func.functional_call(layer, weights, (x,))
               if weights is not None else layer(x))
        (gx,) = torch.autograd.grad((out.float() * proj.to(x.device))
                                    .sum(), [x])
        return out.detach(), gx

    got, g_got = run(card, x.to(cuda_device),
                     dt if dtype == "bfloat16" else None)
    want, g_want = run(cpu, x.float(), None)
    for a, b, what, tol in ((got, want, "forward", tols[0]),
                            (g_got, g_want, "grad", tols[1])):
        b = b.float()
        top = max(float(b.abs().max()), 1e-6)
        err = float((a.float().cpu() - b).abs().max())
        print(f"{case} {dtype} {what}: {err / top:.3e} of the largest")
        assert err <= tol * top, (case, dtype, what, err, top)


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_wide_and_deep_fit_graphed_matches_eager_on_card(cuda_device,
                                                         compute_dtype):
    """A census-shaped WideAndDeep (narrow deep tower) trained from a
    device-resident FeatureSet, K = 4 steps per graph replay, for two
    epochs of 8 steps, against graphs off: losses and every leaf within
    1e-6 relative (the bag backward's atomics add the wide table's
    duplicate ids in a free order: 8,192 contributions to 2,000 rows per
    step).  Each step launches the bag forward and backward three times:
    the wide bag and the two embed columns."""
    from analytics_zoo_tpu_torch.convert import export_params, load_jax_params
    from analytics_zoo_tpu_torch.core import context, graphs
    from analytics_zoo_tpu_torch.data import CacheLevel, FeatureSet
    from analytics_zoo_tpu_torch.models import WideAndDeep
    from analytics_zoo_tpu_torch.nn import reset_name_scope

    kw = dict(class_num=2, wide_base_dims=(1000, 1000),
              embed_in_dims=(5000, 1000), embed_out_dims=(16, 16),
              continuous_cols=11, hidden_layers=(32, 16), device=cuda_device)
    rs = np.random.RandomState(0)
    n = 4096
    wide = np.stack([rs.randint(0, 1000, n), rs.randint(1000, 2000, n)],
                    1).astype(np.int32)
    embed = np.stack([rs.randint(0, 5001, n), rs.randint(0, 1001, n)],
                     1).astype(np.int32)
    cont = rs.randn(n, 11).astype(np.float32)
    y = ((wide[:, 0] + wide[:, 1]) % 2).astype(np.int32)
    fs = FeatureSet.from_ndarrays([wide, embed, cont], y).cache(
        CacheLevel.DEVICE)
    reset_name_scope()
    init = export_params(WideAndDeep(**kw).model)

    def run():
        reset_name_scope()
        m = WideAndDeep(**kw)
        load_jax_params(m.model, init)
        m.compile("adam", "sparse_categorical_crossentropy",
                  compute_dtype=compute_dtype)
        hist = m.fit(fs, batch_size=512, epochs=2, verbose=False)
        return [h["loss"] for h in hist], export_params(m.model), m.estimator

    context.init_zoo_context(steps_per_execution=4)
    try:
        f0, b0 = teb.LAUNCHES.value, teb.BWD_LAUNCHES.value
        loss, got, est = run()
        assert est.last_data_path == "device_resident"
        assert teb.LAUNCHES.value - f0 == 3 * 16
        assert teb.BWD_LAUNCHES.value - b0 == 3 * 16
        assert est._programs and all(p.graph.captured
                                     for p in est._programs.values())
        with graphs.disabled():
            eager_loss, want, _ = run()
    finally:
        context.set_zoo_context(None)
    np.testing.assert_allclose(loss, eager_loss, rtol=1e-6)
    assert loss[1] < loss[0]
    assert _tree_rel_diff(got, want) <= 1e-6


def _text_models():
    """The text slice's four models at small widths, with their inputs
    (numpy, seeded), on the CPU."""
    from analytics_zoo_tpu_torch.models import (KNRM, AnomalyDetector,
                                                Seq2seq, TextClassifier)
    from analytics_zoo_tpu_torch.nn import reset_name_scope

    rs = np.random.RandomState(21)
    reset_name_scope()
    out = {"cnn": (TextClassifier(5, token_length=16, sequence_length=40,
                                  encoder_output_dim=32, max_words_num=300,
                                  device="cpu"),
                   [rs.randint(0, 301, (9, 40)).astype(np.int32)])}
    reset_name_scope()
    out["lstm"] = (TextClassifier(5, token_length=16, sequence_length=40,
                                  encoder="lstm", encoder_output_dim=32,
                                  max_words_num=300, device="cpu"),
                   out["cnn"][1])
    reset_name_scope()
    out["knrm"] = (KNRM(6, 20, max_words_num=300, embed_size=24,
                        device="cpu"),
                   [rs.randint(1, 301, (9, 6)).astype(np.int32),
                    rs.randint(1, 301, (9, 20)).astype(np.int32)])
    reset_name_scope()
    enc = rs.randint(2, 300, (9, 7)).astype(np.int32)
    out["seq2seq"] = (Seq2seq(300, embed_dim=16, num_layers=2,
                              hidden_size=32, bridge_type="dense",
                              device="cpu"), [enc, enc])
    reset_name_scope()
    out["anomaly"] = (AnomalyDetector((12, 1), device="cpu"),
                      [rs.randn(9, 12, 1).astype(np.float32)])
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["cnn", "lstm", "knrm", "seq2seq",
                                  "anomaly"])
def test_text_slice_models_on_card_match_plain(cuda_device, kind):
    """Each model's forward on the card through the kernels against the
    plain route on the card and against the CPU (f32 sums in other
    orders: atol 1e-4)."""
    import copy

    from analytics_zoo_tpu_torch.ops import dispatch

    m, xs = _text_models()[kind]
    net = m.model.eval()
    want = net(*[torch.from_numpy(x) for x in xs]).detach()
    card = copy.deepcopy(net).to(cuda_device)
    ins = [torch.from_numpy(x).to(cuda_device) for x in xs]
    n0 = teb.LAUNCHES.value
    with torch.no_grad():
        got = card(*ins)
        torch.cuda.synchronize()
        launched = teb.LAUNCHES.value - n0
        with dispatch.forced("reference"):
            plain = card(*ins)
    assert launched == {"cnn": 1, "lstm": 1, "knrm": 2, "seq2seq": 2,
                        "anomaly": 0}[kind]
    torch.testing.assert_close(got, plain, rtol=0, atol=1e-4)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("weight_dtype", ["float32", "int8"])
def test_seq2seq_graphed_infer_matches_eager_on_card(cuda_device,
                                                     weight_dtype):
    """Greedy and beam decoding replayed from their CUDA graphs against
    the same decoders run eagerly (``graphs.disabled``): equal tokens,
    beam scores within 1e-5; kernel 3 launches at every int8 step."""
    from analytics_zoo_tpu_torch.core import graphs

    from analytics_zoo_tpu_torch.models import Seq2seq
    from analytics_zoo_tpu_torch.nn import reset_name_scope

    reset_name_scope()
    m = Seq2seq(300, embed_dim=16, num_layers=2, hidden_size=32,
                bridge_type="dense", device=cuda_device)
    enc = np.random.RandomState(22).randint(2, 300, (9, 7)).astype(np.int32)
    m.inference_model(weight_dtype=weight_dtype)
    kw = dict(start_sign=1, max_seq_len=9, stop_sign=2)
    for _ in range(3):          # eager, captured, replayed
        toks = m.infer(enc, **kw)
        seq, sc = m.infer_beam(enc, beam_size=3, length_penalty=0.6, **kw)
    assert all(p.graph.captured and p.graph.replays
               for p in m._decoders.values())
    n0 = tdq.LAUNCHES.value
    with graphs.disabled():
        e_toks = m.infer(enc, **kw)
        e_seq, e_sc = m.infer_beam(enc, beam_size=3, length_penalty=0.6,
                                   **kw)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(toks, e_toks)
    np.testing.assert_array_equal(seq, e_seq)
    np.testing.assert_allclose(sc, e_sc, rtol=0, atol=1e-5)
    assert (tdq.LAUNCHES.value - n0 == 2 * 9) == (weight_dtype == "int8")


@pytest.mark.cuda
@pytest.mark.parametrize("jit", [True, False])
def test_from_function_runs_on_card_by_default(cuda_device, jit):
    """``from_function`` with no device serves on the card: ``jit=True``
    from bucket graphs (captured at a signature's second batch, then
    replayed), ``jit=False`` eagerly; answers equal the function on the
    CPU within atol 1e-6 + rtol 1e-5."""
    from analytics_zoo_tpu_torch.deploy import InferenceModel

    rs = np.random.RandomState(30)
    w = rs.randn(6, 4).astype(np.float32)
    wd = torch.from_numpy(w).to(cuda_device)

    def fn(x):
        return torch.tanh(x @ (wd if x.is_cuda else torch.from_numpy(w)))

    m = InferenceModel.from_function(fn, jit=jit, batch_buckets=(1, 4, 8))
    assert m.device.type == "cuda"
    for n in (1, 1, 1, 3, 3, 4, 8, 8, 13):
        x = rs.randn(n, 6).astype(np.float32)
        np.testing.assert_allclose(m.predict(x), fn(torch.from_numpy(x)),
                                   atol=1e-6, rtol=RTOL)
    if jit:
        assert all(p.graph.captured and p.graph.replays
                   for p in m._programs.values())


@pytest.mark.cuda
def test_load_torch_runs_on_card_by_default(cuda_device, tmp_path):
    from analytics_zoo_tpu_torch.deploy import InferenceModel

    torch.manual_seed(0)
    module = torch.nn.Sequential(torch.nn.Linear(6, 8), torch.nn.Tanh(),
                                 torch.nn.Dropout(0.5),
                                 torch.nn.Linear(8, 3))
    path = str(tmp_path / "m.pt")
    torch.jit.script(module).save(path)
    x = np.random.RandomState(31).randn(5, 6).astype(np.float32)
    with torch.no_grad():
        want = module.eval()(torch.from_numpy(x)).numpy()
    for src in (module, path):
        m = InferenceModel.load_torch(src)
        assert next(m._torch_model.parameters()).is_cuda
        np.testing.assert_allclose(m.predict(x), want, atol=1e-6, rtol=RTOL)
    assert not next(module.parameters()).is_cuda


@pytest.mark.cuda
def test_capture_in_another_thread_than_the_warm_up(cuda_device):
    """A bucket signature warmed up by one thread and captured by another
    (a server's coverage pass, then its executor) serves: the capturing
    thread makes its cuBLAS handles before the capture, which making
    them inside would invalidate."""
    import threading

    from analytics_zoo_tpu_torch.deploy import (ClusterServing, InputQueue,
                                                MemoryQueue, OutputQueue,
                                                ServingConfig)
    from analytics_zoo_tpu_torch.loadgen.server_main import build_model

    m = build_model("cuda")
    x = np.random.RandomState(32).randn(8, 12).astype(np.float32)
    (rep,) = m.replica_forwards(1)
    for b in m.batch_buckets:          # warm-ups, in this thread
        rep.harvest(rep.dispatch([x[:b]]))
    out = {}

    def other():                       # captures, then replays
        for _ in range(3):
            out[len(out)] = rep.harvest(rep.dispatch([x[:4]]))[0]

    t = threading.Thread(target=other)
    t.start()
    t.join(60)
    assert not t.is_alive() and len(out) == 3
    q = MemoryQueue()
    srv = ClusterServing(m, q, ServingConfig(batch_size=8)).start()
    try:
        inq, outq = InputQueue(q), OutputQueue(q)
        for i in range(24):
            inq.enqueue(f"r{i}", x=x[i % 8])
        got = [np.asarray(outq.query(f"r{i}", timeout=30.0))
               for i in range(24)]
    finally:
        srv.stop()
    with torch.no_grad():
        want = m.predict(x)
    for i, g in enumerate(got):
        np.testing.assert_allclose(g, want[i % 8], atol=1e-5, rtol=RTOL)
    np.testing.assert_allclose(out[2], want[:4], atol=1e-5, rtol=RTOL)
    # the 4-row signature, warmed up here, was captured in the thread
    assert any(p.graph.captured and p.inputs[0].shape[0] == 4
               for p in m._programs.values())
