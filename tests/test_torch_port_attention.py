"""The PyTorch port's attention slice against the JAX package: the
flash-attention function, the attention ops, the attention layers, and
BERTClassifier / BERTNER / BERTSQuAD served through ``InferenceModel``.

Inputs and weights come from ``np.random.RandomState``; weights are made
in the JAX package's tree layout, used as they are by the JAX side and
loaded by the port with ``load_jax_params``.  The JAX flash kernel runs in
Pallas interpret mode; on the CPU the port's ``flash_attention`` takes its
plain PyTorch version.  Everything runs on the CPU (``device="cpu"``).
Each test states its tolerance; f32 sums in another order differ by a
few ulps of the largest term.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.deploy.inference import InferenceModel as JaxIM
from analytics_zoo_tpu.nn import reset_name_scope as jax_reset_names
from analytics_zoo_tpu.nn.layers import attention as jattn
from analytics_zoo_tpu.nn.layers.normalization import LayerNorm as JLN
from analytics_zoo_tpu.tfpark import text_estimators as jtext

from analytics_zoo_tpu_torch.convert import export_params, load_jax_params
from analytics_zoo_tpu_torch.core import context
from analytics_zoo_tpu_torch.deploy import DynamicBatcher, InferenceModel
from analytics_zoo_tpu_torch.nn import reset_name_scope
from analytics_zoo_tpu_torch.nn.layers import (
    BERT, GlobalAveragePooling1D, GlobalMaxPooling1D, LayerNorm,
    MultiHeadAttention, TransformerBlock, TransformerLayer)
from analytics_zoo_tpu_torch.observe.metrics import METRICS
from analytics_zoo_tpu_torch.ops import attention as tops
from analytics_zoo_tpu_torch.ops import dispatch
from analytics_zoo_tpu_torch.ops import flash_attention as tfa
from analytics_zoo_tpu_torch.tfpark import BERTClassifier, BERTNER, BERTSQuAD

# the JAX package's ops/__init__ re-exports functions under the module
# names, so the modules are fetched by path
jops = importlib.import_module("analytics_zoo_tpu.ops.attention")
jfa = importlib.import_module("analytics_zoo_tpu.ops.flash_attention")

SMALL = dict(vocab=300, hidden_size=128, n_block=2, nhead=2,
             intermediate_size=256, max_position_len=64)
BASE = dict(vocab=30522, hidden_size=768, n_block=2, nhead=12,
            intermediate_size=3072, max_position_len=512)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads for the port's CPU matmuls: the tier-1 run
    shares the host's cores among its workers and their timing tests."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def fresh_context():
    context.set_zoo_context(None)
    yield
    context.set_zoo_context(None)


def _qkv(b, h, lq, lk, d, seed=0):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(b, h, n, d).astype(np.float32)
                 for n in (lq, lk, lk))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _seeded(tree, seed, scale=0.05):
    """Seeded weights in ``tree``'s layout: LayerNorm gains near 1, every
    other leaf randn * ``scale``."""
    rs = np.random.RandomState(seed)

    def fill(path, x):
        shape = np.shape(x)
        name = str(path[-1].key) if path else ""
        if name == "gamma":
            return (1.0 + 0.1 * rs.randn(*shape)).astype(np.float32)
        return (scale * rs.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _selected(window):
    return {k: v for k, v in METRICS.delta(window)["counters"].items()
            if k.startswith("ops_kernel_selected_total{")}


# ---------------------------------------------------------------------------
# the kernel module: ops/flash_attention.py


FLASH_CASES = [
    # (b, h, lq, lk, d, causal)
    (1, 2, 256, 256, 64, False),
    (1, 2, 256, 256, 64, True),
    (1, 2, 256, 256, 128, False),
    (1, 2, 256, 256, 128, True),
    (2, 2, 77, 77, 64, False),          # ragged: no block divides 77 but 77
    (2, 2, 77, 77, 64, True),
    (1, 2, 128, 256, 64, True),         # causal Lq < Lk
    (1, 2, 256, 128, 64, True),         # causal Lq > Lk: leading zero rows
]


@pytest.mark.parametrize("b,h,lq,lk,d,causal", FLASH_CASES)
def test_flash_plain_matches_jax_kernel(b, h, lq, lk, d, causal):
    """The port's flash_attention on the CPU (its plain version) against
    the JAX Pallas kernel in interpret mode: atol 2e-5."""
    q, k, v = _qkv(b, h, lq, lk, d, seed=lq + lk + d)
    want = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), causal, None, 128,
                                          128, True))
    window = METRICS.snapshot()
    got = tfa.flash_attention(*_t(q, k, v), causal=causal).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    assert _selected(window) == {
        'ops_kernel_selected_total{kernel="flash_attention",'
        'path="reference"}': 1}
    if causal and lq > lk:
        # rows with no live key come out exactly 0 on both sides
        assert not got[:, :, :lq - lk].any()
        assert not want[:, :, :lq - lk].any()


def test_flash_scale_and_bf16_on_cpu():
    """An explicit sm_scale (atol 2e-5), and bfloat16 inputs: f32 inside,
    so the bf16 result is the f32 result on the same (rounded) inputs up
    to one bf16 rounding of the output (|out| < 2: atol 4e-3)."""
    q, k, v = _qkv(1, 2, 64, 96, 32, seed=3)
    want = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), False, 0.3, 128,
                                          128, True))
    got = tfa.flash_attention(*_t(q, k, v), sm_scale=0.3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    qkv16 = [x.to(torch.bfloat16) for x in _t(q, k, v)]
    bf = tfa.flash_attention(*qkv16, sm_scale=0.3)
    assert bf.dtype == torch.bfloat16
    want16 = tfa.flash_attention(*(x.float() for x in qkv16), sm_scale=0.3)
    assert float(want16.abs().max()) < 2.0
    np.testing.assert_allclose(bf.float().numpy(), want16.numpy(), rtol=0,
                               atol=4e-3)


def test_flash_shape_checks():
    q = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="heads or head width"):
        tfa.flash_attention(q, torch.zeros(1, 3, 4, 8), torch.zeros(1, 3, 4, 8))
    with pytest.raises(ValueError, match=r"\(B, H, Lk, D\)"):
        tfa.flash_attention(q, torch.zeros(1, 2, 4, 8), torch.zeros(1, 2, 5, 8))


def test_flash_plain_is_differentiable_on_cpu():
    """On the CPU the plain version trains: its gradient equals that of
    the reference attention (atol 1e-5)."""
    q, k, v = _t(*_qkv(1, 2, 16, 24, 8, seed=5))
    grads = []
    for fn in (lambda a, b, c: tfa.flash_attention(a, b, c, causal=True),
               lambda a, b, c: tops.reference_attention(a, b, c,
                                                        causal=True)):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        (fn(*xs) ** 2).sum().backward()
        grads.append([x.grad for x in xs])
    for g, r in zip(*grads):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# ops/attention.py


def _mask(b, lq, lk, seed):
    m = np.random.RandomState(seed).rand(b, 1, lq, lk) > 0.3
    m[:, :, :, 0] = True
    return m


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_reference_attention_matches_jax(causal, masked):
    """atol 2e-5."""
    q, k, v = _qkv(2, 3, 24, 40, 16, seed=7)
    m = _mask(2, 24, 40, 1) if masked else None
    want = jops.reference_attention(*map(jnp.asarray, (q, k, v)), mask=m,
                                    causal=causal)
    got = tops.reference_attention(
        *_t(q, k, v), mask=None if m is None else torch.from_numpy(m),
        causal=causal)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("case", ["padding_mask", "ragged_lk",
                                  "causal_cross", "causal_cross_ragged"])
def test_blockwise_attention_matches_jax(case):
    """Padding mask, a ragged last key block, causal with Lq != Lk:
    atol 2e-5."""
    lq, lk, causal, masked = {
        "padding_mask": (32, 48, False, True),
        "ragged_lk": (16, 37, False, False),
        "causal_cross": (16, 48, True, False),
        "causal_cross_ragged": (40, 21, True, True)}[case]
    q, k, v = _qkv(2, 2, lq, lk, 8, seed=lq * lk)
    m = _mask(2, lq, lk, 2) if masked else None
    want = jops.blockwise_attention(*map(jnp.asarray, (q, k, v)), mask=m,
                                    causal=causal, block_size=16)
    got = tops.blockwise_attention(
        *_t(q, k, v), mask=None if m is None else torch.from_numpy(m),
        causal=causal, block_size=16)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5)


def test_online_softmax_fold_matches_jax():
    """One fold from a running state with a fully masked row: atol 1e-6."""
    rs = np.random.RandomState(4)
    logits = rs.randn(1, 2, 3, 5).astype(np.float32)
    logits[0, 0, 1] = -1e30
    vals = rs.randn(1, 2, 5, 4).astype(np.float32)
    m = np.full((1, 2, 3), -1e30, np.float32)
    m[0, 1] = 0.5
    l = np.abs(rs.randn(1, 2, 3)).astype(np.float32)
    acc = rs.randn(1, 2, 3, 4).astype(np.float32)
    want = jops.online_softmax_fold(*map(jnp.asarray,
                                         (m, l, acc, logits, vals)))
    got = tops.online_softmax_fold(*_t(m, l, acc, logits, vals))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-6)


@pytest.mark.parametrize("lq,lk,masked,path", [
    (16, 16, False, "reference"),       # no mask: the flash route
    (16, 16, True, "reference"),        # masked, tiny: reference_attention
    (300, 300, True, "reference"),      # masked, long: blockwise
])
def test_dot_product_attention_matches_jax(lq, lk, masked, path):
    """The router against the JAX router, and its counted route on the
    CPU: atol 2e-5."""
    q, k, v = _qkv(1, 2, lq, lk, 8, seed=lq)
    m = _mask(1, lq, lk, 3) if masked else None
    want = jops.dot_product_attention(*map(jnp.asarray, (q, k, v)), mask=m)
    window = METRICS.snapshot()
    got = tops.dot_product_attention(
        *_t(q, k, v), mask=None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5)
    assert _selected(window) == {
        f'ops_kernel_selected_total{{kernel="flash_attention",'
        f'path="{path}"}}': 1}


def test_dot_product_attention_routes(monkeypatch):
    """An unmasked call takes flash_attention (the kernel on the card);
    a mask or dropout never does, even when the kernel is forced;
    use_flash=True with a mask raises as in the JAX package."""
    q, k, v = _t(*_qkv(1, 2, 8, 8, 4))
    taken = []
    monkeypatch.setattr(tops, "flash_attention",
                        lambda *a, **kw: taken.append(1) or a[0])
    tops.dot_product_attention(q, k, v)
    assert taken == [1]
    mask = torch.ones(1, 1, 8, 8, dtype=torch.bool)
    with dispatch.forced(dispatch.PATH_CUDA):
        tops.dot_product_attention(q, k, v, mask=mask)
        tops.dot_product_attention(q, k, v, dropout_rate=0.5,
                                   dropout_generator=torch.Generator())
    tops.dot_product_attention(q, k, v, use_flash=False)
    assert taken == [1]
    with pytest.raises(ValueError, match="does not take a mask"):
        tops.dot_product_attention(q, k, v, mask=mask, use_flash=True)


@pytest.mark.parametrize("d,dtype,flash", [
    (128, torch.float32, True), (64, torch.bfloat16, True),
    (160, torch.float32, False), (256, torch.float32, False),
    (64, torch.float16, False), (64, torch.float64, False)])
def test_router_predicate_follows_the_kernel_limits(d, dtype, flash):
    """``takes_flash``, the router's own predicate, says "the kernel" only
    for float32 / bfloat16 and D <= 128 with no mask and no dropout, on
    any device."""
    q = torch.zeros(1, 2, 8, d, dtype=dtype)
    assert tops.takes_flash(q, q) is flash
    assert not tops.takes_flash(q, q, mask=torch.ones(1, 1, 8, 8))
    assert not tops.takes_flash(q, q, dropping=True)


@pytest.mark.parametrize("lq,lk", [(12, 20), (300, 280)])
def test_router_takes_the_other_route_where_the_kernel_cannot(monkeypatch,
                                                              lq, lk):
    """D = 160 on the CPU: the router never calls ``flash_attention``,
    counts one flash_attention/reference selection and answers as the
    JAX router, whose kernel limits send the call the same way
    (reference_attention when tiny, blockwise_attention past 256²):
    atol 2e-5."""
    q, k, v = _qkv(1, 2, lq, lk, 160, seed=lq)
    taken = []
    monkeypatch.setattr(tops, "flash_attention",
                        lambda *a, **kw: taken.append(1))
    window = METRICS.snapshot()
    got = tops.dot_product_attention(*_t(q, k, v), causal=True)
    assert taken == []
    assert _selected(window) == {
        'ops_kernel_selected_total{kernel="flash_attention",'
        'path="reference"}': 1}
    want = jops.dot_product_attention(*map(jnp.asarray, (q, k, v)),
                                      causal=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("lq,lk,masked", [(12, 20, False), (300, 280, False),
                                          (12, 20, True)])
def test_router_float16_matches_jax(lq, lk, masked):
    """float16, which the kernel cannot take, answers by the other route
    as in the JAX package: the masked logits' -1e30 becomes -inf in
    float16 there, where a Python -1e30 cannot fill a float16 tensor.
    Causal, tiny (reference_attention) and past 256² (blockwise), with and
    without a mask: within two float16 roundings (atol 2e-3 + rtol
    2e-3)."""
    rs = np.random.RandomState(lq + lk)
    q, k, v = (rs.randn(1, 2, n, 64).astype(np.float16) for n in (lq, lk, lk))
    m = (rs.rand(1, 1, lq, lk) > 0.3) if masked else None
    want = jops.dot_product_attention(*map(jnp.asarray, (q, k, v)), mask=m,
                                      causal=True)
    window = METRICS.snapshot()
    got = tops.dot_product_attention(
        *_t(q, k, v), mask=None if m is None else torch.from_numpy(m),
        causal=True)
    assert got.dtype == torch.float16
    assert _selected(window) == {
        'ops_kernel_selected_total{kernel="flash_attention",'
        'path="reference"}': 1}
    np.testing.assert_allclose(_np(got.float()), np.asarray(want, np.float32),
                               rtol=2e-3, atol=2e-3)


def test_prob_dropout_unbiased():
    """Blockwise probability dropout: rate 0 is exactly the undropped
    path, and the mean over 64 generators is the undropped output
    (atol 0.15, as the JAX package's test)."""
    q, k, v = _t(*_qkv(2, 3, 8, 64, 8))
    base = tops.blockwise_attention(q, k, v, block_size=16)
    same = tops.blockwise_attention(q, k, v, block_size=16, dropout_rate=0.0,
                                    dropout_generator=torch.Generator())
    assert torch.equal(base, same)
    outs = [tops.blockwise_attention(
        q, k, v, block_size=16, dropout_rate=0.3,
        dropout_generator=torch.Generator().manual_seed(s))
        for s in range(64)]
    assert not torch.equal(outs[0], outs[1])
    np.testing.assert_allclose(torch.stack(outs).mean(0).numpy(),
                               base.numpy(), atol=0.15)


# ---------------------------------------------------------------------------
# layers


def _load(layer, jparams, shape, seed=0):
    layer.build(torch.Generator().manual_seed(seed), shape)
    params = _seeded(jparams, seed)
    load_jax_params(layer, params)
    return params, layer.eval()


def test_layernorm_matches_jax():
    """atol 1e-5."""
    x = np.random.RandomState(0).randn(3, 5, 32).astype(np.float32) * 3 + 1
    jln = JLN(name="ln_t")
    params = _seeded(jln.build_params(None, (1, 32)), 1)
    ln = LayerNorm(name="ln")
    _load(ln, params, (1, 32), seed=1)
    assert set(ln.params()) == {"gamma", "beta"}
    np.testing.assert_allclose(ln(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jln.forward(params, x)), atol=1e-5)


@pytest.mark.parametrize("form", ["self", "cross", "mask2d", "mask4d",
                                  "cross_mask3d", "causal"])
def test_multihead_attention_matches_jax(form):
    """Self and cross attention, 2-D / 3-D / 4-D masks, causal: atol
    2e-5."""
    rs = np.random.RandomState(2)
    x = rs.randn(2, 12, 128).astype(np.float32)
    kv = rs.randn(2, 20, 128).astype(np.float32)
    causal = form == "causal"
    jm = jattn.MultiHeadAttention(2, 128, causal=causal, name="mha_j")
    tm = MultiHeadAttention(2, 128, causal=causal, name="mha_t")
    shapes = [(2, 12, 128)] + ([(2, 20, 128)] if "cross" in form else [])
    params = _seeded(jm.build_params(jax.random.PRNGKey(0), *shapes), 3)
    tm.build(torch.Generator(), *shapes)
    load_jax_params(tm, params)
    tm.eval()
    inputs = {"self": [x], "causal": [x], "cross": [x, kv],
              "mask2d": [x, (rs.rand(2, 12) > 0.3).astype(np.int32)],
              "mask4d": [x, (rs.rand(2, 1, 12, 12) > 0.3).astype(np.int32)],
              "cross_mask3d": [x, kv,
                               (rs.rand(2, 12, 20) > 0.3).astype(np.int32)]
              }[form]
    want = jm.forward(params, *map(jnp.asarray, inputs))
    got = tm(*(torch.from_numpy(a) for a in inputs))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("after_norm", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_transformer_block_matches_jax(after_norm, masked):
    """Post-LN and pre-LN, with and without a padding mask: atol 5e-5."""
    rs = np.random.RandomState(3)
    x = rs.randn(2, 10, 128).astype(np.float32)
    jb = jattn.TransformerBlock(2, 128, 256, after_norm=after_norm,
                                name="blk_j")
    tb = TransformerBlock(2, 128, 256, after_norm=after_norm, name="blk_t")
    params, tb = _load(tb, jb.build_params(jax.random.PRNGKey(0),
                                           (2, 10, 128)), (2, 10, 128))
    args = [x] + ([(rs.rand(2, 10) > 0.3).astype(np.int32)] if masked
                  else [])
    want = jb.forward(params, *map(jnp.asarray, args))
    got = tb(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=5e-5)


@pytest.mark.parametrize("stacked", [False, True])
def test_transformer_layer_matches_jax(stacked):
    """Causal decoder stack, stacked and unstacked trees, with and without
    position ids, topped by the global poolings: atol 5e-5."""
    rs = np.random.RandomState(4)
    ids = rs.randint(0, 100, (2, 16)).astype(np.int32)
    pos = np.tile(np.arange(16)[::-1], (2, 1)).astype(np.int32)
    kw = dict(vocab=100, seq_len=16, n_block=2, nhead=2, hidden_size=128,
              stacked=stacked)
    jl = jattn.TransformerLayer(name="tl_j", **kw)
    tl = TransformerLayer(name="tl_t", **kw)
    params, tl = _load(tl, jl.build_params(jax.random.PRNGKey(0), (2, 16)),
                       (2, 16))
    tree = export_params(tl)
    assert ("blocks" in tree) == stacked and ("block1" in tree) != stacked
    for extra in ([], [pos]):
        want = np.asarray(jl.forward(params, *map(jnp.asarray,
                                                  [ids] + extra)))
        got = tl(*(torch.from_numpy(a) for a in [ids] + extra))
        np.testing.assert_allclose(_np(got), want, atol=5e-5)
    from analytics_zoo_tpu.nn.layers.pooling import (
        GlobalAveragePooling1D as JAvg, GlobalMaxPooling1D as JMax)
    for jp, tp in ((JAvg(), GlobalAveragePooling1D()),
                   (JMax(), GlobalMaxPooling1D())):
        np.testing.assert_allclose(_np(tp(got)),
                                   np.asarray(jp.forward({}, jnp.asarray(
                                       np.asarray(_np(got))))), atol=1e-6)
        assert tp.output_shape((2, 16, 128)) == (2, 128)


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_bert_layer_matches_jax(stacked, masked):
    """The encoder's sequence and pooled outputs, with and without an
    attention mask (positions then given as 0..L-1): atol 5e-5."""
    rs = np.random.RandomState(5)
    ids = rs.randint(0, 300, (2, 16)).astype(np.int32)
    seg = rs.randint(0, 2, (2, 16)).astype(np.int32)
    kw = dict(SMALL, stacked=stacked)
    jb = jattn.BERT(name="bert_j", **kw)
    tb = BERT(name="bert_t", **kw)
    params, tb = _load(tb, jb.build_params(jax.random.PRNGKey(0), (2, 16)),
                       (2, 16))
    args = [ids, seg]
    if masked:
        mask = np.ones((2, 16), np.int32)
        mask[1, 10:] = 0
        args += [np.tile(np.arange(16), (2, 1)).astype(np.int32), mask]
    want = jb.forward(params, *map(jnp.asarray, args))
    got = tb(*(torch.from_numpy(a) for a in args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=5e-5)


def test_unported_branches_raise():
    """Ring attention over seq_shards and the sp/pp regimes need the
    multi-GPU slice: they raise, never run locally."""
    x = torch.zeros(1, 4, 8)
    mha = MultiHeadAttention(2, 8, seq_shards=2, name="mha_ring")
    mha.build(torch.Generator(), (1, 4, 8))
    with pytest.raises(NotImplementedError, match="A9"):
        mha.eval()(x)
    context.init_zoo_context(seq_shards=4)
    mha = MultiHeadAttention(2, 8, name="mha_knob")
    mha.build(torch.Generator(), (1, 4, 8))
    with pytest.raises(NotImplementedError, match="A9"):
        mha.eval()(x)
    reset_name_scope()
    net = BERTClassifier(2, bert_config=dict(vocab=20, n_block=1))
    for sharding in ("sp", "pp"):
        with pytest.raises(NotImplementedError, match="A9"):
            net.compile("adam", "sparse_categorical_crossentropy",
                        device="cpu", sharding=sharding)


# ---------------------------------------------------------------------------
# the served models


def _bert_models(cls_name, cfg, seed=0, L=16, **kw):
    jax_reset_names()
    jcls = getattr(jtext, cls_name)
    jnet = jcls(bert_config=cfg, **kw)
    jparams, _ = jnet.build(jax.random.PRNGKey(0), (2, L), (2, L))
    params = _seeded(jparams, seed, scale=0.02)
    reset_name_scope()
    tnet = {"BERTClassifier": BERTClassifier, "BERTNER": BERTNER,
            "BERTSQuAD": BERTSQuAD}[cls_name](bert_config=cfg, **kw)
    return jnet, tnet, params


def _inputs(vocab, n, L, seed, masked=False):
    rs = np.random.RandomState(seed)
    xs = [rs.randint(0, vocab, (n, L)).astype(np.int32),
          rs.randint(0, 2, (n, L)).astype(np.int32)]
    if masked:
        mask = np.ones((n, L), np.int32)
        for r in range(n):
            mask[r, rs.randint(L // 2, L + 1):] = 0
        xs.append(mask)
    return xs


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cls_name,kw", [
    ("BERTClassifier", dict(num_classes=3)),
    ("BERTNER", dict(num_classes=5)),
    ("BERTSQuAD", {}),
])
def test_served_bert_tasks_match_jax(cls_name, kw, masked):
    """Each task served through the port's InferenceModel against the
    JAX InferenceModel from the same weights, 10 requests (padded to the
    16-row bucket): atol 5e-5 on the logits."""
    jnet, tnet, params = _bert_models(cls_name, SMALL, **kw)
    xs = _inputs(300, 10, 16, seed=1, masked=masked)
    jm = JaxIM.from_keras_net(jnet, _jnp(params), {}, batch_buckets=(4, 16))
    tm = InferenceModel.from_keras_net(tnet, params, device="cpu",
                                       batch_buckets=(4, 16))
    want, got = jm.predict(xs), tm.predict(xs)
    if cls_name == "BERTSQuAD":
        assert isinstance(got, list) and len(got) == 2
        assert [g.shape for g in got] == [(10, 16), (10, 16)]
    else:
        want, got = [want], [got]
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=5e-5)
    assert tm.compile_count == 1


def test_served_bert_base_width_matches_jax():
    """BERT-Base widths (vocab 30522, hidden 768, 12 heads, intermediate
    3072) with 2 blocks, B = 2, L = 128: atol 1e-4 on the logits."""
    jnet, tnet, params = _bert_models("BERTClassifier", BASE, L=128,
                                      num_classes=2)
    assert params["head"]["kernel"].shape == (768, 2)
    enc = params["bertclassifier_1_bert"]["enc1"]
    assert enc["attn"]["q"]["kernel"].shape == (768, 768)
    assert enc["ffn1"]["kernel"].shape == (768, 3072)
    xs = _inputs(30522, 2, 128, seed=2)
    want = JaxIM.from_keras_net(jnet, _jnp(params), {}).predict(xs)
    got = InferenceModel.from_keras_net(tnet, params,
                                        device="cpu").predict(xs)
    assert got.shape == (2, 2) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)


@pytest.mark.parametrize("weight_dtype", ["int8", "int4"])
def test_quantized_bert_serving_matches_jax(weight_dtype):
    """int8 / int4 weights: the port's quantized tree equals the JAX
    package's ``quantize_pytree`` of the same weights, and the served
    logits equal (atol 5e-5) the JAX model run on that tree dequantized —
    the JAX serving rule for a net with no top-level Dense layer (every
    leaf dequantized in the forward)."""
    from analytics_zoo_tpu.deploy.inference import (
        dequantize_pytree as jax_dequant, quantize_pytree as jax_quant)

    jnet, tnet, params = _bert_models("BERTClassifier", SMALL,
                                      num_classes=3)
    xs = _inputs(300, 6, 16, seed=3)
    qtree = jax_quant(params, bits=4 if weight_dtype == "int4" else 8)
    want = JaxIM.from_keras_net(jnet, _jnp(jax_dequant(qtree)),
                                {}).predict(xs)
    tm = InferenceModel.from_keras_net(tnet, params, device="cpu",
                                       weight_dtype=weight_dtype)
    np.testing.assert_allclose(tm.predict(xs), np.asarray(want), rtol=0,
                               atol=5e-5)
    flat_got = jax.tree_util.tree_leaves(export_params(tm._net))
    flat_want = jax.tree_util.tree_leaves(qtree)
    assert len(flat_got) == len(flat_want)
    for g, w in zip(flat_got, flat_want):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("weight_dtype,stacked", [
    ("int8", False), ("int4", False), ("int4", True)])
def test_quantized_bert_base_width_matches_jax(weight_dtype, stacked):
    """int8 / int4 ``BERTClassifier`` at BERT-Base widths (vocab 30522,
    hidden 768, 12 heads, intermediate 3072) with 2 blocks, B = 2,
    L = 128: the served logits equal (atol 5e-5) the JAX float model run
    on the JAX ``quantize_pytree`` tree, dequantized (reference fault 4).
    ``stacked=True`` in int4 follows the JAX rule: the 3-D stacked
    kernels stay int8, the 2-D stacked biases and LayerNorm leaves are
    packed int4 across blocks, and each block serves its row of them."""
    from analytics_zoo_tpu.deploy.inference import (
        dequantize_pytree as jax_dequant, quantize_pytree as jax_quant)

    cfg = dict(BASE, stacked=stacked)
    jnet, tnet, params = _bert_models("BERTClassifier", cfg, L=128,
                                      num_classes=2)
    bits = 4 if weight_dtype == "int4" else 8
    qtree = jax_quant(params, bits=bits)
    if stacked:
        blocks = qtree["bertclassifier_1_bert"]["blocks"]
        assert set(blocks["ffn1"]["kernel"]) == {"q", "scale"}
        assert set(blocks["ffn1"]["bias"]) == {"q4", "scale"}
        assert set(blocks["ln1"]["gamma"]) == {"q4", "scale"}
    xs = _inputs(30522, 2, 128, seed=4)
    want = JaxIM.from_keras_net(jnet, _jnp(jax_dequant(qtree)),
                                {}).predict(xs)
    tm = InferenceModel.from_keras_net(tnet, params, device="cpu",
                                       weight_dtype=weight_dtype)
    got = tm.predict(xs)
    assert got.shape == (2, 2) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=5e-5)
    # every Dense of the blocks, the pooler and the head holds its kernel
    # quantized, so the dequantize-matmul serves it
    from analytics_zoo_tpu_torch.nn.layers import Dense

    dense = [m for m in tm._net.modules() if isinstance(m, Dense)]
    assert len(dense) == 6 * 2 + 2
    assert all(m.qleaf("kernel") is not None for m in dense)
    kinds = {next(iter(set(m.qleaf("kernel")) - {"scale"})) for m in dense}
    if bits == 8:
        assert kinds == {"q"}
    elif stacked:               # the stacked kernels stay int8
        assert kinds == {"q", "q4"}
    else:
        assert kinds == {"q4"}


def test_bert_batcher_matches_direct_predict():
    """Single requests from threads through the DynamicBatcher, at two
    sequence lengths (two batch groups): equal to one direct predict."""
    import threading

    _, tnet, params = _bert_models("BERTClassifier", SMALL, num_classes=2)
    tm = InferenceModel.from_keras_net(tnet, params, device="cpu",
                                       batch_buckets=(1, 8))
    reqs = [_inputs(300, 1, L, seed=r) for r in range(12)
            for L in ((16,) if r % 3 else (32,))]
    want = [tm.predict(x) for x in reqs]
    batcher = DynamicBatcher(tm, max_batch=8, max_latency_ms=2.0)
    got = [None] * len(reqs)

    def client(rows):
        for r in rows:
            got[r] = batcher.predict(reqs[r])

    threads = [threading.Thread(target=client, args=(range(t, 12, 3),))
               for t in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    batcher.close()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# weights


@pytest.mark.parametrize("stacked", [False, True])
def test_nested_tree_round_trip_and_path_errors(stacked):
    """load_jax_params then export_params gives the tree back exactly, for
    the nested and the stacked layouts and for an int8-quantized tree; a
    wrong key or shape anywhere raises naming the full path, before any
    leaf changes."""
    from analytics_zoo_tpu_torch.deploy.inference import quantize_pytree

    cfg = dict(SMALL, stacked=stacked)
    _, tnet, params = _bert_models("BERTSQuAD", cfg, seed=6)
    load_jax_params(tnet, params)
    back = export_params(tnet)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)
    q8 = jax.tree_util.tree_map(
        lambda x: x.numpy() if isinstance(x, torch.Tensor) else x,
        quantize_pytree(params))
    load_jax_params(tnet, q8)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           export_params(tnet), q8)
    load_jax_params(tnet, params)

    bert = "bertsquad_1_bert"
    blk = "blocks" if stacked else "enc1"
    bad = jax.tree_util.tree_map(lambda x: x, params)
    bad[bert][blk]["attn"]["q"]["kernal"] = bad[bert][blk]["attn"]["q"].pop(
        "kernel")
    with pytest.raises(ValueError, match=rf"{bert}\.{blk}\.attn\.q: missing "
                                         rf"leaves \['kernel'\], extra "
                                         rf"leaves \['kernal'\]"):
        load_jax_params(tnet, bad)
    bad = jax.tree_util.tree_map(lambda x: x, params)
    bad[bert][blk]["ffn2"]["bias"] = np.zeros(7, np.float32)
    with pytest.raises(ValueError,
                       match=rf"{bert}\.{blk}\.ffn2\.bias: shape"):
        load_jax_params(tnet, bad)
    bad = jax.tree_util.tree_map(lambda x: x, params)
    bad["head"] = np.zeros((128, 2), np.float32)
    with pytest.raises(ValueError, match="head: expected a sub-tree"):
        load_jax_params(tnet, bad)
    bad = jax.tree_util.tree_map(lambda x: x, params)
    del bad["head"]
    with pytest.raises(ValueError, match=r"missing layers \['head'\]"):
        load_jax_params(tnet, bad)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           export_params(tnet), params)


def test_bert_fit_on_cpu_moves_every_leaf():
    """compile / fit from KerasNet train BERTClassifier on the CPU through
    the plain versions, dropout from the Estimator's generator included;
    the loss is finite and every leaf moves."""
    reset_name_scope()
    net = BERTClassifier(2, bert_config=dict(vocab=50, hidden_size=32,
                                             nhead=2, intermediate_size=64,
                                             max_position_len=16))
    before = export_params(net)
    xs = _inputs(50, 16, 8, seed=7)
    y = np.random.RandomState(8).randint(0, 2, 16).astype(np.int32)
    net.compile("adam", "sparse_categorical_crossentropy_with_logits",
                device="cpu")
    hist = net.fit(xs, y, batch_size=8, epochs=2, verbose=False)
    assert all(np.isfinite(h["loss"]) for h in hist)
    moved = jax.tree_util.tree_map(lambda a, b: bool(np.any(a != b)),
                                   export_params(net), before)
    assert all(jax.tree_util.tree_leaves(moved)), moved
