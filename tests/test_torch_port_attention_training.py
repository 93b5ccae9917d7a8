"""The PyTorch port's attention-training slice against the JAX package:
the flash-attention forward with logsumexp, its backward (dQ, dK/dV), the
autograd Function that joins them, and BERTClassifier / BERTNER /
BERTSQuAD trained through ``compile`` / ``fit``.

Inputs and weights come from ``np.random.RandomState``; the JAX Pallas
kernels run in interpret mode, and on the CPU the port's wrappers take
their plain PyTorch versions.  The kernels themselves are held against
those plain versions on the card by ``tests/test_torch_port_cuda.py`` and
``chip_smoke.py``.  Tolerances, with their reasons:

- kernel functions and gradients: atol 2e-5 on outputs, lse and
  gradients of magnitude up to about 5 (f32 sums over up to 256 terms in
  another order: a few ulps of the largest);
- BERT trained through ``fit``: per-epoch losses within rtol 1e-4 and
  weights within atol 1e-4 (the JAX step sums its gradients across an
  8-device CPU mesh, so the orders differ in every step), as the NCF
  slice test.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.nn import reset_name_scope as jax_reset_names
from analytics_zoo_tpu.tfpark import text_estimators as jtext

from analytics_zoo_tpu_torch.convert import export_params, load_jax_params
from analytics_zoo_tpu_torch.core import context
from analytics_zoo_tpu_torch.nn import objectives as tobj
from analytics_zoo_tpu_torch.nn import reset_name_scope
from analytics_zoo_tpu_torch.observe.metrics import METRICS
from analytics_zoo_tpu_torch.ops import attention as tops
from analytics_zoo_tpu_torch.ops import dispatch
from analytics_zoo_tpu_torch.ops import flash_attention as tfa
from analytics_zoo_tpu_torch.tfpark import BERTClassifier, BERTNER, BERTSQuAD
from analytics_zoo_tpu_torch.train import optimizers as topt

# the JAX package's ops/__init__ re-exports functions under the module
# names, so the modules are fetched by path
jfa = importlib.import_module("analytics_zoo_tpu.ops.flash_attention")
jobj = importlib.import_module("analytics_zoo_tpu.nn.objectives")
jopt = importlib.import_module("analytics_zoo_tpu.train.optimizers")

ATOL = 2e-5
SMALL = dict(vocab=300, hidden_size=128, n_block=2, nhead=2,
             intermediate_size=256, max_position_len=64, hidden_drop=0.0,
             attn_drop=0.0)
BASE_2 = dict(vocab=30522, hidden_size=768, n_block=2, nhead=12,
              intermediate_size=3072, max_position_len=512, hidden_drop=0.0,
              attn_drop=0.0)

FLASH_CASES = [
    # (b, h, lq, lk, d, causal): the attention slice's cases
    (1, 2, 256, 256, 64, False),
    (1, 2, 256, 256, 64, True),
    (1, 2, 256, 256, 128, False),
    (1, 2, 256, 256, 128, True),
    (2, 2, 77, 77, 64, False),          # ragged: no block divides 77 but 77
    (2, 2, 77, 77, 64, True),
    (1, 2, 128, 256, 64, True),         # causal Lq < Lk
    (1, 2, 256, 128, 64, True),         # causal Lq > Lk: rows with no key
]


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads for the port's CPU matmuls: the tier-1 run
    shares the host's cores among its workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def fresh_context():
    context.set_zoo_context(None)
    yield
    context.set_zoo_context(None)


def _case(b, h, lq, lk, d, seed):
    """q, k, v and an output gradient g, as numpy f32."""
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(b, h, n, d).astype(np.float32)
                 for n in (lq, lk, lk, lq))


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _jax_fwd_lse(q, k, v, causal):
    out, lse = jfa._flash_fwd(*map(jnp.asarray, (q, k, v)),
                              1.0 / np.sqrt(q.shape[-1]), causal, 128, 128,
                              True, with_lse=True)
    return np.asarray(out), np.asarray(lse)


def _selected(window):
    return {k: v for k, v in METRICS.delta(window)["counters"].items()
            if k.startswith("ops_kernel_selected_total{")}


# ---------------------------------------------------------------------------
# kernel 5: the forward with logsumexp


@pytest.mark.parametrize("b,h,lq,lk,d,causal", FLASH_CASES)
def test_flash_lse_matches_jax_kernel(b, h, lq, lk, d, causal):
    """``flash_attention_lse`` on the CPU (its plain version) against the
    JAX Pallas ``_fwd_lse_kernel`` in interpret mode: atol 2e-5 on out and
    lse; a row with no live key has lse -1e30 on both sides (rtol 1e-6).
    The result carries no graph, on any device."""
    q, k, v, _ = _case(b, h, lq, lk, d, seed=lq + lk + d)
    want_out, want_lse = _jax_fwd_lse(q, k, v, causal)
    window = METRICS.snapshot()
    out, lse = tfa.flash_attention_lse(
        *(x.requires_grad_(True) for x in _t(q, k, v)), causal=causal)
    assert _selected(window) == {
        'ops_kernel_selected_total{kernel="flash_attention",'
        'path="reference"}': 1}
    assert out.grad_fn is None and lse.grad_fn is None
    assert lse.dtype == torch.float32 and lse.shape == (b, h, lq)
    np.testing.assert_allclose(out.numpy(), want_out, rtol=0, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-6, atol=ATOL)
    if causal and lq > lk:
        assert np.all(lse.numpy()[:, :, :lq - lk] <= -1e29)


# ---------------------------------------------------------------------------
# kernels 6 and 7: the backward


@pytest.mark.parametrize("b,h,lq,lk,d,causal", FLASH_CASES)
def test_flash_bwd_matches_jax_kernels(b, h, lq, lk, d, causal):
    """``flash_attention_bwd`` on the CPU (the plain version) against the
    JAX ``_flash_bwd`` (``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` in
    interpret mode) on the same (q, k, v, out, lse, g): atol 2e-5.  Query
    rows with no live key get an exactly zero dQ."""
    q, k, v, g = _case(b, h, lq, lk, d, seed=3 * lq + lk + d)
    out, lse = _jax_fwd_lse(q, k, v, causal)
    want = jfa._flash_bwd(*map(jnp.asarray, (q, k, v, out, lse, g)),
                          1.0 / np.sqrt(d), causal, 128, 128, True)
    window = METRICS.snapshot()
    got = tfa.flash_attention_bwd(*_t(q, k, v, out, lse, g), causal=causal)
    assert _selected(window) == {
        'ops_kernel_selected_total{kernel="flash_attention_bwd",'
        'path="reference"}': 1}
    for name, gt, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL, err_msg=name)
    if causal and lq > lk:
        assert not got[0][:, :, :lq - lk].any()


def test_flash_bwd_takes_a_caller_lse_and_scale():
    """An explicit ``sm_scale`` and a caller-supplied (out, lse) — the
    ring backward passes the merged ones — against the JAX backward on the
    same residuals: atol 2e-5."""
    q, k, v, g = _case(1, 2, 64, 96, 32, seed=11)
    out, lse = jfa._flash_fwd(*map(jnp.asarray, (q, k, v)), 0.3, False, 128,
                              128, True, with_lse=True)
    lse = np.asarray(lse) + 0.25        # a different normaliser on purpose
    want = jfa._flash_bwd(*map(jnp.asarray, (q, k, v)), out,
                          jnp.asarray(lse), jnp.asarray(g), 0.3, False, 128,
                          128, True)
    got = tfa.flash_attention_bwd(*_t(q, k, v, np.asarray(out), lse, g),
                                  sm_scale=0.3)
    for gt, w in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL)


def test_flash_bwd_shape_checks():
    q = torch.zeros(1, 2, 4, 8)
    k = torch.zeros(1, 2, 6, 8)
    lse = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError, match=r"lse \(B, H, Lq\)"):
        tfa.flash_attention_bwd(q, k, k, q, lse[..., :3], q)
    with pytest.raises(ValueError, match="out and g shaped as q"):
        tfa.flash_attention_bwd(q, k, k, q, lse, k)
    with pytest.raises(ValueError, match="heads or head width"):
        tfa.flash_attention_bwd(q, torch.zeros(1, 2, 6, 4),
                                torch.zeros(1, 2, 6, 4), q, lse, q)


# ---------------------------------------------------------------------------
# the autograd Function


GRAD_CASES = [
    # (b, h, lq, lk, d, causal)
    (2, 2, 128, 128, 64, False),
    (2, 2, 77, 77, 64, True),           # ragged
    (1, 2, 128, 256, 64, True),         # causal cross, Lq < Lk
    (1, 2, 256, 128, 64, True),         # causal cross, Lq > Lk
    (2, 3, 40, 72, 32, False),          # cross lengths
]


@pytest.mark.parametrize("b,h,lq,lk,d,causal", GRAD_CASES)
def test_flash_grad_matches_jax_grad(b, h, lq, lk, d, causal):
    """``torch.autograd.grad`` through ``flash_attention`` against
    ``jax.grad`` of the JAX ``flash_attention`` (custom VJP over the
    Pallas kernels, interpret mode) for the loss sum(out * g): atol
    2e-5."""
    q, k, v, g = _case(b, h, lq, lk, d, seed=lq * 7 + lk + d)

    def loss(q_, k_, v_):
        out = jfa.flash_attention(q_, k_, v_, causal, None, 128, 128, True)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    xs = [x.requires_grad_(True) for x in _t(q, k, v)]
    out = tfa.flash_attention(*xs, causal=causal)
    got = torch.autograd.grad(out, xs, torch.from_numpy(g))
    for name, gt, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL, err_msg=name)


def test_flash_function_gradcheck_f64():
    """The plain backward is the true gradient of the plain forward:
    ``gradcheck`` in float64, causal with Lq > Lk (rows with no key) and
    a ragged key tile."""
    rs = np.random.RandomState(2)
    xs = [torch.from_numpy(rs.randn(1, 2, n, 8)).requires_grad_(True)
          for n in (7, 5, 5)]
    assert torch.autograd.gradcheck(
        lambda q, k, v: tfa.flash_attention(q, k, v, causal=True), xs)
    assert torch.autograd.gradcheck(
        lambda q, k, v: tfa.flash_attention(q, k, v, sm_scale=0.7), xs)


class _StubLaunches:
    """The kernel launches replaced by the plain versions, recording the
    route each call took, so the Function's card path runs on the CPU."""

    def __init__(self, monkeypatch):
        self.calls = []

        def fwd(q, k, v, causal, scale, with_lse=False):
            self.calls.append("fwd_lse" if with_lse else "fwd")
            if with_lse:
                return tfa.flash_attention_lse_reference(q, k, v, causal,
                                                         scale)
            return tfa.flash_attention_reference(q, k, v, causal, scale)

        def bwd(q, k, v, out, lse, g, causal, scale):
            self.calls.append("bwd")
            self.saved = (out, lse)
            return tfa.flash_attention_bwd_reference(q, k, v, out, lse, g,
                                                     causal, scale)

        monkeypatch.setattr(tfa, "_launch", fwd)
        monkeypatch.setattr(tfa, "_launch_bwd", bwd)


def test_flash_function_without_grad_takes_the_forward_kernel(monkeypatch):
    """With no gradient wanted — inputs that need none, ``no_grad``,
    ``inference_mode`` — the Function runs the forward kernel without lse
    and keeps no graph; with one, the lse kernel, saving (q, k, v, out,
    lse)."""
    stub = _StubLaunches(monkeypatch)
    q, k, v, _ = _t(*_case(1, 2, 24, 40, 16, seed=4))
    with dispatch.forced(dispatch.PATH_CUDA):
        assert tfa.flash_attention(q, k, v).grad_fn is None
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        with torch.no_grad():
            assert tfa.flash_attention(*xs).grad_fn is None
        with torch.inference_mode():
            assert tfa.flash_attention(*xs).grad_fn is None
        assert stub.calls == ["fwd"] * 3
        out = tfa.flash_attention(*xs, causal=True)
    assert stub.calls[-1] == "fwd_lse"
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5 and saved[4].shape == (1, 2, 24)
    assert saved[3].data_ptr() == out.data_ptr()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_function_backward_returns_the_plain_gradient(monkeypatch,
                                                            causal, dtype):
    """The Function's backward on the card path (launches stubbed by the
    plain versions) returns exactly the gradient of the CPU path, from the
    out and lse its forward saved; gradients come back in the inputs'
    dtype."""
    stub = _StubLaunches(monkeypatch)
    q, k, v, g = (x.to(dtype) for x in _t(*_case(2, 2, 33, 65, 24, seed=5)))
    grads = []
    for path in (dispatch.PATH_CUDA, dispatch.PATH_REFERENCE):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        with dispatch.forced(path):
            out = tfa.flash_attention(*xs, causal=causal)
            out.backward(g)
        grads.append([x.grad for x in xs])
    assert stub.calls == ["fwd_lse", "bwd"]
    assert stub.saved[1].dtype == torch.float32
    for a, b in zip(*grads):
        assert a.dtype == dtype
        assert torch.equal(a, b)


def test_flash_function_backward_of_an_expanded_gradient(monkeypatch):
    """``out.sum().backward()`` hands the backward a stride-0 gradient:
    the Function's gradient equals the reference attention's autograd
    (atol 1e-5)."""
    _StubLaunches(monkeypatch)
    q, k, v, _ = _t(*_case(1, 2, 16, 24, 8, seed=6))
    grads = []
    for fn in (lambda a, b, c: tfa.flash_attention(a, b, c, causal=True),
               lambda a, b, c: tops.reference_attention(a, b, c,
                                                        causal=True)):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        with dispatch.forced(dispatch.PATH_CUDA):
            fn(*xs).sum().backward()
        grads.append([x.grad for x in xs])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_flash_backward_routing_is_counted():
    """A training step through the Function counts one forward and one
    backward selection, both on the plain route on the CPU."""
    xs = [x.requires_grad_(True) for x in _t(*_case(1, 1, 8, 8, 4,
                                                    seed=7)[:3])]
    window = METRICS.snapshot()
    tfa.flash_attention(*xs).square().sum().backward()
    assert _selected(window) == {
        'ops_kernel_selected_total{kernel="flash_attention",'
        'path="reference"}': 1,
        'ops_kernel_selected_total{kernel="flash_attention_bwd",'
        'path="reference"}': 1}


# ---------------------------------------------------------------------------
# the slice: BERT tasks trained through fit


def _bert_pair(cls_name, cfg, L, seed=0, **kw):
    """A JAX and a port model of one task with the same seeded weights."""
    jax_reset_names()
    jnet = getattr(jtext, cls_name)(bert_config=cfg, **kw)
    jparams, _ = jnet.build(jax.random.PRNGKey(0), (2, L), (2, L))
    rs = np.random.RandomState(seed)

    def fill(path, x):
        shape = np.shape(x)
        if str(path[-1].key) == "gamma":
            return (1.0 + 0.1 * rs.randn(*shape)).astype(np.float32)
        return (0.02 * rs.randn(*shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, jparams)
    reset_name_scope()
    tnet = {"BERTClassifier": BERTClassifier, "BERTNER": BERTNER,
            "BERTSQuAD": BERTSQuAD}[cls_name](bert_config=cfg, **kw)
    load_jax_params(tnet, params)
    return jnet, tnet, params


def _fit_both(cls_name, cfg, xs, y, batch, epochs, loss, lr=5e-4, **kw):
    """Both models compiled with AdamWeightDecay (warmup 0.1 of the run,
    then linear decay, weight decay 0.01, eps 1e-6) and fit on the same
    batches; returns both histories' losses and both weight trees."""
    from analytics_zoo_tpu import init_zoo_context as jax_init_context

    jax_init_context()
    jnet, tnet, params = _bert_pair(cls_name, cfg, xs[0].shape[1], **kw)
    total = epochs * (len(y) // batch)
    jloss, tloss = loss if isinstance(loss, tuple) else (loss, loss)
    jnet.compile(optimizer=jopt.AdamWeightDecay(lr, warmup_portion=0.1,
                                                total=total), loss=jloss)
    jnet.estimator.set_initial_weights(params)
    jhist = jnet.fit(xs, y, batch_size=batch, nb_epoch=epochs, verbose=False)
    tnet.compile(optimizer=topt.AdamWeightDecay(lr, warmup_portion=0.1,
                                                total=total), loss=tloss,
                 device="cpu")
    thist = tnet.fit(xs, y, batch_size=batch, nb_epoch=epochs, verbose=False)
    want = jax.tree_util.tree_map(np.asarray, jnet.estimator.params)
    return ([h["loss"] for h in jhist], [h["loss"] for h in thist],
            want, export_params(tnet), params, jnet, tnet)


def _assert_trees_close(got, want, atol):
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def _ids(n, L, vocab, seed):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab, (n, L)).astype(np.int32)
    seg = np.zeros((n, L), np.int32)
    for r, cut in enumerate(rs.randint(1, L, n)):
        seg[r, cut:] = 1
    return ids, seg


def test_bert_classifier_trains_like_jax():
    """BERTClassifier (2 blocks, hidden 128, no dropout) trained for two
    epochs from the same weights and batches as the JAX ``fit``: losses
    rtol 1e-4, weights atol 1e-4; the loss falls and every leaf moves;
    evaluate and predict agree (rtol 1e-4, atol 1e-4)."""
    ids, seg = _ids(64, 16, 300, seed=1)
    y = (ids[:, 1] < 150).astype(np.int32)
    ce = "sparse_categorical_crossentropy_with_logits"
    jloss, tloss, want, got, init, jnet, tnet = _fit_both(
        "BERTClassifier", SMALL, [ids, seg], y, 16, 2, ce, num_classes=2)
    assert tnet.estimator.last_data_path == "host_prefetch"
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
    assert tloss[1] < tloss[0]
    _assert_trees_close(got, want, atol=1e-4)
    moved = jax.tree_util.tree_map(lambda a, b: bool(np.any(a != b)), got,
                                   init)
    assert all(jax.tree_util.tree_leaves(moved)), moved
    jev = jnet.evaluate([ids, seg], y, batch_size=32)
    tev = tnet.evaluate([ids, seg], y, batch_size=32)
    np.testing.assert_allclose(tev["loss"], jev["loss"], rtol=1e-4)
    np.testing.assert_allclose(tnet.predict([ids[:9], seg[:9]]),
                               np.asarray(jnet.predict([ids[:9], seg[:9]])),
                               rtol=0, atol=1e-4)


def test_bert_base_width_step_matches_jax():
    """BERT-Base widths (vocab 30522, hidden 768, 12 heads of D = 64,
    intermediate 3072) with 2 blocks, L = 128, one step of batch 8 (one
    row per device of the JAX CPU mesh): loss rtol 1e-4, weights atol
    1e-4."""
    ids, seg = _ids(8, 128, 30522, seed=2)
    y = (ids[:, 1] < 15261).astype(np.int32)
    jloss, tloss, want, got, *_ = _fit_both(
        "BERTClassifier", BASE_2, [ids, seg], y, 8, 1,
        "sparse_categorical_crossentropy_with_logits", lr=2e-5,
        num_classes=2)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
    _assert_trees_close(got, want, atol=1e-4)


def test_bert_ner_step_matches_jax():
    """BERTNER, per-token labels, one step of batch 8: loss rtol 1e-4,
    weights atol 1e-4."""
    ids, seg = _ids(8, 16, 300, seed=3)
    tags = (ids % 5).astype(np.int32)
    jloss, tloss, want, got, *_ = _fit_both(
        "BERTNER", SMALL, [ids, seg], tags, 8, 1,
        "sparse_categorical_crossentropy_with_logits", num_classes=5)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
    _assert_trees_close(got, want, atol=1e-4)


def test_bert_squad_step_matches_jax():
    """BERTSQuAD, (start, end) labels through a loss over the pair of
    logit heads, one step of batch 8: loss rtol 1e-4, weights atol
    1e-4."""
    ids, seg = _ids(8, 16, 300, seed=4)
    rs = np.random.RandomState(5)
    spans = np.sort(rs.randint(0, 16, (8, 2)), axis=1).astype(np.int32)

    def jloss(y, logits):
        ce = jobj.sparse_categorical_crossentropy_with_logits
        return 0.5 * (ce(y[:, 0], logits[0]) + ce(y[:, 1], logits[1]))

    def tloss(y, logits):
        ce = tobj.sparse_categorical_crossentropy_with_logits
        return 0.5 * (ce(y[:, 0], logits[0]) + ce(y[:, 1], logits[1]))

    jl, tl, want, got, *_ = _fit_both("BERTSQuAD", SMALL, [ids, seg], spans,
                                      8, 1, (jloss, tloss))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    _assert_trees_close(got, want, atol=1e-4)
