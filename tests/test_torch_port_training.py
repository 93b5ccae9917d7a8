"""The PyTorch port's training slice against the JAX package.

Inputs come from ``np.random.RandomState``; the same arrays go through the
JAX function and its counterpart in the port, which runs on the CPU
(``device="cpu"``), where every kernel wrapper takes its plain version.
The JAX side runs its Pallas kernels in interpret mode, or its Estimator
on the CPU mesh.  Tolerances, with their reasons:

- gradients and losses: rtol 1e-5, atol 1e-6 (f32 sums in other orders);
- optimizers: parameters within atol 1e-6 after 20 steps (the schedules
  and bias corrections round differently in the last f32 digit);
- NCF trained for two epochs: per-epoch losses within rtol 1e-4, weights
  within atol 1e-4 (the JAX step sums its gradients across an 8-device
  CPU mesh, so the orders differ in every step).

The kernels themselves are held against these plain versions on the card
by ``tests/test_torch_port_cuda.py`` and ``chip_smoke.py``.
"""

import importlib
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from analytics_zoo_tpu.models import NeuralCF as JaxNCF
from analytics_zoo_tpu.nn import reset_name_scope as jax_reset_names

from analytics_zoo_tpu_torch.convert import export_params, load_jax_params
from analytics_zoo_tpu_torch.core import context
from analytics_zoo_tpu_torch.core.profiling import TIMERS
from analytics_zoo_tpu_torch.core.triggers import MaxEpoch
from analytics_zoo_tpu_torch.data import (CacheLevel, FeatureSet,
                                          generate_movielens_like,
                                          movielens_featureset,
                                          read_movielens_1m)
from analytics_zoo_tpu_torch.models import NeuralCF
from analytics_zoo_tpu_torch.models.recommendation import (
    negative_sample, presample_implicit_epochs)
from analytics_zoo_tpu_torch.nn import Dense, Sequential, reset_name_scope
from analytics_zoo_tpu_torch.nn import metrics as tmetrics
from analytics_zoo_tpu_torch.nn import objectives as tobj
from analytics_zoo_tpu_torch.nn import regularizers as treg
from analytics_zoo_tpu_torch.nn.layers.core import Dropout
from analytics_zoo_tpu_torch.observe.metrics import METRICS
from analytics_zoo_tpu_torch.ops import dequant_matmul as tdq
from analytics_zoo_tpu_torch.ops import dispatch
from analytics_zoo_tpu_torch.ops import embedding_bag as teb
from analytics_zoo_tpu_torch.train import optimizers as topt

# the JAX package's ops/__init__ re-exports functions under the module
# names, so the modules are fetched by path
jeb = importlib.import_module("analytics_zoo_tpu.ops.embedding_bag")
jdq = importlib.import_module("analytics_zoo_tpu.ops.dequant_matmul")
jobj = importlib.import_module("analytics_zoo_tpu.nn.objectives")
jmet = importlib.import_module("analytics_zoo_tpu.nn.metrics")
jreg = importlib.import_module("analytics_zoo_tpu.nn.regularizers")
jopt = importlib.import_module("analytics_zoo_tpu.train.optimizers")
jrec = importlib.import_module("analytics_zoo_tpu.models.recommendation")

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def fresh_context():
    context.set_zoo_context(None)
    yield
    context.set_zoo_context(None)


# ---------------------------------------------------------------------------
# embedding-bag gradient


def _bag_case(v, d, b, n, pad_id, seed):
    """Inputs with duplicate ids within and across bags, pad slots and an
    all-pad bag, and a random cotangent."""
    rs = np.random.RandomState(seed)
    table = rs.randn(v, d).astype(np.float32)
    ids = rs.randint(0, v, size=(b, n)).astype(np.int32)
    ids[1, :] = ids[1, 0]                        # one id over a whole bag
    ids[2, 0] = ids[3, -1] = ids[1, 0]           # and across bags
    if pad_id is not None:
        ids[rs.rand(b, n) < 0.3] = pad_id
        ids[0, :] = pad_id                        # one all-pad bag
    cot = rs.randn(b, d).astype(np.float32)
    return table, ids, cot


def _port_grad(fn, table, *args, cot):
    t = torch.from_numpy(table).requires_grad_(True)
    (fn(t, *args) * torch.from_numpy(cot)).sum().backward()
    return t.grad.numpy()


@pytest.mark.parametrize("combiner", teb.COMBINERS)
@pytest.mark.parametrize("pad_id", [0, None])
def test_bag_gradient_matches_jax_kernel(combiner, pad_id):
    """The JAX package's VJP rule for its bag (the Pallas backward kernel
    in interpret mode) against the port's autograd.  Six bags: one block
    of the TPU kernel, whose loops interpret mode unrolls."""
    table, ids, cot = _bag_case(23, 5, 6, 2, pad_id, seed=5)
    want, _ = jeb._bag_bwd_rule(combiner, pad_id, True,
                                (jnp.asarray(table), jnp.asarray(ids)),
                                jnp.asarray(cot))
    got = _port_grad(teb.embedding_bag, table, torch.from_numpy(ids),
                     combiner, pad_id, cot=cot)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_gather_gradient_matches_jax_kernel():
    """The NCF lookup: (B, 1) ids, duplicates across rows; ``jax.grad``
    through the JAX gather, both Pallas kernels in interpret mode."""
    rs = np.random.RandomState(2)
    table = rs.randn(31, 8).astype(np.float32)
    ids = rs.randint(0, 31, size=(8, 1)).astype(np.int32)
    ids[:3] = 7
    cot = rs.randn(8, 1, 8).astype(np.float32)
    want = jax.grad(lambda t: jnp.sum(jeb.embedding_gather(
        t, jnp.asarray(ids), interpret=True) * cot))(jnp.asarray(table))
    got = _port_grad(teb.embedding_gather, table, torch.from_numpy(ids),
                     cot=cot)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("combiner", teb.COMBINERS)
@pytest.mark.parametrize("pad_id", [0, None])
def test_plain_backward_is_autograd_of_plain_forward(combiner, pad_id):
    """The port's rule (ROADMAP C2): every live slot scatters to its
    clipped row, negative and past-the-end ids included."""
    table, ids, cot = _bag_case(17, 5, 8, 3, pad_id, seed=9)
    ids[4, 0], ids[5, 1], ids[6, 2] = -3, 17, 10 ** 6
    t = torch.from_numpy(table).requires_grad_(True)
    i = torch.from_numpy(ids)
    (teb.embedding_bag_reference(t, i, combiner, pad_id)
     * torch.from_numpy(cot)).sum().backward()
    plain = teb.embedding_bag_backward_reference(
        17, i, torch.from_numpy(cot), combiner, pad_id)
    torch.testing.assert_close(plain, t.grad, rtol=1e-6, atol=1e-7)
    assert float(plain[0].abs().sum()) > 0 and float(plain[16].abs().sum()) > 0
    routed = _port_grad(teb.embedding_bag, table, i, combiner, pad_id,
                        cot=cot)
    np.testing.assert_allclose(routed, t.grad.numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("combiner", teb.COMBINERS)
def test_bag_function_gradcheck(combiner):
    rs = np.random.RandomState(4)
    table = torch.from_numpy(rs.randn(7, 3)).requires_grad_(True)
    ids = torch.tensor([[1, 0, 6], [2, 2, 9], [0, 0, 0], [-1, 5, 3]],
                       dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda t: teb.embedding_bag(t, ids, combiner, 0), (table,))
    assert torch.autograd.gradcheck(
        lambda t: teb.embedding_gather(t, ids[:, :1]), (table,))


def test_bag_function_saves_nothing_without_grad():
    """Serving runs under inference_mode: no graph, nothing saved; a
    frozen table (trainable=False) gets no gradient."""
    table = torch.randn(10, 4, requires_grad=True)
    ids = torch.tensor([[1, 2], [3, 3]], dtype=torch.int32)
    with torch.inference_mode():
        out = teb.embedding_bag(table, ids, "mean", None)
    assert out.grad_fn is None and not out.requires_grad
    out = teb.embedding_bag(table, ids, "sum", None)
    assert out.grad_fn is not None
    assert len(out.grad_fn.saved_tensors) == 1          # the ids only
    assert torch.equal(out.grad_fn.saved_tensors[0], ids)
    frozen = teb.embedding_bag(table.detach(), ids, "sum", None)
    assert frozen.grad_fn is None


def test_backward_routing_is_counted():
    table = torch.randn(10, 4, requires_grad=True)
    ids = torch.tensor([[1], [3]], dtype=torch.int32)
    window = METRICS.snapshot()
    teb.embedding_gather(table, ids).sum().backward()
    counters = METRICS.delta(window)["counters"]
    assert counters['ops_kernel_selected_total{kernel="embedding_bag_bwd",'
                    'path="reference"}'] == 1
    assert teb.BWD_LAUNCHES.value == 0               # no card here


# ---------------------------------------------------------------------------
# dequantize-matmul dx


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("k", [12, 13])
def test_dequant_matmul_dx_matches_jax(bits, k, monkeypatch):
    rs = np.random.RandomState(bits + k)
    w = rs.randn(k, 6).astype(np.float32)
    x = rs.randn(5, k).astype(np.float32)
    cot = rs.randn(5, 6).astype(np.float32)
    jq, jscale = jdq.quantize_weights(jnp.asarray(w), bits=bits)
    want = jax.grad(lambda xx: jnp.sum(jdq.dequant_matmul(
        xx, jq, jscale, bits=bits, rows=k, interpret=True) * cot))(
        jnp.asarray(x))
    q, scale = tdq.quantize_weights(torch.from_numpy(w), bits=bits)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))

    def dx():
        t = torch.from_numpy(x).requires_grad_(True)
        (tdq.dequant_matmul(t, q, scale, bits=bits, rows=k)
         * torch.from_numpy(cot)).sum().backward()
        return t.grad.numpy()

    np.testing.assert_allclose(dx(), np.asarray(want), rtol=RTOL, atol=ATOL)
    # the kernel path's autograd Function, with its launch swapped for the
    # plain forward so its backward rule runs here
    monkeypatch.setattr(tdq, "_launch", lambda xx, qq, ss, b: (
        tdq.dequant_matmul_reference(xx, qq, ss, b, k)))
    with dispatch.forced(dispatch.PATH_CUDA):
        np.testing.assert_allclose(dx(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


# ---------------------------------------------------------------------------
# objectives, metrics, regularizers, dropout


def _probs(rs, b, c):
    z = rs.randn(b, c).astype(np.float32)
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("name", [
    "sparse_categorical_crossentropy", "categorical_crossentropy",
    "sparse_categorical_crossentropy_with_logits", "class_nll", "mse",
    "mae", "mape", "msle", "binary_crossentropy",
    "binary_crossentropy_with_logits", "kld", "poisson",
    "cosine_proximity", "hinge", "squared_hinge", "rank_hinge"])
def test_objectives_match_jax(name):
    rs = np.random.RandomState(len(name))
    p = _probs(rs, 16, 5)
    p[0, 2] = 0.0                                    # the 1e-7 clip
    labels = rs.randint(0, 5, 16).astype(np.int32)
    onehot = np.eye(5, dtype=np.float32)[labels]
    if name in ("sparse_categorical_crossentropy", "class_nll",
                "sparse_categorical_crossentropy_with_logits"):
        yt, yp = labels[:, None], (np.log(p + 1e-7) if name == "class_nll"
                                   else p)
    elif name in ("categorical_crossentropy", "kld", "cosine_proximity"):
        yt, yp = onehot, p
    else:
        yt = rs.rand(16, 1).astype(np.float32)
        yp = (rs.rand(16).astype(np.float32) if name != "binary_crossentropy"
              else p[:, 0])
    want = float(jobj.get(name)(jnp.asarray(yt), jnp.asarray(yp)))
    got = float(tobj.get(name)(torch.from_numpy(yt), torch.from_numpy(yp)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="unknown loss"):
        tobj.get("no_such_loss")


@pytest.mark.parametrize("name", ["accuracy", "binary_accuracy",
                                  "categorical_accuracy",
                                  "sparse_categorical_accuracy", "mae"])
def test_metrics_match_jax(name):
    rs = np.random.RandomState(3)
    if name == "binary_accuracy":
        yt, yp = rs.randint(0, 2, (20, 1)), rs.rand(20, 1)
    elif name == "categorical_accuracy":
        yt, yp = np.eye(4)[rs.randint(0, 4, 20)], _probs(rs, 20, 4)
    elif name == "mae":
        yt, yp = rs.rand(20, 3), rs.rand(20, 3)
    else:
        yt, yp = rs.randint(0, 4, (20, 1)), _probs(rs, 20, 4)
    yt, yp = yt.astype(np.float32), yp.astype(np.float32)
    jm, tm = jmet.get(name), tmetrics.get(name)
    jstats = [jm.update(jnp.asarray(yt[s]), jnp.asarray(yp[s]))
              for s in (slice(0, 12), slice(12, 20))]
    tstats = [tm.update(torch.from_numpy(yt[s]), torch.from_numpy(yp[s]))
              for s in (slice(0, 12), slice(12, 20))]
    want = float(jm.finalize(jax.tree_util.tree_map(jnp.add, *jstats)))
    got = float(tm.finalize({k: tstats[0][k] + tstats[1][k]
                             for k in tstats[0]}))
    assert tm.name == jm.name
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    loss = tmetrics.Loss("mse")
    st = loss.update(torch.from_numpy(yt), torch.from_numpy(yt) + 0.5)
    np.testing.assert_allclose(float(loss.finalize(st)), 0.25, rtol=RTOL)


@pytest.mark.parametrize("spec", ["l1", "l2", "l1l2"])
def test_regularization_loss_matches_jax(spec):
    from analytics_zoo_tpu.nn import Dense as JaxDense
    from analytics_zoo_tpu.nn import Sequential as JaxSequential

    jax_reset_names()
    jnet = JaxSequential([JaxDense(4, input_shape=(3,), w_regularizer=spec,
                                   b_regularizer=spec), JaxDense(2)])
    params, _ = jnet.build(jax.random.PRNGKey(0), (2, 3))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.3, params)
    reset_name_scope()
    net = Sequential([Dense(4, input_shape=(3,), w_regularizer=spec,
                            b_regularizer=spec), Dense(2)])
    net.build(torch.Generator().manual_seed(0), (2, 3))
    load_jax_params(net, params)
    want = float(jnet.regularization_loss(params))
    np.testing.assert_allclose(float(net.regularization_loss()), want,
                               rtol=RTOL)
    assert repr(treg.get(spec)) == repr(jreg.get(spec))


def test_dropout_uses_an_explicit_generator():
    drop = Dropout(0.4)
    x = torch.ones(200, 50)
    with pytest.raises(ValueError, match="needs a generator"):
        drop(x)
    drop.generator = torch.Generator().manual_seed(7)
    a = drop(x)
    drop.generator = torch.Generator().manual_seed(7)
    assert torch.equal(a, drop(x))
    kept = a != 0
    assert abs(float(kept.float().mean()) - 0.6) < 0.02
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / 0.6))
    assert torch.equal(drop.eval()(x), x)


# ---------------------------------------------------------------------------
# optimizers against optax


OPTIMIZERS = {
    "adam": lambda m: m.Adam(lr=1e-2),
    "adam_decay": lambda m: m.Adam(lr=1e-2, decay=0.05),
    "adam_poly_warmup": lambda m: m.Adam(lr=1e-2, schedule="poly",
                                         warmup_steps=5, total_steps=15),
    "adam_cosine": lambda m: m.Adam(lr=1e-2, schedule="cosine",
                                    total_steps=12),
    "adam_exponential": lambda m: m.Adam(lr=1e-2, schedule="exponential"),
    "adamw_warmup": lambda m: m.AdamWeightDecay(lr=1e-2, warmup_portion=0.2,
                                                total=18),
    "adamw_no_warmup": lambda m: m.AdamWeightDecay(lr=1e-2, total=18),
    "adamw_constant": lambda m: m.AdamWeightDecay(lr=1e-2),
    "sgd": lambda m: m.SGD(lr=0.05),
    "sgd_momentum": lambda m: m.SGD(lr=0.05, momentum=0.9),
    "sgd_nesterov": lambda m: m.SGD(lr=0.05, momentum=0.9, nesterov=True),
    "rmsprop": lambda m: m.RMSprop(lr=1e-2, decay=0.01),
    "adagrad": lambda m: m.Adagrad(lr=0.05),
    "adadelta": lambda m: m.Adadelta(lr=1.0),
    "adamax": lambda m: m.Adamax(),
    "adam_by_name": lambda m: m.get("adam"),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_optax(name):
    rs = np.random.RandomState(len(name))
    p0 = rs.randn(40).astype(np.float32)
    grads = (rs.randn(20, 40) * 0.5).astype(np.float32)
    grads[3, :5] = 0.0                                # zero gradients too
    jtx = OPTIMIZERS[name](jopt)
    jp = jnp.asarray(p0)
    jstate = jtx.init(jp)
    ttx = OPTIMIZERS[name](topt)
    tp = torch.from_numpy(p0)
    tstate = ttx.init(tp)
    for g in grads:
        upd, jstate = jtx.update(jnp.asarray(g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tupd, tstate = ttx.update(torch.from_numpy(g), tstate, tp)
        tp = tp + tupd
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("clip", ["norm", "value"])
def test_gradient_clipping_matches_optax(clip):
    rs = np.random.RandomState(1)
    p0 = rs.randn(30).astype(np.float32)
    grads = (rs.randn(10, 30) * 3).astype(np.float32)
    if clip == "norm":
        jtx = optax.chain(optax.clip_by_global_norm(2.0), jopt.Adam(1e-2))
        ttx = topt.chain(topt.clip_by_global_norm(2.0), topt.Adam(1e-2))
    else:
        jtx = optax.chain(optax.clip(0.5), jopt.SGD(0.1))
        ttx = topt.chain(topt.clip(0.5), topt.SGD(0.1))
    jp, tp = jnp.asarray(p0), torch.from_numpy(p0)
    js, ts = jtx.init(jp), ttx.init(tp)
    for g in grads:
        u, js = jtx.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, u)
        v, ts = ttx.update(torch.from_numpy(g), ts, tp)
        tp = tp + v
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)


# ---------------------------------------------------------------------------
# the whole slice: NeuralCF trains like the JAX NeuralCF


NCF_WIDTHS = {
    "small": (50, 40, dict(user_embed=8, item_embed=8, hidden_layers=(16, 8),
                           mf_embed=8)),
    "ml1m": (6040, 3706, {}),
}


def _ncf_data(users, items, n, seed=0):
    rs = np.random.RandomState(seed)
    u = rs.randint(1, users + 1, (n, 1)).astype(np.int32)
    i = rs.randint(1, items + 1, (n, 1)).astype(np.int32)
    y = rs.randint(0, 5, n).astype(np.int32)
    return u, i, y


def _train_both(width, n, batch, epochs):
    from analytics_zoo_tpu import init_zoo_context as jax_init_context

    users, items, kw = NCF_WIDTHS[width]
    u, i, y = _ncf_data(users, items, n)
    jax_init_context()
    jax_reset_names()
    jncf = JaxNCF(users, items, table_placement="replicated", **kw)
    reset_name_scope()
    tncf = NeuralCF(users, items, device="cpu", **kw)
    rs = np.random.RandomState(3)
    params = {layer: {leaf: (rs.randn(*v.shape) * 0.1).astype(np.float32)
                      for leaf, v in sub.items()}
              for layer, sub in tncf.model.params().items()}
    jncf.compile(optimizer=jopt.Adam(lr=1e-3),
                 loss="sparse_categorical_crossentropy", metrics=["accuracy"])
    jncf.estimator.set_initial_weights(params)
    jhist = jncf.fit([u, i], y, batch_size=batch, nb_epoch=epochs,
                     verbose=False)
    load_jax_params(tncf.model, params)
    tncf.compile(optimizer=topt.Adam(lr=1e-3),
                 loss="sparse_categorical_crossentropy", metrics=["accuracy"])
    thist = tncf.fit([u, i], y, batch_size=batch, nb_epoch=epochs,
                     verbose=False)
    return (jncf, tncf, (u, i, y), [r["loss"] for r in jhist],
            [r["loss"] for r in thist])


def _assert_weights_close(tncf, jncf, atol):
    got = export_params(tncf.model)
    want = jax.tree_util.tree_map(np.asarray, jncf.estimator.params)
    assert set(got) == set(want)
    for layer, leaves in want.items():
        assert set(got[layer]) == set(leaves), layer
        for leaf, w in leaves.items():
            np.testing.assert_allclose(got[layer][leaf], w, rtol=0,
                                       atol=atol, err_msg=f"{layer}.{leaf}")


def test_ncf_trains_like_jax():
    jncf, tncf, (u, i, y), jloss, tloss = _train_both("small", 1000, 32, 2)
    assert tncf.estimator.last_data_path == "host_prefetch"
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
    assert tloss[1] < tloss[0]
    _assert_weights_close(tncf, jncf, atol=1e-4)
    # every table moved: the embedding gradients reached the optimizer
    before = tncf.model.params()
    assert all(float(v.abs().sum()) > 0 for v in before.values()
               for v in v.values())
    jev = jncf.evaluate([u, i], y, batch_size=64)
    tev = tncf.evaluate([u, i], y, batch_size=64)
    assert set(tev) == {"loss", "accuracy"}
    np.testing.assert_allclose(tev["loss"], jev["loss"], rtol=1e-4)
    np.testing.assert_allclose(tev["accuracy"], jev["accuracy"], atol=1e-3)
    want = np.asarray(jncf.predict([u[:77], i[:77]], batch_size=32))
    got = tncf.predict([u[:77], i[:77]], batch_size=32)
    assert got.shape == (77, 5)
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_array_equal(
        tncf.model.predict_classes([u[:77], i[:77]]),
        np.argmax(got, -1))


def test_ncf_ml1m_width_epoch_matches_jax():
    jncf, tncf, _, jloss, tloss = _train_both("ml1m", 1536, 256, 1)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
    _assert_weights_close(tncf, jncf, atol=1e-4)


def test_fit_changes_every_table_and_recompile_keeps_weights():
    reset_name_scope()
    ncf = NeuralCF(30, 20, user_embed=4, item_embed=4, hidden_layers=(8,),
                   mf_embed=4, device="cpu")
    u, i, y = _ncf_data(30, 20, 256, seed=1)
    start = {k: {j: v.clone() for j, v in sub.items()}
             for k, sub in ncf.model.params().items()}
    ncf.compile("adam", "sparse_categorical_crossentropy")
    ncf.fit([u, i], y, batch_size=64, epochs=1, verbose=False)
    trained = ncf.model.params()
    for name in ("mlp_user_embed", "mlp_item_embed", "mf_user_embed",
                 "mf_item_embed"):
        assert not torch.equal(trained[name]["table"], start[name]["table"])
    snapshot = export_params(ncf.model)
    ncf.compile("sgd", "sparse_categorical_crossentropy")
    np.testing.assert_array_equal(export_params(ncf.model)["ncf_head"][
        "kernel"], snapshot["ncf_head"]["kernel"])
    with pytest.raises(ValueError, match="aliases"):
        ncf.fit([u, i], y, nb_epoch=1, epochs=1)


def test_trained_model_serves_its_weights():
    """A net that trained copies for serving without its estimator, and
    the serving model answers as ``predict`` does."""
    from analytics_zoo_tpu_torch.deploy import InferenceModel

    reset_name_scope()
    ncf = NeuralCF(30, 20, user_embed=4, item_embed=4, hidden_layers=(8,),
                   mf_embed=4, device="cpu")
    u, i, y = _ncf_data(30, 20, 128, seed=3)
    ncf.compile("adam", "sparse_categorical_crossentropy")
    ncf.fit([u, i], y, batch_size=32, epochs=1, verbose=False)
    im = InferenceModel.from_keras_net(ncf.model, device="cpu")
    assert im._net._estimator is None
    np.testing.assert_allclose(im.predict([u, i]), ncf.predict([u, i]),
                               rtol=0, atol=1e-6)


def test_pair_structured_loss_keeps_pairs_together():
    from analytics_zoo_tpu_torch.train.estimator import _pair_perm

    for n in (10, 11):
        pairs = np.random.RandomState(n).permutation(n // 2)
        for order in (_pair_perm(pairs, n),
                      _pair_perm(torch.from_numpy(pairs), n).numpy()):
            assert sorted(order) == list(range(n))
            assert all(order[k] % 2 == 0 and order[k + 1] == order[k] + 1
                       for k in range(0, n - 1, 2))
    net = _dense_net()
    net.compile("adam", "rank_hinge", device="cpu")
    x, y = _regression(n=64)
    hist = net.fit(x, y, batch_size=16, epochs=2, verbose=False)
    assert all(np.isfinite(h["loss"]) for h in hist)


def test_initial_weights_merge_by_layer_name(caplog):
    reset_name_scope()
    ncf = NeuralCF(30, 20, user_embed=4, item_embed=4, hidden_layers=(8,),
                   mf_embed=4, device="cpu")
    head = {"ncf_head": {k: np.full(v.shape, 0.25, np.float32)
                         for k, v in ncf.model.params()["ncf_head"].items()}}
    ncf.model.set_initial_weights(head)
    ncf.compile("adam", "sparse_categorical_crossentropy")
    u, i, _ = _ncf_data(30, 20, 8)
    with caplog.at_level(logging.WARNING, "analytics_zoo_tpu_torch.train"):
        ncf.predict([u, i])
    assert "RANDOM init" in caplog.text and "mf_user_embed" in caplog.text
    np.testing.assert_array_equal(
        export_params(ncf.model)["ncf_head"]["kernel"],
        head["ncf_head"]["kernel"])


def test_dropout_run_replays_from_the_seed():
    def run():
        reset_name_scope()
        ncf = NeuralCF(30, 20, user_embed=4, item_embed=4,
                       hidden_layers=(8, 4), mf_embed=4, dropout=0.3,
                       device="cpu", generator=torch.Generator().manual_seed(1))
        u, i, y = _ncf_data(30, 20, 128, seed=2)
        ncf.compile("adam", "sparse_categorical_crossentropy")
        hist = ncf.fit([u, i], y, batch_size=32, epochs=2, verbose=False)
        drops = [m for m in ncf.model.modules() if isinstance(m, Dropout)]
        assert drops and all(m.generator is None for m in drops)
        assert not ncf.model.training
        return [r["loss"] for r in hist], export_params(ncf.model)

    (l1, w1), (l2, w2) = run(), run()
    assert l1 == l2
    np.testing.assert_array_equal(w1["mlp_dense_0"]["kernel"],
                                  w2["mlp_dense_0"]["kernel"])


# ---------------------------------------------------------------------------
# the NaN/Inf guard


def _regression(seed=0, n=32):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 3).astype(np.float32)
    return x, (x @ rs.randn(3, 1)).astype(np.float32)


def _dense_net():
    reset_name_scope()
    net = Sequential([Dense(4, input_shape=(3,), activation="relu"),
                      Dense(1)])
    net.compile("adam", "mse", device="cpu")
    return net


def test_nan_batch_leaves_weights_and_optimizer_state_unchanged():
    net = _dense_net()
    x, y = _regression()
    net.fit(x, y, batch_size=16, epochs=1, verbose=False)
    est = net.estimator
    before = export_params(net)
    state = [t.clone() for t in est.opt_state]
    bad = x.copy()
    bad[3, 1] = np.nan                       # the only step of this epoch
    steps = TIMERS.count("robust/nan_steps")
    hist = net.fit(bad[:16], y[:16], batch_size=16, epochs=2, verbose=False)
    assert TIMERS.count("robust/nan_steps") == steps + 1
    assert np.isnan(hist[-1]["loss"])
    after = export_params(net)
    for layer in before:
        for leaf in before[layer]:
            np.testing.assert_array_equal(after[layer][leaf],
                                          before[layer][leaf])
    for a, b in zip(est.opt_state, state):
        assert torch.equal(a, b)
    net.fit(x, y, batch_size=16, epochs=3, verbose=False)   # and trains on
    assert int(est.opt_state[0]) == int(state[0]) + 2


def test_nan_policy_raise_and_rollback_without_checkpoint():
    x, y = _regression()
    x[0, 0] = np.inf
    for policy in ("raise", "rollback"):
        context.init_zoo_context(nan_policy=policy, max_bad_steps=1)
        net = _dense_net()
        with pytest.raises(FloatingPointError):
            net.fit(x, y, batch_size=16, epochs=1, verbose=False)
    context.init_zoo_context(nan_policy="skip", max_bad_steps=1)
    net = _dense_net()
    with pytest.raises(FloatingPointError, match="no progress"):
        net.fit(x, y, batch_size=16, epochs=1, verbose=False)
    context.init_zoo_context(nan_policy="bogus")
    with pytest.raises(ValueError, match="nan_policy"):
        _dense_net().fit(x, y, batch_size=16, epochs=1, verbose=False)


# ---------------------------------------------------------------------------
# data paths


def test_featureset_routes_reach_the_path_they_name(caplog):
    u, i, r = generate_movielens_like(n_users=40, n_items=30,
                                      ratings_per_user=8, seed=1)
    jds = importlib.import_module("analytics_zoo_tpu.data.datasets")
    want = jds.generate_movielens_like(n_users=40, n_items=30,
                                       ratings_per_user=8, seed=1)
    for a, b in zip((u, i, r), want):
        np.testing.assert_array_equal(a, b)

    def fit(fs, **cfg):
        context.init_zoo_context(**cfg)
        reset_name_scope()
        ncf = NeuralCF(40, 30, user_embed=4, item_embed=4,
                       hidden_layers=(8,), mf_embed=4, device="cpu")
        ncf.compile("adam", "sparse_categorical_crossentropy")
        ncf.fit(fs, batch_size=32, epochs=1, verbose=False)
        est = ncf.estimator
        return est.last_data_path, est.last_data_path_reason

    ml = movielens_featureset(n_users=40, n_items=30, ratings_per_user=8,
                              seed=1)
    assert ml.nbytes == 320 * (4 + 4 + 4) and len(ml) == 320
    np.testing.assert_array_equal(ml.arrays[2], r)
    fs = FeatureSet.from_ndarrays([u[:, None].astype(np.int32),
                                   i[:, None].astype(np.int32)],
                                  (r - 1).astype(np.int32))
    assert fit(fs.cache(CacheLevel.DEVICE)) == ("device_resident",
                                                "fits device budget")
    assert fit(fs) == ("host_prefetch", "cache level HOST")
    assert fit(fs, data_cache_level="DEVICE")[0] == "device_resident"
    with caplog.at_level(logging.WARNING, "analytics_zoo_tpu_torch.train"):
        path, why = fit(fs.cache("device"), data_device_budget_bytes=100)
    assert path == "host_prefetch" and "over device budget" in why
    with pytest.raises(ValueError, match="cache level"):
        fs.cache("pmem")


def test_read_movielens_1m_matches_jax(tmp_path):
    jds = importlib.import_module("analytics_zoo_tpu.data.datasets")
    (tmp_path / "ratings.dat").write_text(
        "1::1193::5::978300760\n1::661::3::978302109\nbad line\n"
        "6040::3706::1::956704887\n")
    got = read_movielens_1m(str(tmp_path))
    want = jds.read_movielens_1m(str(tmp_path))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[0].tolist() == [1, 1, 6040]


def test_host_featureset_batches_match_jax():
    jfs_mod = importlib.import_module("analytics_zoo_tpu.data.featureset")
    rs = np.random.RandomState(0)
    x, y = rs.randn(50, 2), rs.randint(0, 3, 50)
    jfs = jfs_mod.FeatureSet.from_ndarrays(x, y, seed=4)
    tfs = FeatureSet.from_ndarrays(x, y, seed=4)
    for epoch in range(2):
        for a, b in zip(jfs.batches(16, shuffle=True, drop_remainder=True),
                        tfs.batches(16, shuffle=True, drop_remainder=True)):
            for p, q in zip(a, b):
                np.testing.assert_array_equal(p, q)


def test_steps_per_execution_keeps_the_step_sequence():
    x, y = _regression(n=96)

    def run(k):
        context.init_zoo_context(steps_per_execution=k)
        net = _dense_net()
        hist = net.fit(x, y, batch_size=16, epochs=2, verbose=False)
        return [h["loss"] for h in hist], export_params(net)

    (l1, w1), (l4, w4) = run(1), run(4)
    assert l1 == l4
    np.testing.assert_array_equal(w1["dense_1"]["kernel"],
                                  w4["dense_1"]["kernel"])


def test_device_resident_fit_and_end_trigger():
    x, y = _regression(n=64)
    net = _dense_net()
    hist = net.fit(torch.from_numpy(x), torch.from_numpy(y), batch_size=16,
                   epochs=5, end_trigger=MaxEpoch(2),
                   validation_data=(x, y), verbose=False)
    assert net.estimator.last_data_path == "device_resident"
    assert [h["epoch"] for h in hist] == [1, 2]
    assert "val_loss" in hist[-1] and np.isfinite(hist[-1]["val_loss"])


def test_validation_trigger_fires_between_epochs():
    from analytics_zoo_tpu_torch.core.triggers import SeveralIteration

    x, y = _regression(n=64)
    net = _dense_net()
    hist = net.fit(x, y, batch_size=16, epochs=1, validation_data=(x, y),
                   validation_trigger=SeveralIteration(2),
                   validation_batch_size=64, verbose=False)
    assert [h.get("iteration") for h in hist] == [2, 4, None]
    assert hist[-1]["val_loss"] == hist[1]["val_loss"]   # reused at step 4
    assert net.estimator.evaluate(x, y, batch_size=64)["loss"] == \
        pytest.approx(hist[-1]["val_loss"], rel=1e-6)


def test_negative_sample_matches_jax():
    rs = np.random.RandomState(0)
    u = rs.randint(1, 20, 60)
    i = rs.randint(1, 30, 60)
    got = negative_sample(u, i, 30, neg_per_pos=2, seed=3)
    want = jrec.negative_sample(u, i, 30, neg_per_pos=2, seed=3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_presample_implicit_epochs():
    rs = np.random.RandomState(0)
    users, items = 40, 200
    u = np.repeat(np.arange(1, users + 1), 10)
    i = rs.randint(1, items + 1, u.size)
    kw = dict(epochs=3, neg_per_pos=2, seed=5, trim_multiple=64,
              device="cpu")
    pu, pi, pl = presample_implicit_epochs(u, i, items, **kw)
    s = (u.size * 3 // 64) * 64
    assert pu.shape == pi.shape == pl.shape == (3, s)
    assert pu.dtype == pi.dtype == pl.dtype == torch.int32
    assert int(pi.min()) >= 1 and int(pi.max()) <= items     # no pad item
    ratio = float(pl.float().mean())
    assert abs(ratio - 1 / 3) < 0.02                          # 1 : 2
    seen = np.zeros((users + 1, items + 1), bool)
    seen[u, i] = True
    neg = pl.numpy() == 0
    hits = seen[pu.numpy()[neg], pi.numpy()[neg]].mean()
    assert hits < 1e-3          # residual odds: (10 / 200) ** 4 per draw
    assert not torch.equal(pi[0], pi[1])
    again = presample_implicit_epochs(u, i, items, **kw)
    for a, b in zip((pu, pi, pl), again):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="trim_multiple"):
        presample_implicit_epochs(u, i, items, epochs=1, trim_multiple=10 ** 6,
                                  device="cpu")
