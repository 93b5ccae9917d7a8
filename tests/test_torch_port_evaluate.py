"""The port's graphed ``evaluate`` / ``predict`` and masked metrics against
the JAX package.

Inputs come from ``np.random.RandomState``; the port runs on the CPU,
where the eval and predict programs run eagerly over the same static,
padded buffers the card's graphs replay.  Batch sizes are multiples of 8,
so the JAX package on its 8-device CPU mesh pads each batch to the same
rows.  Tolerances, with their reasons:

- predictions: atol 1e-6 (the same f32 forward, summed in other orders);
- evaluate's loss and metrics: rtol 1e-5 (per-row sums under the mask,
  and the batches' statistics added in other orders);
- a metric's statistics on one batch: rtol 1e-6 (f32 sums of 0/1 and
  small values); AUC's histogram counts exactly;
- the 200-threshold AUC against the exact rank AUC: the bound a
  histogram AUC allows, half the share of (positive, negative) pairs
  whose scores share a bucket, derived from the scores;
- training with K-step host chunks: losses within rtol 1e-4 and weights
  within atol 1e-5 (the JAX step sums its gradients across the mesh).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.core.context import init_zoo_context as jax_init
from analytics_zoo_tpu.data.featureset import FeatureSet as JaxFS
from analytics_zoo_tpu.models import NeuralCF as JaxNCF
from analytics_zoo_tpu.models import KNRM as JaxKNRM
from analytics_zoo_tpu.nn import metrics as jmet
from analytics_zoo_tpu.nn import reset_name_scope as jax_reset_names
from analytics_zoo_tpu.nn.autograd import Input as JaxInput
from analytics_zoo_tpu.nn.layers.core import Dense as JaxDense
from analytics_zoo_tpu.nn.topology import Model as JaxModel
from analytics_zoo_tpu.nn.topology import Sequential as JaxSequential
from analytics_zoo_tpu.train import optimizers as jopt

from analytics_zoo_tpu_torch.convert import export_params, load_jax_params
from analytics_zoo_tpu_torch.core import context
from analytics_zoo_tpu_torch.core.triggers import SeveralIteration
from analytics_zoo_tpu_torch.data import FeatureSet
from analytics_zoo_tpu_torch.models import KNRM, NeuralCF
from analytics_zoo_tpu_torch.nn import (Dense, Input, Model, Sequential,
                                        reset_name_scope)
from analytics_zoo_tpu_torch.nn import metrics as tmet
from analytics_zoo_tpu_torch.observe import metrics as obs
from analytics_zoo_tpu_torch.train import optimizers as topt


@pytest.fixture(autouse=True)
def fresh_context():
    context.set_zoo_context(None)
    yield
    context.set_zoo_context(None)


def _numpy_params(jax_net, seed, scale=0.3):
    shapes = jax.eval_shape(lambda k: jax_net.build(k)[0],
                            jax.random.PRNGKey(0))
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda v: (rs.randn(*v.shape) * scale).astype(np.float32), shapes)


def _seed_jax(jm, xs, params):
    est = jm.estimator
    est._ensure_built(xs)
    est.set_initial_weights(params, est.state)


def _assert_eval_close(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# evaluate and predict on ragged last batches


def _ncf_pair(metrics):
    jax_init()
    jax_reset_names()
    reset_name_scope()
    kw = dict(user_embed=8, item_embed=8, hidden_layers=(16, 8), mf_embed=8,
              class_num=2)
    jm = JaxNCF(30, 20, table_placement="replicated", **kw)
    tm = NeuralCF(30, 20, device="cpu", **kw)
    params = _numpy_params(jm.model, seed=4)
    load_jax_params(tm.model, params)
    jm.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
               metrics=metrics)
    tm.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
               metrics=metrics)
    rs = np.random.RandomState(6)
    n = 45
    xs = [rs.randint(1, 31, (n, 1)).astype(np.int32),
          rs.randint(1, 21, (n, 1)).astype(np.int32)]
    _seed_jax(jm, xs, params)
    return jm, tm, xs, rs.randint(0, 2, n).astype(np.int32)


@pytest.mark.parametrize("batch", [16, 8, 64])
def test_ncf_evaluate_and_predict_ragged_match_jax(batch):
    """45 rows in batches of 16 (a last batch of 13), of 8 (5), and one
    batch of 64 holding them all: each batch padded and masked, as the
    JAX package's eval and predict steps do."""
    jm, tm, xs, y = _ncf_pair(["accuracy", "auc"])
    _assert_eval_close(tm.evaluate(xs, y, batch_size=batch),
                       jm.evaluate(xs, y, batch_size=batch))
    got = tm.predict(xs, batch_size=batch)
    np.testing.assert_allclose(got, np.asarray(jm.predict(
        xs, batch_size=batch)), rtol=0, atol=1e-6)
    est = tm.estimator
    # one eval and one predict program, reused on every batch
    assert sorted(k[0] for k in est._eval_programs) == ["eval", "predict"]
    again = tm.evaluate(xs, y, batch_size=batch)
    assert again == tm.evaluate(xs, y, batch_size=batch)


def test_evaluate_takes_device_tensors_and_counts_batches():
    jm, tm, xs, y = _ncf_pair(["accuracy"])
    mark = obs.METRICS.snapshot()
    want = tm.evaluate(xs, y, batch_size=16)
    got = tm.evaluate([torch.from_numpy(a) for a in xs],
                      torch.from_numpy(y), batch_size=16)
    assert got == want
    key = ("eval_batches_total", (("kind", "eval"),))
    assert obs.METRICS.snapshot().counters[key] == \
        mark.counters.get(key, 0) + 6


def test_knrm_rank_hinge_predict_and_evaluate_ragged_match_jax():
    """A loss that couples rows and takes a mask (``rank_hinge``) weighs
    by its own pairs; predictions of a ragged last batch come back
    unpadded."""
    kw = dict(text1_length=5, text2_length=9, max_words_num=59,
              embed_size=8, kernel_num=7)
    jax_reset_names()
    reset_name_scope()
    jm, tm = JaxKNRM(**kw), KNRM(device="cpu", **kw)
    params = _numpy_params(jm.model, seed=9)
    load_jax_params(tm.model, params)
    rs = np.random.RandomState(10)
    xs = [rs.randint(1, 60, (21, 5)).astype(np.int32),
          rs.randint(1, 60, (21, 9)).astype(np.int32)]
    y = np.zeros((21, 1), np.float32)
    jm.compile(optimizer="adam", loss="rank_hinge", metrics=["mae"])
    tm.compile(optimizer="adam", loss="rank_hinge", metrics=["mae"])
    _seed_jax(jm, xs, params)
    for batch in (8, 16):
        _assert_eval_close(tm.evaluate(xs, y, batch_size=batch),
                           jm.evaluate(xs, y, batch_size=batch))
        np.testing.assert_allclose(
            tm.predict(xs, batch_size=batch),
            np.asarray(jm.predict(xs, batch_size=batch)), rtol=0, atol=1e-6)


def _two_output_pair():
    jax_reset_names()
    a = JaxInput(shape=(6,))
    jm = JaxModel([a], [JaxDense(3, activation="relu")(a),
                        JaxDense(1, activation="sigmoid")(a)])
    reset_name_scope()
    b = Input(shape=(6,))
    tm = Model([b], [Dense(3, activation="relu")(b),
                     Dense(1, activation="sigmoid")(b)])
    params = _numpy_params(jm, seed=12)
    tm.build(torch.Generator().manual_seed(0))
    load_jax_params(tm, params)
    return jm, tm, params


def test_two_output_net_predict_raw_and_whole_batch_loss_match_jax():
    """A two-output net: ``predict_raw`` returns one array per output, its
    ragged rows cut off; a loss that couples rows without a mask runs on
    the whole padded batch, weighed by the real rows, as in JAX."""
    jm, tm, params = _two_output_pair()

    def jloss(y, p):
        return jnp.mean((p[0][:, 0] - y) ** 2) + jnp.mean(
            (p[1][:, 0] - y) ** 2)

    def tloss(y, p):
        return torch.mean((p[0][:, 0] - y) ** 2) + torch.mean(
            (p[1][:, 0] - y) ** 2)

    jloss.batch_structured = tloss.batch_structured = True
    rs = np.random.RandomState(13)
    x = rs.randn(27, 6).astype(np.float32)
    y = rs.rand(27).astype(np.float32)
    jm.compile(optimizer="adam", loss=jloss)
    tm.compile("adam", tloss, device="cpu")
    _seed_jax(jm, [x], params)
    got, want = tm.estimator.predict_raw(x, 8), jm.estimator.predict_raw(x, 8)
    assert [g.shape for g in got] == [(27, 3), (27, 1)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-6)
    _assert_eval_close(tm.evaluate(x, y, batch_size=8),
                       jm.evaluate(x, y, batch_size=8))


# ---------------------------------------------------------------------------
# masked metrics


def _metric_case(name, seed):
    """(metric name, y_true, y_pred) of a batch of 24 rows."""
    rs = np.random.RandomState(seed)
    n = 24
    if name in ("accuracy", "sparse_categorical_accuracy", "top5accuracy"):
        return rs.randint(0, 7, (n, 1)), rs.rand(n, 7).astype(np.float32)
    if name == "categorical_accuracy":
        return (np.eye(7, dtype=np.float32)[rs.randint(0, 7, n)],
                rs.rand(n, 7).astype(np.float32))
    if name in ("binary_accuracy", "auc"):
        return (rs.randint(0, 2, n).astype(np.float32),
                rs.rand(n, 1).astype(np.float32))
    return rs.randn(n, 3).astype(np.float32), rs.randn(n, 3).astype(
        np.float32)


@pytest.mark.parametrize("name", ["accuracy", "binary_accuracy",
                                  "categorical_accuracy",
                                  "sparse_categorical_accuracy",
                                  "top5accuracy", "mae", "auc"])
@pytest.mark.parametrize("with_mask", [False, True])
def test_metric_update_with_mask_matches_jax(name, with_mask):
    y, p = _metric_case(name, seed=len(name))
    mask = (np.arange(24) < 17).astype(np.float32) if with_mask else None
    tm, jm = tmet.get(name), jmet.get(name)
    got = tm.update(torch.from_numpy(y), torch.from_numpy(p),
                    None if mask is None else torch.from_numpy(mask))
    want = jm.update(jnp.asarray(y), jnp.asarray(p),
                     None if mask is None else jnp.asarray(mask))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(tm.finalize(got)),
                               float(jm.finalize(want)), rtol=1e-6)
    if with_mask:
        # the masked rows count for nothing: the same as the real rows alone
        alone = tm.update(torch.from_numpy(y[:17]), torch.from_numpy(p[:17]))
        np.testing.assert_allclose(float(tm.finalize(got)),
                                   float(tm.finalize(alone)), rtol=1e-6)


def _exact_auc(scores, labels):
    """The rank AUC: the share of (positive, negative) pairs ordered
    right, ties counting one half."""
    pos, neg = scores[labels == 1], scores[labels == 0]
    wins = (pos[:, None] > neg[None, :]).sum() + 0.5 * (
        pos[:, None] == neg[None, :]).sum()
    return wins / (len(pos) * len(neg))


def _auc_bound(scores, labels, num_thresholds=200):
    """How far a histogram AUC over ``num_thresholds`` points of
    linspace(0, 1) may lie from the rank AUC: pairs whose two scores share
    a bucket get half credit from the trapezoid, against 0, 1/2 or 1."""
    edges = np.linspace(0.0, 1.0, num_thresholds)
    bucket = np.searchsorted(edges, scores, side="right")
    pos = np.bincount(bucket[labels == 1], minlength=num_thresholds + 1)
    neg = np.bincount(bucket[labels == 0], minlength=num_thresholds + 1)
    return 0.5 * float((pos * neg).sum()) / (pos.sum() * neg.sum())


@pytest.mark.parametrize("seed", [0, 1])
def test_auc_against_the_exact_rank_auc(seed):
    rs = np.random.RandomState(seed)
    labels = rs.randint(0, 2, 5000)
    scores = np.clip(0.5 + 0.25 * (labels - 0.5) + 0.2 * rs.randn(5000),
                     0.0, 1.0).astype(np.float32)
    m = tmet.AUC()
    got = float(m.finalize(m.update(torch.from_numpy(labels),
                                    torch.from_numpy(scores[:, None]))))
    bound = _auc_bound(scores, labels)
    assert abs(got - _exact_auc(scores, labels)) <= bound + 1e-6
    assert bound < 0.01


def test_compile_with_auc_reports_it():
    jm, tm, xs, y = _ncf_pair(["auc"])
    out = tm.evaluate(xs, y, batch_size=16)
    assert set(out) == {"loss", "auc"} and 0.0 <= out["auc"] <= 1.0


# ---------------------------------------------------------------------------
# K-step chunks on the FeatureSet host path, graphed mid-fit validation


def _mlp_pair(k):
    jax_init(steps_per_execution=k)
    jax_reset_names()
    jm = JaxSequential([JaxDense(16, activation="relu", input_shape=(12,)),
                        JaxDense(2, activation="softmax")])
    params = _numpy_params(jm, seed=14)
    context.init_zoo_context(steps_per_execution=k)
    reset_name_scope()
    tm = Sequential([Dense(16, activation="relu", input_shape=(12,)),
                     Dense(2, activation="softmax")])
    tm.build(torch.Generator().manual_seed(0))
    load_jax_params(tm, params)
    jm.compile(optimizer=jopt.Adam(lr=1e-2),
               loss="sparse_categorical_crossentropy")
    tm.compile(topt.Adam(lr=1e-2), "sparse_categorical_crossentropy",
               device="cpu")
    return jm, tm, params


@pytest.mark.parametrize("k", [1, 4])
def test_featureset_k_step_chunks_match_jax(k):
    """K batches stacked into one copy and one K-step dispatch (an
    epoch's last steps % K one at a time), from the FeatureSet's own
    shuffle stream: the JAX package's losses and weights."""
    rs = np.random.RandomState(15)
    x = rs.randn(330, 12).astype(np.float32)
    y = (x @ rs.randn(12) > 0).astype(np.int32)
    jm, tm, params = _mlp_pair(k)
    _seed_jax(jm, [x], params)
    jhist = jm.fit(JaxFS.from_ndarrays([x], y, seed=2), batch_size=32,
                   nb_epoch=2, verbose=False)
    mark = obs.METRICS.snapshot()
    thist = tm.fit(FeatureSet.from_ndarrays([x], y, seed=2), batch_size=32,
                   nb_epoch=2, verbose=False)
    assert tm.estimator.last_data_path == "host_prefetch"
    np.testing.assert_allclose([h["loss"] for h in thist],
                               [h["loss"] for h in jhist], rtol=1e-4)
    got = export_params(tm)
    for layer, leaves in got.items():
        for leaf, v in leaves.items():
            np.testing.assert_allclose(
                v, np.asarray(jm.estimator.params[layer][leaf]), atol=1e-5)
    snap = obs.METRICS.snapshot()
    steps = {kind: snap.counters.get(("train_steps_total", (("kind", kind),)),
                                     0)
             - mark.counters.get(("train_steps_total", (("kind", kind),)), 0)
             for kind in ("1", "K")}
    # 10 steps an epoch: two chunks of 4 and two single steps at K = 4
    assert steps == ({"1": 20, "K": 0} if k == 1 else {"1": 4, "K": 16})


def test_midfit_validation_runs_through_the_eval_program():
    jm, tm, params = _mlp_pair(1)
    rs = np.random.RandomState(16)
    x = rs.randn(96, 12).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int32)
    hist = tm.fit(x, y, batch_size=32, nb_epoch=2, verbose=False,
                  validation_data=(x[:40], y[:40]),
                  validation_trigger=SeveralIteration(2))
    est = tm.estimator
    val = [h for h in hist if "val_loss" in h]
    assert len(val) >= 3
    assert list(est._eval_programs) == [("eval", 32, ((12,), torch.float32),
                                         ((), torch.int32),
                                         ((), torch.float32))]
    np.testing.assert_allclose(val[-1]["val_loss"],
                               tm.evaluate(x[:40], y[:40], 32)["loss"],
                               rtol=1e-6)
