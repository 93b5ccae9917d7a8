"""The port's Seq2seq and AnomalyDetector against the JAX package.

Both are built in both packages at small widths (vocabulary 13, embed 8,
hidden 16, sequences of 7 or less; the detector's window 8 over hidden
4, 8, 6), given the same weights drawn by ``np.random.RandomState`` in
the JAX package's tree layout (``load_jax_params``: the seq2seq tree's
``embed`` / ``enc`` / ``dec`` / ``bridge`` / ``gen``, with the dense
bridge's ``w{i}`` in the JAX ``tree_leaves`` order of the encoder's
states) and fed the same inputs: the teacher-forced forward with both
bridges and both cells, greedy ``infer`` with and without ``stop_sign``
(tokens equal), ``infer_beam`` (tokens equal where the decode meets no
near-tie, scores within 1e-5), one Adam step through ``fit`` on the copy
task, the detector's forward and its helpers ``unroll`` and
``detect_anomalies``, and ``save_model`` / ``load_model`` by name.
Everything runs on the CPU.

Tolerances, with their reasons: forwards and beam scores atol 1e-5 (f32
sums in other orders through a few recurrent steps, logits of magnitude
up to about 10 from weights of scale 0.4); one Adam step (lr 1e-3) within
atol 1e-5, as in the text tests.
"""

import json

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.deploy.inference import InferenceModel as JaxIM
from analytics_zoo_tpu.models import anomalydetection as jad
from analytics_zoo_tpu.models import seq2seq as js2s
from analytics_zoo_tpu.nn import objectives as jobj
from analytics_zoo_tpu.nn import reset_name_scope as jax_reset_names
from analytics_zoo_tpu.train import optimizers as jopt

from analytics_zoo_tpu_torch.convert import export_params, load_jax_params
from analytics_zoo_tpu_torch.core import context
from analytics_zoo_tpu_torch.models import AnomalyDetector, Seq2seq
from analytics_zoo_tpu_torch.models import anomalydetection as tad
from analytics_zoo_tpu_torch.models.common import ZooModel
from analytics_zoo_tpu_torch.models.seq2seq import Bridge
from analytics_zoo_tpu_torch.nn import reset_name_scope
from analytics_zoo_tpu_torch.train import optimizers as topt

ATOL = 1e-5
VOCAB, T = 13, 5
S2S = dict(vocab_size=VOCAB, embed_dim=8, hidden_size=16)
LOSS = "sparse_categorical_crossentropy_with_logits"
AD = dict(feature_shape=(8, 2), hidden_layers=(4, 8, 6),
          dropouts=(0.2, 0.2, 0.2))


@pytest.fixture(autouse=True)
def fresh_context():
    context.set_zoo_context(None)
    yield
    context.set_zoo_context(None)


def _draw(shapes, seed, scale):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda v: (rs.randn(*v.shape) * scale).astype(np.float32), shapes)


def _s2s_pair(seed=0, scale=0.4, **kw):
    """(JAX model, port model, numpy params, encoder ids)."""
    jax_reset_names()
    reset_name_scope()
    kw = dict(S2S, **kw)
    jm, tm = js2s.Seq2seq(**kw), Seq2seq(device="cpu", **kw)
    enc = np.random.RandomState(seed + 1).randint(
        2, VOCAB, (6, T)).astype(np.int32)
    shapes = jax.eval_shape(
        lambda k: jm.model.build(k, enc.shape, enc.shape)[0],
        jax.random.PRNGKey(0))
    params = _draw(shapes, seed, scale)
    load_jax_params(tm.model, params)
    jm.compile(optimizer="adam", loss=LOSS)
    jm.estimator._ensure_built([enc, enc])
    jm.estimator.set_initial_weights(params)
    return jm, tm, params, enc


def _copy_task(n, t, seed):
    rs = np.random.RandomState(seed)
    src = rs.randint(2, VOCAB, (n, t)).astype(np.int32)
    dec = np.concatenate([np.ones((n, 1), np.int32), src[:, :-1]], axis=1)
    return src, dec, src


@pytest.mark.parametrize("rnn_type,bridge,layers", [
    ("lstm", "pass", 1), ("gru", "dense", 2), ("lstm", "dense", 2)])
def test_teacher_forced_forward_matches_jax(rnn_type, bridge, layers):
    jm, tm, params, enc = _s2s_pair(rnn_type=rnn_type, bridge_type=bridge,
                                    num_layers=layers)
    assert set(tm.model.params()) == set(params)
    if bridge == "dense":
        n = layers * (2 if rnn_type == "lstm" else 1)
        assert sorted(params["bridge"]) == sorted(
            [f"w{i}" for i in range(n)] + [f"b{i}" for i in range(n)])
    _, dec, _ = _copy_task(6, T, seed=2)
    logits, _ = jax.jit(jm.model.call)(params, {}, enc, dec)
    got = tm.model(torch.from_numpy(enc), torch.from_numpy(dec))
    assert tuple(got.shape) == (6, T, VOCAB)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(logits),
                               rtol=0, atol=ATOL)
    served = JaxIM.from_keras_net(jm.model, params, {}).predict([enc, dec])
    np.testing.assert_allclose(tm.inference_model().predict([enc, dec]),
                               np.asarray(served), rtol=0, atol=ATOL)


def test_dense_bridge_maps_leaves_in_jax_order():
    """LSTM states are (h, c) per layer: leaf i of ``[h0, c0, h1, c1]``
    goes through ``w{i}`` on both sides."""
    reset_name_scope()
    br = Bridge("dense", 3)
    br.build_states(torch.Generator().manual_seed(0), [3] * 4)
    states = [(torch.randn(2, 3), torch.randn(2, 3)) for _ in range(2)]
    out = br.apply_states(states)
    leaves = [s for st in states for s in st]
    want = [torch.tanh(x @ br.leaf(f"w{i}") + br.leaf(f"b{i}"))
            for i, x in enumerate(leaves)]
    got = [s for st in out for s in st]
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="bridge_type"):
        Bridge("quantum")


@pytest.mark.parametrize("stop_sign", [None, 3])
@pytest.mark.parametrize("rnn_type,bridge", [("lstm", "dense"),
                                             ("gru", "pass")])
def test_greedy_infer_matches_jax(rnn_type, bridge, stop_sign):
    jm, tm, _, enc = _s2s_pair(seed=4, rnn_type=rnn_type,
                               bridge_type=bridge, num_layers=2)
    want = jm.infer(enc, start_sign=1, max_seq_len=7, stop_sign=stop_sign)
    got = tm.infer(enc, start_sign=1, max_seq_len=7, stop_sign=stop_sign)
    assert got.dtype == np.int32 and got.shape == (6, 7)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tm.infer(enc, start_sign=1, max_seq_len=7, stop_sign=stop_sign), got)
    if stop_sign is not None:
        for row in got:
            hits = np.nonzero(row == stop_sign)[0]
            if hits.size:
                assert (row[hits[0]:] == stop_sign).all()


def _near_ties(tm, enc, kw):
    """Whether the port's beam search met a near-tie (within 1e-5) among
    any step's top ``K + 1`` candidate scores, where a token or a beam's
    order could hang on rounding: the JAX decode, whose scores agree
    within 1e-6, then meets no tie either (a finished beam's NEG rows are
    left out)."""
    seen = []
    real_topk = torch.topk

    def spy(x, k, *a, **kw_):
        vals = real_topk(x, k + 1, *a, **kw_)[0]
        seen.append(vals.numpy().copy())
        return real_topk(x, k, *a, **kw_)

    torch.topk = spy
    try:
        tm.infer_beam(enc, start_sign=1, **kw)
    finally:
        torch.topk = real_topk
    assert seen
    for vals in seen:
        for row in vals:
            row = np.sort(row[row > -1e29])
            if row.size > 1 and np.diff(row).min() < 1e-5:
                return True
    return False


@pytest.mark.parametrize("kw", [
    dict(beam_size=1, max_seq_len=6),
    dict(beam_size=3, max_seq_len=6),
    dict(beam_size=4, max_seq_len=7, stop_sign=2, length_penalty=0.6)])
def test_beam_search_matches_jax(kw):
    jm, tm, _, enc = _s2s_pair(seed=6, rnn_type="lstm",
                               bridge_type="dense", num_layers=2)
    want_seq, want_sc = jm.infer_beam(enc, start_sign=1, **kw)
    seq, sc = tm.infer_beam(enc, start_sign=1, **kw)
    assert seq.dtype == np.int32 and seq.shape == want_seq.shape
    assert sc.dtype == np.float32 and sc.shape == (6,)
    np.testing.assert_allclose(sc, want_sc, rtol=0, atol=ATOL)
    assert not _near_ties(tm, enc, kw)
    np.testing.assert_array_equal(seq, want_seq)
    if kw["beam_size"] == 1:
        np.testing.assert_array_equal(
            seq, tm.infer(enc, start_sign=1, max_seq_len=kw["max_seq_len"]))


def test_copy_task_adam_step_matches_jax():
    import optax

    jm, tm, params, _ = _s2s_pair(seed=8, scale=0.3, rnn_type="lstm",
                                  bridge_type="dense", num_layers=2)
    enc, dec, tgt = _copy_task(16, T, seed=9)
    loss_fn = jobj.get(LOSS)
    tx = jopt.Adam(lr=1e-3)

    @jax.jit
    def step(p):
        def loss(q):
            return loss_fn(tgt, jm.model.call(q, {}, enc, dec,
                                              training=True)[0])

        updates, _ = tx.update(jax.grad(loss)(p), tx.init(p), p)
        return optax.apply_updates(p, updates)

    want = step(params)
    tm.compile(optimizer=topt.Adam(lr=1e-3), loss=LOSS)
    tm.fit([enc, dec], tgt, batch_size=16, nb_epoch=1, verbose=False)
    got = export_params(tm.model)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    for path, w in flat_w:
        g = got
        for key in path:
            g = g[key.key]
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=ATOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_unroll_and_detect_anomalies_match_jax():
    rs = np.random.RandomState(10)
    for data, length, step in ((np.arange(30, dtype=np.float32), 4, 1),
                               (rs.randn(40, 3).astype(np.float32), 6, 2)):
        wx, wy = jad.unroll(data, length, step)
        gx, gy = tad.unroll(data, length, step)
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    with pytest.raises(ValueError, match="too short"):
        tad.unroll(np.arange(3), 5)
    y = rs.randn(300)
    pred = y + rs.randn(300) * 0.01
    pred[[17, 120, 255]] += 5.0
    for kw in ({}, {"anomaly_size": 3}, {"threshold": 1.0}):
        np.testing.assert_array_equal(tad.detect_anomalies(y, pred, **kw),
                                      jad.detect_anomalies(y, pred, **kw))
    assert sorted(tad.detect_anomalies(y, pred, anomaly_size=3)) == [
        17, 120, 255]


def test_anomaly_detector_forward_matches_jax():
    jax_reset_names()
    reset_name_scope()
    jm, tm = jad.AnomalyDetector(**AD), AnomalyDetector(device="cpu", **AD)
    shapes = jax.eval_shape(lambda k: jm.model.build(k)[0],
                            jax.random.PRNGKey(0))
    params = _draw(shapes, 11, 0.5)
    load_jax_params(tm.model, params)
    x = np.random.RandomState(12).randn(9, 8, 2).astype(np.float32)
    want = np.asarray(JaxIM.from_keras_net(jm.model, params, {}).predict(x))
    got = tm.model.eval()(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (9, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert tm.detect_anomalies(want, got, threshold=1e-3).size == 0


@pytest.mark.parametrize("kind", ["seq2seq", "anomaly"])
def test_save_model_and_load_model_by_name(kind, tmp_path):
    """A JAX ``save_model`` directory loads into the port by class name
    and answers as the JAX model; the port's loads back into the
    port."""
    jax_reset_names()
    reset_name_scope()
    if kind == "seq2seq":
        jm, tm, params, enc = _s2s_pair(seed=13, rnn_type="gru",
                                        bridge_type="dense", num_layers=2)
        xs = [enc, enc]
    else:
        jm, tm = jad.AnomalyDetector(**AD), AnomalyDetector(device="cpu",
                                                            **AD)
        params = _draw(jax.eval_shape(lambda k: jm.model.build(k)[0],
                                      jax.random.PRNGKey(0)), 14, 0.5)
        load_jax_params(tm.model, params)
        xs = [np.random.RandomState(15).randn(5, 8, 2).astype(np.float32)]
        jm.compile(optimizer="adam", loss="mse")
        jm.estimator._ensure_built(xs)
        jm.estimator.set_initial_weights(params)
    want = np.asarray(JaxIM.from_keras_net(jm.model, params, {}).predict(
        xs if len(xs) > 1 else xs[0]))
    jm.save_model(str(tmp_path / "jax"))
    reset_name_scope()
    got = ZooModel.load_model(str(tmp_path / "jax"), device="cpu")
    assert type(got) is type(tm) and got.config() == json.load(
        open(tmp_path / "jax" / "config.json"))["config"]
    out = got.model.eval()(*[torch.from_numpy(x) for x in xs])
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0,
                               atol=ATOL)
    tm.save_model(str(tmp_path / "port"))
    reset_name_scope()
    back = ZooModel.load_model(str(tmp_path / "port"), device="cpu")
    assert export_params(back.model).keys() == params.keys()
    if kind == "seq2seq":
        np.testing.assert_array_equal(
            back.infer(enc, 1, 6, stop_sign=2), tm.infer(enc, 1, 6,
                                                         stop_sign=2))
