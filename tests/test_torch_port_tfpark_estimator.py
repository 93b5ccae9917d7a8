"""The port's ``tfpark.TFDataset`` and ``tfpark.TFEstimator`` against the
JAX package's.

``TFDataset``'s constructors are plain numpy, so their arrays must be
equal.  ``TFEstimator`` trains a small NeuralCF read from TFRecords in
both packages from one numpy-made init (the JAX tree, loaded into the
port by name) on the CPU: the same batches in the same order (both
Estimators draw their shuffle from ``RandomState(seed)``), so the
per-epoch training losses, the evaluation and the predictions agree
within rtol 1e-5 / atol 1e-6 (f32 sums of a few hundred terms in other
orders, over a handful of Adam steps).
"""

import numpy as np
import pytest

from analytics_zoo_tpu.data.tfrecord import (make_example as jmake,
                                             write_tfrecords as jwrite)
from analytics_zoo_tpu.models import NeuralCF as JaxNCF
from analytics_zoo_tpu.nn import reset_name_scope as jax_reset_names
from analytics_zoo_tpu.tfpark import estimator as jest
from analytics_zoo_tpu.tfpark.tf_dataset import TFDataset as JTFDataset
from analytics_zoo_tpu.train import optimizers as jopt

from analytics_zoo_tpu_torch.core import context
from analytics_zoo_tpu_torch.data import FeatureSet
from analytics_zoo_tpu_torch.data.tfrecord import (make_example,
                                                   write_tfrecords)
from analytics_zoo_tpu_torch.models import NeuralCF
from analytics_zoo_tpu_torch.nn import reset_name_scope
from analytics_zoo_tpu_torch.tfpark import (EstimatorSpec, ModeKeys,
                                            TFDataset, TFEstimator)
from analytics_zoo_tpu_torch.train import optimizers as topt

RTOL, ATOL = 1e-5, 1e-6
USERS, ITEMS = 60, 40
KW = dict(user_embed=8, item_embed=8, hidden_layers=(16, 8), mf_embed=8)


@pytest.fixture(autouse=True)
def cpu_context():
    context.init_zoo_context(device="cpu")
    yield
    context.set_zoo_context(None)


def _ratings(n, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randint(1, USERS + 1, n), rs.randint(1, ITEMS + 1, n),
            rs.randint(0, 5, n))


def _write(path, n, writer=write_tfrecords, maker=make_example):
    u, i, y = _ratings(n)
    writer(path, [maker({"user": [int(a)], "item": [int(b)],
                         "label": [int(c)]}) for a, b, c in zip(u, i, y)])
    return u, i, y


# ---------------------------------------------------------------------------
# TFDataset
# ---------------------------------------------------------------------------

def test_from_tfrecord_file_equals_jax(tmp_path):
    path = str(tmp_path / "ratings.tfrecord")
    u, i, y = _write(path, 300)
    got = TFDataset.from_tfrecord_file(path, ["user", "item"], "label",
                                       batch_size=64)
    want = JTFDataset.from_tfrecord_file(path, ["user", "item"], "label",
                                         batch_size=64)
    assert len(got.features) == len(want.features) == 2
    for a, b in zip(got.features + got.labels, want.features + want.labels):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.features[0][:, 0], u)
    np.testing.assert_array_equal(got.y, y)
    assert got.batch_size == 64 and len(got) == 300
    no_label = TFDataset.from_tfrecord_file(path, ["item"])
    assert no_label.y is None and no_label.x.shape == (300, 1)
    empty = str(tmp_path / "empty.tfrecord")
    write_tfrecords(empty, [])
    with pytest.raises(ValueError, match="no records"):
        TFDataset.from_tfrecord_file(empty, ["user"])


def test_files_written_by_jax_read_the_same(tmp_path):
    path = str(tmp_path / "jax.tfrecord")
    _write(path, 50, writer=jwrite, maker=jmake)
    got = TFDataset.from_tfrecord_file(path, ["user", "item"], "label")
    want = JTFDataset.from_tfrecord_file(path, ["user", "item"], "label")
    for a, b in zip(got.features + got.labels, want.features + want.labels):
        np.testing.assert_array_equal(a, b)


def test_constructors_equal_jax():
    import pandas as pd

    rs = np.random.RandomState(1)
    x, x2 = rs.randn(20, 3), rs.randn(20, 2)
    y = rs.randint(0, 2, 20)
    vx, vy = rs.randn(5, 3), rs.randint(0, 2, 5)

    class Source:                       # a tf.data.Dataset stand-in
        def __init__(self, pairs):
            self.pairs = pairs

        def as_numpy_iterator(self):
            return iter(self.pairs)

    pairs = [(x[k], y[k]) for k in range(20)]
    df = pd.DataFrame({"a": list(x), "b": list(x2), "y": y})
    cases = [
        (lambda m: m.from_ndarrays((x, y), batch_size=8,
                                   val_tensors=(vx, vy)), None),
        (lambda m: m.from_ndarrays([x, x2]), None),
        (lambda m: m.from_tf_data_dataset(Source(pairs), max_examples=12),
         None),
        (lambda m: m.from_tf_data_dataset(Source([p[0] for p in pairs])),
         None),
        (lambda m: m.from_dataframe(df, ["a", "b"], ["y"]), None),
    ]
    for make, _ in cases:
        got, want = make(TFDataset), make(JTFDataset)
        for a, b in zip(got.features + got.labels + got.val_features
                        + got.val_labels,
                        want.features + want.labels + want.val_features
                        + want.val_labels):
            np.testing.assert_array_equal(a, b)
        assert len(got) == len(want)
        assert (got.validation is None) == (want.validation is None)
    fs = FeatureSet.from_ndarrays([x, x2], y)
    got = TFDataset.from_feature_set(fs, batch_size=4)
    assert len(got.features) == 2 and got.y is not None
    np.testing.assert_array_equal(got.y, y)
    flat = TFDataset.from_feature_set(fs, has_labels=False)
    assert flat.y is None and len(flat.features) == 3
    with pytest.raises(ValueError):
        TFDataset([x, x2[:5]])
    with pytest.raises(ValueError):
        TFDataset([])


def test_from_text_set_equals_jax():
    from analytics_zoo_tpu.data.text import TextSet as JTextSet

    from analytics_zoo_tpu_torch.data.text import TextSet

    texts = ["the cat sat", "a dog ran far", "cats and dogs", "the end"]
    labels = [0, 1, 1, 0]

    def prepared(cls):
        return (cls.from_texts(texts, labels).tokenize().normalize()
                .word2idx().shape_sequence(5))

    got = TFDataset.from_text_set(prepared(TextSet), batch_size=2)
    want = JTFDataset.from_text_set(prepared(JTextSet), batch_size=2)
    np.testing.assert_array_equal(got.x, want.x)
    np.testing.assert_array_equal(got.y, want.y)


# ---------------------------------------------------------------------------
# TFEstimator
# ---------------------------------------------------------------------------

def _init_tree(model, seed=3):
    rs = np.random.RandomState(seed)
    return {layer: {leaf: (rs.randn(*v.shape) * 0.1).astype(np.float32)
                    for leaf, v in sub.items()}
            for layer, sub in model.params().items()}


def _estimators(model_dir=None):
    """A port and a JAX TFEstimator over NeuralCF model_fns, and the
    numpy init tree both start from."""
    from analytics_zoo_tpu import init_zoo_context as jax_init_context

    jax_init_context()
    jax_reset_names()
    jncf = JaxNCF(USERS, ITEMS, table_placement="replicated", **KW)
    reset_name_scope()
    tncf = NeuralCF(USERS, ITEMS, device="cpu", **KW)
    init = _init_tree(tncf.model)

    def jax_model_fn(features, labels, mode, params):
        return jest.EstimatorSpec(
            mode, model=jncf.model, loss="sparse_categorical_crossentropy",
            optimizer=jopt.Adam(lr=params["lr"]), metrics=["accuracy"])

    params = {"lr": 3e-3}
    port = TFEstimator.from_model_fn(_port_model_fn(tncf),
                                     model_dir=model_dir, params=params)
    jax = jest.TFEstimator.from_model_fn(jax_model_fn, params=params)
    return port, jax, init


def _port_model_fn(tncf):
    def model_fn(features, labels, mode, params):
        return EstimatorSpec(mode, model=tncf.model,
                             loss="sparse_categorical_crossentropy",
                             optimizer=topt.Adam(lr=params["lr"]),
                             metrics=["accuracy"],
                             predictions_fn=lambda p: p.argmax(-1))
    return model_fn


def _seed_weights(est, xs, y, init):
    est._build(xs, y, ModeKeys.TRAIN)
    est.estimator.set_initial_weights(init)


def test_train_evaluate_predict_match_jax(tmp_path):
    path = str(tmp_path / "ratings.tfrecord")
    _write(path, 512)
    port, jax, init = _estimators()
    ds = TFDataset.from_tfrecord_file(path, ["user", "item"], "label")
    jds = JTFDataset.from_tfrecord_file(path, ["user", "item"], "label")
    _seed_weights(port, ds.features, ds.y, init)
    _seed_weights(jax, jds.features, jds.y, init)
    port.train(lambda: ds, batch_size=64, epochs=2)
    jax.train(lambda: jds, batch_size=64, epochs=2)
    tloss = [h["loss"] for h in port.estimator.history]
    jloss = [h["loss"] for h in jax.estimator.history]
    assert len(tloss) == len(jloss) == 2
    np.testing.assert_allclose(tloss, jloss, rtol=RTOL, atol=ATOL)
    assert port.estimator.global_step == 16

    got = port.evaluate(lambda: (ds.features, ds.y), batch_size=128)
    want = jax.evaluate(lambda: (jds.features, jds.y), batch_size=128)
    assert set(got) == set(want) == {"loss", "accuracy"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL)

    xs = [a[:77] for a in ds.features]
    classes = port.predict(lambda: xs, batch_size=32)
    raw = port.estimator.predict(xs, batch_size=32)
    want_raw = np.asarray(jax.predict(lambda: [a[:77] for a in
                                               jds.features],
                                      batch_size=32))
    np.testing.assert_allclose(raw, want_raw, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(classes, raw.argmax(-1))


def test_steps_cap_and_epochs_continue(tmp_path):
    path = str(tmp_path / "ratings.tfrecord")
    _write(path, 256)
    port, jax, init = _estimators()
    ds = TFDataset.from_tfrecord_file(path, ["user", "item"], "label")
    jds = JTFDataset.from_tfrecord_file(path, ["user", "item"], "label")
    _seed_weights(port, ds.features, ds.y, init)
    _seed_weights(jax, jds.features, jds.y, init)
    port.train(lambda: ds, steps=11, batch_size=32)
    jax.train(lambda: jds, steps=11, batch_size=32)
    assert port.estimator.global_step == jax.estimator.global_step == 11
    assert port.estimator.finished_epochs == jax.estimator.finished_epochs
    np.testing.assert_allclose(
        [h["loss"] for h in port.estimator.history],
        [h["loss"] for h in jax.estimator.history], rtol=RTOL, atol=ATOL)


def test_model_dir_resumes_and_predicts_without_train(tmp_path):
    path = str(tmp_path / "ratings.tfrecord")
    _write(path, 128)
    ds = TFDataset.from_tfrecord_file(path, ["user", "item"], "label")
    first, _, init = _estimators(model_dir=str(tmp_path / "ckpt"))
    _seed_weights(first, ds.features, ds.y, init)
    first.train(lambda: ds, batch_size=32, epochs=1)
    first.estimator._ckpt_mgr.wait()
    want = first.estimator.predict(ds.features, batch_size=64)

    reset_name_scope()
    again = TFEstimator(_port_model_fn(NeuralCF(USERS, ITEMS, device="cpu",
                                                **KW)),
                        model_dir=str(tmp_path / "ckpt"),
                        params={"lr": 3e-3})
    got = again.predict(lambda: ds.features, batch_size=64)
    np.testing.assert_array_equal(got, want.argmax(-1))


def test_spec_and_model_fn_errors():
    assert (ModeKeys.TRAIN, ModeKeys.EVAL, ModeKeys.PREDICT) == \
        ("train", "eval", "predict")
    with pytest.raises(ValueError, match="needs a model"):
        EstimatorSpec(ModeKeys.TRAIN)
    with pytest.raises(ValueError, match="needs a loss"):
        EstimatorSpec(ModeKeys.EVAL, model=object())
    assert EstimatorSpec(ModeKeys.PREDICT, model=object()).loss is None
    bad = TFEstimator(lambda f, l, m, p: "not a spec")
    x = np.zeros((4, 1), np.int32)
    with pytest.raises(TypeError, match="EstimatorSpec"):
        bad.train(lambda: ([x, x], np.zeros(4, np.int32)))
    with pytest.raises(ValueError, match="labels"):
        TFEstimator(_port_model_fn(None)).train(lambda: [x, x])
    with pytest.raises(RuntimeError):
        TFEstimator(_port_model_fn(None)).estimator
