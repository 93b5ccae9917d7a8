"""The PyTorch port's serving slice against the JAX package: NeuralCF
served through ``InferenceModel`` in float32, int8 and int4.

The weights are made with ``np.random.RandomState`` in the JAX package's
tree layout; the JAX model uses them as they are and the port loads them
with ``load_jax_params``.  Tolerance: atol 1e-6 on the probabilities (the
two sum in different orders); quantized leaves must be equal exactly.
The JAX side routes its kernels to their plain references on the CPU, as
its own tests do.  Everything runs on the CPU (``device="cpu"``).
"""

import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.deploy.inference import InferenceModel as JaxIM
from analytics_zoo_tpu.models import NeuralCF as JaxNCF
from analytics_zoo_tpu.nn import reset_name_scope as jax_reset_names

from analytics_zoo_tpu_torch.convert import load_jax_params
from analytics_zoo_tpu_torch.core import context
from analytics_zoo_tpu_torch.core.profiling import TIMERS
from analytics_zoo_tpu_torch.deploy import DynamicBatcher, InferenceModel
from analytics_zoo_tpu_torch.models import NeuralCF
from analytics_zoo_tpu_torch.nn import (Dense, Input, Model, Sequential,
                                        reset_name_scope)
from analytics_zoo_tpu_torch.nn.layers import Embedding, EmbeddingBag, merge
from analytics_zoo_tpu_torch.observe.metrics import METRICS
from analytics_zoo_tpu_torch.robust.errors import DeadlineExpired

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-6

# (users, items, keyword widths): a small NCF whose tables and first MLP
# kernel reach quantize_pytree's 1024-element floor (even and odd table
# rows, so int4 packs one table and falls back to int8 on the other), and
# the published MovieLens-1M width
WIDTHS = {
    "small": (99, 80, dict(user_embed=16, item_embed=16, mf_embed=16,
                           hidden_layers=(32, 16))),
    "ml1m": (6040, 3706, {}),
}


@pytest.fixture(autouse=True)
def fresh_context():
    context.set_zoo_context(None)
    yield
    context.set_zoo_context(None)


def _numpy_params(jax_model, seed):
    """Seeded weights of a meaningful scale, in the JAX tree layout."""
    shapes, _ = jax_model.build(jax.random.PRNGKey(0))
    rs = np.random.RandomState(seed)
    return {layer: {leaf: (rs.randn(*np.shape(v)) * 0.5).astype(np.float32)
                    for leaf, v in sub.items()}
            for layer, sub in shapes.items()}


def _models(width, seed=0):
    users, items, kw = WIDTHS[width]
    jax_reset_names()
    jncf = JaxNCF(users, items, table_placement="replicated", **kw)
    reset_name_scope()
    tncf = NeuralCF(users, items, device="cpu", **kw)
    return jncf, tncf, _numpy_params(jncf.model, seed)


def _pairs(users, items, n, seed):
    rs = np.random.RandomState(seed)
    return (rs.randint(1, users + 1, (n, 1)).astype(np.int32),
            rs.randint(1, items + 1, (n, 1)).astype(np.int32))


def _assert_trees_equal(got, want):
    assert set(got) == set(want)
    for lname, sub in want.items():
        assert set(got[lname]) == set(sub), lname
        for leaf, w in sub.items():
            g = got[lname][leaf]
            if isinstance(w, dict):
                assert set(g) == set(w), (lname, leaf)
                for k in w:
                    np.testing.assert_array_equal(g[k].numpy(),
                                                  np.asarray(w[k]))
            else:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("weight_dtype", ["float32", "int8", "int4"])
@pytest.mark.parametrize("width", ["small", "ml1m"])
def test_ncf_serving_matches_jax(width, weight_dtype):
    jncf, tncf, params = _models(width)
    users, items, _ = WIDTHS[width]
    u, i = _pairs(users, items, 300, seed=1)     # a full chunk + a tail
    jm = JaxIM.from_keras_net(jncf.model, params, {},
                              weight_dtype=weight_dtype)
    tm = InferenceModel.from_keras_net(tncf.model, params,
                                       weight_dtype=weight_dtype,
                                       device="cpu")
    want = np.asarray(jm.predict([u, i]))
    got = tm.predict([u, i])
    assert got.shape == (300, 5) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    if weight_dtype == "float32":
        _assert_trees_equal(tm.params(), params)
    else:
        _assert_trees_equal(tm.params(), jm._qparams)
        assert tm.weight_nbytes() < InferenceModel.from_keras_net(
            tncf.model, params, device="cpu").weight_nbytes()
    assert tm.compile_count == 2                 # the 256 and 64 buckets


def test_ml1m_tree_and_quantized_leaf_kinds():
    """At the MovieLens-1M width only mlp_dense_0's kernel and the four
    tables reach the 1024-element floor; int4 packs the kernel and keeps
    the odd-row tables on int8."""
    jncf, tncf, params = _models("ml1m")
    tree = tncf.model.params()
    assert {k: {leaf: tuple(v.shape) for leaf, v in sub.items()}
            for k, sub in tree.items()} == {
        k: {leaf: np.shape(v) for leaf, v in sub.items()}
        for k, sub in params.items()}
    tm = InferenceModel.from_keras_net(tncf.model, params,
                                       weight_dtype="int4", device="cpu")
    kinds = {(layer, leaf): sorted(v) for layer, sub in tm.params().items()
             for leaf, v in sub.items() if isinstance(v, dict)}
    assert kinds == {
        ("mlp_dense_0", "kernel"): ["q4", "scale"],
        ("mlp_user_embed", "table"): ["q", "scale"],
        ("mlp_item_embed", "table"): ["q", "scale"],
        ("mf_user_embed", "table"): ["q", "scale"],
        ("mf_item_embed", "table"): ["q", "scale"]}


def test_quantized_tree_loads_across_packages():
    """A tree the JAX package quantized loads into the port as it is."""
    jncf, tncf, params = _models("small")
    jm = JaxIM.from_keras_net(jncf.model, params, {}, weight_dtype="int8")
    tm = InferenceModel.from_keras_net(tncf.model, jm._qparams,
                                       device="cpu")
    u, i = _pairs(99, 80, 20, seed=4)
    np.testing.assert_allclose(tm.predict([u, i]),
                               np.asarray(jm.predict([u, i])), atol=ATOL)


def test_batcher_answers_match_direct_predict():
    _, tncf, params = _models("small")
    tm = InferenceModel.from_keras_net(tncf.model, params,
                                       weight_dtype="int8", device="cpu")
    u, i = _pairs(99, 80, 48, seed=2)
    want = tm.predict([u, i])
    window = METRICS.snapshot()
    flushes = (TIMERS.count("serving/flush_full")
               + TIMERS.count("serving/flush_deadline"))
    batcher = DynamicBatcher(tm, max_batch=8, max_latency_ms=2.0)
    got = [None] * 48
    errors = []

    def client(rows):
        for r in rows:
            try:
                got[r] = batcher.predict([u[r:r + 1], i[r:r + 1]])
            except Exception as e:  # reported below
                errors.append(e)

    threads = [threading.Thread(target=client, args=(range(t, 48, 6),))
               for t in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    batcher.close()
    assert not errors and not any(t.is_alive() for t in threads)
    np.testing.assert_allclose(np.concatenate(got), want, rtol=0, atol=ATOL)
    waits = METRICS.delta(window)["histograms"][
        'serving_stage_seconds{model="default",stage="batch_wait"}']
    assert waits["count"] == 48 and waits["p99"] >= waits["p50"] >= 0
    assert TIMERS.stats()["serving/batch_wait"]["count"] >= 48
    assert (TIMERS.count("serving/flush_full")
            + TIMERS.count("serving/flush_deadline")) > flushes


def test_batcher_sheds_expired_requests():
    _, tncf, params = _models("small")
    tm = InferenceModel.from_keras_net(tncf.model, params, device="cpu")
    batcher = DynamicBatcher(tm, max_batch=4, max_latency_ms=1.0)
    done = threading.Event()
    seen = {}

    def cb(out, err):
        seen["err"] = err
        done.set()

    u, i = _pairs(99, 80, 1, seed=3)
    window = METRICS.snapshot()
    batcher.submit([u, i], cb, deadline=time.monotonic() - 1.0)
    assert done.wait(timeout=10)
    batcher.close()
    assert isinstance(seen["err"], DeadlineExpired)
    assert METRICS.delta(window)["counters"] == {
        'serving_shed_total{code="expired",model="default"}': 1}


def test_recommend_for_user_matches_jax_ranking():
    jncf, tncf, params = _models("small")
    load_jax_params(tncf.model, params)
    tncf.inference_model(weight_dtype="int8")
    items = np.arange(1, 81)
    got = tncf.recommend_for_user(7, items, max_items=10)
    jm = JaxIM.from_keras_net(jncf.model, params, {}, weight_dtype="int8")
    probs = np.asarray(jm.predict([np.full((80, 1), 7, np.int32),
                                   items.reshape(-1, 1).astype(np.int32)]))
    scores = (probs * np.arange(1, 6)).sum(-1)
    top = np.argsort(-scores)[:10]
    assert [g[0] for g in got] == [int(items[j]) for j in top]
    np.testing.assert_allclose([g[1] for g in got], scores[top], atol=1e-5)


def test_predict_buckets_pad_and_chunk():
    _, tncf, params = _models("small")
    tm = InferenceModel.from_keras_net(tncf.model, params, device="cpu",
                                       batch_buckets=(8, 64))
    u, i = _pairs(99, 80, 150, seed=5)
    full = tm.predict([u, i])
    for n in (3, 8, 17, 150):
        np.testing.assert_allclose(tm.predict([u[:n], i[:n]]), full[:n],
                                   rtol=0, atol=ATOL)
    assert tm.compile_count == 2
    assert METRICS.delta(None)["gauges"][
        'inference_compile_count{model="default"}'] == 2
    assert tm.predict_classes([u[:5], i[:5]]).shape == (5,)
    np.testing.assert_allclose(tm.predict([u, i], batch_size=40), full,
                               rtol=0, atol=ATOL)


def test_serving_weight_dtype_knob():
    _, tncf, _ = _models("small")
    context.init_zoo_context(serving_weight_dtype="int4")
    assert InferenceModel.from_keras_net(
        tncf.model, device="cpu")._weight_dtype == "int4"
    assert InferenceModel.from_keras_net(
        tncf.model, int8=True, device="cpu")._weight_dtype == "int8"
    with pytest.raises(ValueError, match="weight_dtype"):
        InferenceModel.from_keras_net(tncf.model, weight_dtype="int2",
                                      device="cpu")


def test_from_keras_net_needs_a_card_unless_asked(monkeypatch):
    _, tncf, _ = _models("small")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceModel.from_keras_net(tncf.model)
    with pytest.raises(RuntimeError, match="CUDA"):
        NeuralCF(10, 10)


def test_table_placement():
    NeuralCF(10, 10, table_placement="replicated", device="cpu")
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        NeuralCF(10, 10, table_placement="sharded", device="cpu")
    with pytest.raises(ValueError, match="table_placement"):
        NeuralCF(10, 10, table_placement="striped", device="cpu")


def test_load_jax_params_rejects_mismatched_trees():
    _, tncf, params = _models("small")
    bad = {k: dict(v) for k, v in params.items()}
    del bad["mlp_dense_0"]["bias"]
    with pytest.raises(ValueError, match="missing leaves"):
        load_jax_params(tncf.model, bad)
    bad = {k: dict(v) for k, v in params.items()}
    bad["ncf_head"]["gamma"] = np.zeros(5, np.float32)
    with pytest.raises(ValueError, match="extra leaves"):
        load_jax_params(tncf.model, bad)
    bad = {k: dict(v) for k, v in params.items()}
    bad["ncf_head"]["kernel"] = np.zeros((3, 5), np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(tncf.model, bad)
    bad = {k: v for k, v in params.items() if k != "merge_3"}
    with pytest.raises(ValueError, match="missing layers"):
        load_jax_params(tncf.model, bad)
    bad = {k: dict(v) for k, v in params.items()}
    bad["ncf_head"]["kernel"] = {"q": np.zeros((16, 5), np.int8),
                                 "scale": np.ones((1, 5), np.float32)}
    with pytest.raises(ValueError, match="does not fit"):
        load_jax_params(tncf.model, bad)


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
@pytest.mark.parametrize("pad_id", [None, 0])
def test_embedding_layers_match_jax(combiner, pad_id):
    from analytics_zoo_tpu.nn.layers.embedding import (
        Embedding as JEmb, EmbeddingBag as JBag)

    rs = np.random.RandomState(11)
    table = rs.randn(20, 6).astype(np.float32)
    ids = rs.randint(1, 21, (7, 4)).astype(np.int32)
    ids[0, :2] = 0
    jbag = JBag(20, 6, combiner=combiner, pad_id=pad_id)
    bag = EmbeddingBag(20, 6, combiner=combiner, pad_id=pad_id)
    bag.set_leaf("table", table)
    want, _ = jbag.call({"table": table}, {}, ids % 20)
    np.testing.assert_allclose(bag(torch.from_numpy(ids % 20)).detach().numpy(),
                               np.asarray(want), rtol=1e-5, atol=ATOL)
    jemb, emb = JEmb(20, 6, zero_based=False), Embedding(20, 6,
                                                         zero_based=False)
    emb.set_leaf("table", table)
    ids = np.maximum(ids, 1)         # in range once shifted to 0-based
    want, _ = jemb.call({"table": table}, {}, ids)
    np.testing.assert_array_equal(emb(torch.from_numpy(ids)).detach().numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("act", ["relu", "tanh", "sigmoid", "softmax",
                                 "log_softmax", "softplus", "softsign",
                                 "elu", "selu", "gelu", "silu",
                                 "leaky_relu", "hard_sigmoid", "relu6"])
def test_activations_match_jax(act):
    from analytics_zoo_tpu.nn import activations as jact

    from analytics_zoo_tpu_torch.nn import activations

    x = np.random.RandomState(0).randn(4, 9).astype(np.float32) * 3
    np.testing.assert_allclose(
        activations.get(act)(torch.from_numpy(x)).numpy(),
        np.asarray(jact.get(act)(x)), rtol=1e-5, atol=1e-6)


def test_graph_and_sequential_build_shapes():
    from analytics_zoo_tpu_torch.nn import initializers

    reset_name_scope()
    a, b = Input(shape=(3,)), Input(shape=(3,))
    h = merge([a, b], mode="concat")
    out = Dense(4, activation="relu")((-(h - 1.0) + 2.0) / 2.0)
    model = Model([a, b], [out, merge([a, b], mode="mul") * 2.0])
    model.build(torch.Generator().manual_seed(0))
    assert model._output_shape == ((2, 4), (2, 3))
    x = torch.ones(5, 3)
    y0, y1 = model(x, 2 * x)
    assert tuple(y0.shape) == (5, 4)
    np.testing.assert_array_equal(y1.detach().numpy(), np.full((5, 3), 4.0))
    seq = Sequential([Dense(6, input_shape=(3,)), Dense(2)])
    seq.build(torch.Generator().manual_seed(0))
    assert seq._output_shape == (2, 2)
    assert tuple(seq(x).shape) == (5, 2)
    g = torch.Generator().manual_seed(0)
    u = initializers.get("uniform")(g, (1000,))
    assert 0.0 <= float(u.min()) and float(u.max()) < 0.05
    lim = np.sqrt(6.0 / (30 + 50))
    w = initializers.get("glorot_uniform")(g, (30, 50))
    assert float(w.abs().max()) <= lim
    assert float(initializers.get("glorot_normal")(g, (30, 50)).std()) > 0


def test_port_imports_no_jax():
    """Training and serving NCF, serving BERTClassifier, ClusterServing
    and the bf16 codec, training and serving a small WideAndDeep and
    SessionRecommender, the load harness (every ``loadgen`` module, and
    ``server_main``'s model fitted and served), ``from_function``,
    ``load_torch``, the Redis queue, and NCF trained through the STREAM
    tier from ``.npy`` slices with TensorBoard scalars and evaluated
    with AUC, and the image slice (the layers, ``data/image.py``, the
    VOC reader, a small SSD trained and detecting, an image record
    served), through the port, load neither jax, ml_dtypes nor the JAX
    package."""
    code = (
        "import sys, numpy as np\n"
        "import analytics_zoo_tpu_torch.train.estimator\n"
        "from analytics_zoo_tpu_torch.data import movielens_featureset\n"
        "from analytics_zoo_tpu_torch.models import NeuralCF\n"
        "from analytics_zoo_tpu_torch.deploy import InferenceModel\n"
        "ncf = NeuralCF(30, 20, device='cpu')\n"
        "ncf.compile('adam', 'sparse_categorical_crossentropy',"
        " metrics=['accuracy'])\n"
        "ncf.fit([np.ones((8, 1), np.int32), np.ones((8, 1), np.int32)],"
        " np.ones(8, np.int32), batch_size=4, epochs=1, verbose=False)\n"
        "m = InferenceModel.from_keras_net(ncf.model, weight_dtype='int4',"
        " device='cpu')\n"
        "out = m.predict([np.ones((3, 1), np.int32),"
        " np.ones((3, 1), np.int32)])\n"
        "assert out.shape == (3, 5)\n"
        "from analytics_zoo_tpu_torch.tfpark import BERTClassifier\n"
        "bert = BERTClassifier(2, bert_config=dict(vocab=50, hidden_size=32,"
        " intermediate_size=64))\n"
        "bm = InferenceModel.from_keras_net(bert, device='cpu')\n"
        "ids = np.ones((3, 8), np.int32)\n"
        "assert bm.predict([ids, 0 * ids, ids]).shape == (3, 2)\n"
        "import analytics_zoo_tpu_torch.deploy.autoscale\n"
        "from analytics_zoo_tpu_torch.deploy import (ClusterServing,"
        " MemoryQueue, InputQueue, OutputQueue, ServingConfig, codec)\n"
        "q = MemoryQueue()\n"
        "cs = ClusterServing(bm, q, ServingConfig(postprocess_top_n=1))"
        ".start()\n"
        "r = OutputQueue(q).query(InputQueue(q).enqueue(ids=ids[0]),"
        " timeout=60)\n"
        "cs.stop()\n"
        "assert len(r) == 1, r\n"
        "codec.unpack_record(codec.pack_record({'x': codec.torch_to_bf16("
        "bm._net.bert.leaf('word_embed')[:2].bfloat16())}))\n"
        "from analytics_zoo_tpu_torch.models.image import mobilenet\n"
        "from analytics_zoo_tpu_torch.deploy import imagenet_preprocess\n"
        "net = mobilenet(3, (32, 32, 3), alpha=0.25)\n"
        "im = InferenceModel.from_keras_net(net, net.params(), net.state(),"
        " device='cpu', preprocess=imagenet_preprocess())\n"
        "out = im.predict(np.zeros((2, 32, 32, 3), np.uint8))\n"
        "assert out.shape == (2, 3) and out.dtype == np.float32\n"
        "from analytics_zoo_tpu_torch.models import (SessionRecommender,"
        " WideAndDeep)\n"
        "wnd = WideAndDeep(2, wide_base_dims=(5, 5), embed_in_dims=(9,),"
        " embed_out_dims=(4,), continuous_cols=2, hidden_layers=(8,),"
        " device='cpu')\n"
        "wx = [np.ones((8, 2), np.int32), np.ones((8, 1), np.int32),"
        " np.ones((8, 2), np.float32)]\n"
        "wnd.compile('adam', 'sparse_categorical_crossentropy')\n"
        "wnd.fit(wx, np.ones(8, np.int32), batch_size=8, epochs=1,"
        " verbose=False)\n"
        "assert wnd.inference_model(weight_dtype='int8').predict(wx)"
        ".shape == (8, 2)\n"
        "sr = SessionRecommender(30, item_embed=8, rnn_hidden_layers=(6,),"
        " session_length=3, device='cpu')\n"
        "sx = np.ones((8, 3), np.int32)\n"
        "sr.compile('adam', 'sparse_categorical_crossentropy')\n"
        "sr.fit(sx, np.ones(8, np.int32), batch_size=8, epochs=1,"
        " verbose=False)\n"
        "assert len(sr.recommend_for_session(sx[:2], max_items=3)[1]) == 3\n"
        "import analytics_zoo_tpu_torch.loadgen.__main__\n"
        "import analytics_zoo_tpu_torch.loadgen.client_main\n"
        "from analytics_zoo_tpu_torch.loadgen import (adversarial, harness,"
        " server_main, slo)\n"
        "from analytics_zoo_tpu_torch.data import zipf\n"
        "sm = server_main.build_model('cpu')\n"
        "assert sm.predict(np.ones((3, 12), np.float32)).shape == (3, 4)\n"
        "import torch\n"
        "fm = InferenceModel.from_function(lambda a: a * 2, device='cpu')\n"
        "assert fm.predict(np.ones((2, 3), np.float32)).shape == (2, 3)\n"
        "tm = InferenceModel.load_torch(torch.nn.Linear(3, 2), device='cpu')\n"
        "assert tm.predict(np.ones((2, 3), np.float32)).shape == (2, 2)\n"
        "from analytics_zoo_tpu_torch.deploy import RedisQueue\n"
        "import tempfile\n"
        "from analytics_zoo_tpu_torch.core import profiling, summary\n"
        "from analytics_zoo_tpu_torch.data import FeatureSet, streaming\n"
        "from analytics_zoo_tpu_torch.train import LocalEstimator\n"
        "from analytics_zoo_tpu_torch.observe import span,"
        " publish_to_summary\n"
        "d = tempfile.mkdtemp()\n"
        "u8 = np.ones((64, 1), np.int32)\n"
        "np.save(d + '/u.npy', u8); np.save(d + '/y.npy', np.ones(64,"
        " np.int32))\n"
        "fs = FeatureSet.from_npy_slices([(d + '/u.npy', d + '/u.npy',"
        " d + '/y.npy')]).cache('STREAM')\n"
        "ncf.estimator.ctx.config.data_device_budget_bytes = 400\n"
        "ncf.set_tensorboard(d)\n"
        "ncf.compile('adam', 'sparse_categorical_crossentropy',"
        " metrics=['auc'])\n"
        "ncf.set_tensorboard(d)\n"
        "ncf.fit(fs, batch_size=8, epochs=1, verbose=False)\n"
        "assert ncf.estimator.last_data_path == 'stream'\n"
        "assert summary.read_scalars(d + '/zoo', 'loss')\n"
        "assert 'auc' in ncf.evaluate([u8, u8], np.ones(64, np.int32),"
        " batch_size=16)\n"
        "from analytics_zoo_tpu_torch.data import image as dimg,"
        " read_pascal_voc, read_coco\n"
        "from analytics_zoo_tpu_torch.nn.layers import (Deconvolution2D,"
        " LRN2D, ResizeBilinear)\n"
        "from analytics_zoo_tpu_torch.models.objectdetection import ("
        "ObjectDetector, PascalVocEvaluator, draw_detections)\n"
        "cfg = dict(image_size=64, feature_sizes=(8, 4, 2, 1, 1, 1),"
        " min_sizes=(6, 13, 26, 38, 51, 58), max_sizes=(13, 26, 38, 51, 58,"
        " 70), aspect_ratios=((2,), (2, 3), (2, 3), (2, 3), (2,), (2,)))\n"
        "od = ObjectDetector(3, config=cfg, width_mult=0.125, device='cpu')\n"
        "od.compile('sgd', od.loss())\n"
        "oi = np.zeros((2, 64, 64, 3), np.float32)\n"
        "od.fit_detection(oi, np.tile(np.float32([[[0.1, 0.1, 0.6, 0.6]]]),"
        " (2, 1, 1)), np.ones((2, 1), np.int32), batch_size=2, epochs=1,"
        " verbose=False)\n"
        "assert len(od.detect(oi, score_threshold=0.0)) == 2\n"
        "xi, _ = dimg.ImageSet.from_arrays([np.zeros((40, 50, 3),"
        " np.uint8)]).transform(dimg.RoiResize(30, 30) | dimg.ImageHue())"
        ".to_arrays()\n"
        "assert xi.shape == (1, 30, 30, 3)\n"
        "cs = ClusterServing(InferenceModel(lambda xs: [xs[0].reshape("
        "len(xs[0]), -1)[:, :2].astype(np.float32)]), q).start()\n"
        "r = OutputQueue(q).query(InputQueue(q).enqueue_image('i0',"
        " image=np.ones((4, 5, 3), np.uint8)), timeout=60)\n"
        "cs.stop()\n"
        "assert np.asarray(r).shape == (2,), r\n"
        "import analytics_zoo_tpu_torch.nn as tnn, analytics_zoo_tpu_torch"
        ".nn.keras2 as k2, analytics_zoo_tpu_torch.ops as ops\n"
        "v = tnn.Sequential([tnn.SparseEmbedding(9, 4, input_shape=(3,)),"
        " k2.Dense(4), tnn.PReLU(), tnn.Narrow(1, 1, 2), tnn.CAdd((2,))])\n"
        "v.build(torch.Generator().manual_seed(0), (2, 3))\n"
        "assert v(torch.ones(2, 3, dtype=torch.int32)).shape == (2, 2)\n"
        "assert ops.embedding_bag(torch.ones(5, 2), torch.ones(2, 3,"
        " dtype=torch.int32)).shape == (2, 2)\n"
        "assert ops.int8_dot is not None\n"
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


def test_port_sources_name_no_jax():
    files = sorted((ROOT / "analytics_zoo_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "flash_bwd_shapes.py"]
    assert len(files) > 10
    layers = ROOT / "analytics_zoo_tpu_torch" / "nn" / "layers"
    for new in (layers / "advanced_activations.py",
                layers / "torch_style.py", layers / "merge.py",
                layers / "embedding.py",
                ROOT / "analytics_zoo_tpu_torch" / "nn" / "keras2.py",
                ROOT / "analytics_zoo_tpu_torch" / "ops" / "__init__.py"):
        assert new in files, new
    for f in files:
        text = f.read_text()
        for bad in ("import jax", "from jax", "analytics_zoo_tpu.",
                    "import ml_dtypes"):
            assert bad not in text.replace("analytics_zoo_tpu_torch", ""), (
                f, bad)
