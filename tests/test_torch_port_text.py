"""The port's text models and pipeline against the JAX package.

TextClassifier (cnn, lstm, gru encoders) and KNRM are built in both
packages at small widths (vocabulary 60, sequences of 12 or less,
hidden 16), given the same weights drawn by ``np.random.RandomState`` in
the JAX package's tree layout (``load_jax_params``), and fed the same ids:
the forward, one Adam step through ``fit`` against the JAX package's
step, serving in float32 / int8 / int4 against the JAX
``InferenceModel``, KNRM's ``rank_hinge`` and its ``evaluate`` on an odd
row count against the JAX ``Estimator``'s masked rule, and
``save_model`` / ``load_model`` by name.  ``TextSet`` and its stages,
the corpus readers, ``load_glove_embeddings`` on a tiny synthetic file,
``ndcg``, ``mean_average_precision`` and ``Ranker`` are held to the JAX
functions on the same inputs.  Everything runs on the CPU.

Tolerances, with their reasons:

- forwards, served answers and losses: atol 1e-5 (f32 sums in other
  orders over logits of magnitude up to about 20 from weights of scale
  0.3; int8/int4 answers come from the same dequantized weights);
- one Adam step (lr 1e-3): every leaf within atol 1e-5 (Adam's first
  update is ``lr · g / (|g| + eps)``: an element whose gradient is near 0
  moves by a share of lr that rounding can change);
- ``evaluate``: rtol 1e-5 on the mean of a few pair hinges.
"""

import json

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.data import datasets as jds
from analytics_zoo_tpu.data import text as jtext
from analytics_zoo_tpu.deploy.inference import InferenceModel as JaxIM
from analytics_zoo_tpu.models import text as jmodels
from analytics_zoo_tpu.nn import objectives as jobj
from analytics_zoo_tpu.nn import reset_name_scope as jax_reset_names
from analytics_zoo_tpu.train import optimizers as jopt

from analytics_zoo_tpu_torch.convert import export_params, load_jax_params
from analytics_zoo_tpu_torch.core import context
from analytics_zoo_tpu_torch.data import datasets as tds
from analytics_zoo_tpu_torch.data import text as ttext
from analytics_zoo_tpu_torch.models import KNRM, Ranker, TextClassifier
from analytics_zoo_tpu_torch.models import text as tmodels
from analytics_zoo_tpu_torch.models.common import ZooModel
from analytics_zoo_tpu_torch.nn import objectives as tobj
from analytics_zoo_tpu_torch.nn import reset_name_scope
from analytics_zoo_tpu_torch.train import optimizers as topt

ATOL = 1e-5
TC = dict(class_num=5, token_length=8, sequence_length=12,
          encoder_output_dim=16, max_words_num=59)
KN = dict(text1_length=5, text2_length=9, max_words_num=59, embed_size=8,
          kernel_num=7)
LOSS = "sparse_categorical_crossentropy_with_logits"


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


def _pair(kind, seed=0, **kw):
    """(JAX model, port model, numpy params) of one configuration."""
    jax_reset_names()
    reset_name_scope()
    if kind == "tc":
        jm, tm = (jmodels.TextClassifier(**kw),
                  TextClassifier(device="cpu", **kw))
    else:
        jm, tm = jmodels.KNRM(**kw), KNRM(device="cpu", **kw)
    params = _numpy_params(jm.model, seed)
    load_jax_params(tm.model, params)
    return jm, tm, params


def _ids(n, length, seed, front_pad=True):
    """Ids in [1, 59], front-padded with 0 to ``length`` as
    ``TextSet.shape_sequence`` pads."""
    rs = np.random.RandomState(seed)
    x = rs.randint(1, 60, (n, length)).astype(np.int32)
    if front_pad:
        for r in range(n):
            x[r, :rs.randint(0, length // 2)] = 0
    return x


def _forward(tm, xs):
    tm.model.eval()
    return tm.model(*[torch.from_numpy(x) for x in xs]).detach().numpy()


@pytest.mark.parametrize("encoder", ["cnn", "lstm", "gru"])
def test_text_classifier_forward_matches_jax(encoder):
    jm, tm, params = _pair("tc", encoder=encoder, **TC)
    assert set(tm.model.params()) == set(params)
    x = _ids(13, TC["sequence_length"], seed=1)
    want = np.asarray(JaxIM.from_keras_net(jm.model, params, {}).predict(x))
    got = _forward(tm, [x])
    assert got.shape == (13, TC["class_num"])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("encoder", ["cnn", "lstm", "gru"])
def test_text_classifier_adam_step_matches_jax(encoder):
    """One Adam step from the same weights, dropout off on both sides:
    the port's through ``fit``, the JAX package's as its step computes it
    (its loss over the training forward, ``jax.grad``, its ``Adam``)."""
    import optax

    jm, tm, params = _pair("tc", seed=3, encoder=encoder, **TC)
    jm.model.layers[-3].rate = 0.0
    tm.model.subtree("tc_drop").rate = 0.0
    x = _ids(16, TC["sequence_length"], seed=4)
    y = np.random.RandomState(5).randint(0, 5, 16).astype(np.int32)
    loss_fn = jobj.get(LOSS)
    tx = jopt.Adam(lr=1e-3)

    @jax.jit
    def step(p):
        def loss(q):
            return loss_fn(y, jm.model.call(q, {}, x, training=True,
                                            rng=jax.random.PRNGKey(0))[0])

        updates, _ = tx.update(jax.grad(loss)(p), tx.init(p), p)
        return optax.apply_updates(p, updates)

    want = jax.tree_util.tree_map(np.asarray, step(params))
    tm.compile(optimizer=topt.Adam(lr=1e-3), loss=LOSS)
    tm.fit(x, y, batch_size=16, nb_epoch=1, verbose=False)
    got = export_params(tm.model)
    for layer, leaves in want.items():
        for leaf, w in leaves.items():
            np.testing.assert_allclose(got[layer][leaf], w, rtol=0,
                                       atol=ATOL, err_msg=f"{layer}.{leaf}")
            assert np.any(got[layer][leaf] != params[layer][leaf])


@pytest.mark.parametrize("weight_dtype", ["float32", "int8", "int4"])
@pytest.mark.parametrize("encoder", ["cnn", "lstm"])
def test_text_classifier_serving_matches_jax(encoder, weight_dtype):
    # every leaf named below at or past quantize_pytree's 1024-element
    # floor: the (200, 16) table, the (5, 16, 16) conv kernel, the (16,
    # 64) recurrent matrix, the (128, 8) head
    kw = dict(TC, max_words_num=199, token_length=16, class_num=8)
    jm, tm, params = _pair("tc", encoder=encoder, **kw)
    x = _ids(11, TC["sequence_length"], seed=6)
    jim = JaxIM.from_keras_net(jm.model, params, {},
                               weight_dtype=weight_dtype)
    tim = tm.inference_model(weight_dtype=weight_dtype)
    want = np.asarray(jim.predict(x))
    got = tim.predict(x)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if weight_dtype == "float32":
        return
    quantized = {(layer, leaf): sorted(v)
                 for layer, sub in tim.params().items()
                 for leaf, v in sub.items() if isinstance(v, dict)}
    assert quantized == {(layer, leaf): sorted(v)
                         for layer, sub in jim._qparams.items()
                         for leaf, v in sub.items() if isinstance(v, dict)}
    enc_leaf = (("tc_conv", "kernel") if encoder == "cnn"
                else ("tc_lstm", "recurrent"))
    assert {("tc_embed", "table"), ("tc_fc", "kernel"),
            ("tc_out", "kernel"), enc_leaf} <= set(quantized)


def test_knrm_forward_and_rank_hinge_match_jax():
    jm, tm, params = _pair("knrm", **KN)
    assert set(tm.model.params()) == set(params) | {"kernel_pooling"}
    q = _ids(10, KN["text1_length"], seed=7, front_pad=False)
    d = _ids(10, KN["text2_length"], seed=8)
    d[0, :KN["text1_length"]] = q[0]         # exact matches
    want = np.asarray(JaxIM.from_keras_net(jm.model, params, {})
                      .predict([q, d]))
    got = _forward(tm, [q, d])
    assert got.shape == (10, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    y = np.zeros((10, 1), np.float32)
    np.testing.assert_allclose(
        float(tobj.rank_hinge(torch.from_numpy(y), torch.from_numpy(got))),
        float(jobj.rank_hinge(y, want)), rtol=0, atol=ATOL)
    mask = np.array([1, 1, 1, 0, 1, 1, 0, 0, 1, 1], np.float32)
    np.testing.assert_allclose(
        float(tobj.rank_hinge(torch.from_numpy(y), torch.from_numpy(got),
                              mask=torch.from_numpy(mask))),
        float(jobj.rank_hinge(y, want, mask=mask)), rtol=0, atol=ATOL)
    assert float(tobj.rank_hinge.mask_count(torch.from_numpy(mask))) == 3.0


def test_knrm_evaluate_on_odd_rows_matches_jax_masked_rule():
    """``evaluate`` with ``rank_hinge`` on batches of an odd row count: a
    pair counts only when both its rows are in the batch, weighted by
    pairs, as the JAX ``Estimator`` counts it over its padded batch.  A
    lone batch of 3 rows holds one pair, of 5 two; a last batch of 1 row
    holds none; one row alone holds no pair on either side (NaN)."""
    jm, tm, params = _pair("knrm", seed=9, **KN)
    q = _ids(13, KN["text1_length"], seed=10, front_pad=False)
    d = _ids(13, KN["text2_length"], seed=11)
    y = np.zeros((13, 1), np.float32)
    jm.compile(optimizer="adam", loss="rank_hinge")
    jm.estimator._ensure_built([q, d])
    jm.estimator.set_initial_weights(params)
    tm.compile(optimizer="adam", loss="rank_hinge")
    for n, batch in ((3, 32), (5, 32), (11, 8), (13, 8), (9, 8), (1, 8)):
        want = jm.evaluate([q[:n], d[:n]], y[:n], batch_size=batch)["loss"]
        got = tm.evaluate([q[:n], d[:n]], y[:n], batch_size=batch)["loss"]
        if n == 1:
            assert np.isnan(want) and np.isnan(got)
            continue
        assert np.isfinite(got), (n, batch, got)
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=f"n={n}")
    # the lone pair of a 3-row batch, by hand
    s = _forward(tm, [q[:3], d[:3]])[:, 0]
    np.testing.assert_allclose(
        tm.evaluate([q[:3], d[:3]], y[:3], batch_size=32)["loss"],
        max(1.0 - s[0] + s[1], 0.0), rtol=1e-5)


@pytest.mark.parametrize("kind", ["tc", "knrm"])
def test_save_model_and_load_model_by_name(kind, tmp_path):
    """A JAX ``save_model`` directory loads into the port by class name
    and predicts as the JAX model; the port's own directory loads back
    into the port (KNRM's ``Lambda`` holds a closure, so the model goes
    by name and config, never by pickle)."""
    kw = dict(TC, encoder="gru") if kind == "tc" else KN
    jm, tm, params = _pair(kind, seed=12, **kw)
    xs = ([_ids(6, TC["sequence_length"], seed=13)] if kind == "tc" else
          [_ids(6, KN["text1_length"], seed=13, front_pad=False),
           _ids(6, KN["text2_length"], seed=14)])
    jm.compile(optimizer="adam", loss=LOSS if kind == "tc" else "rank_hinge")
    jm.estimator._ensure_built(xs)
    jm.estimator.set_initial_weights(params)
    want = np.asarray(JaxIM.from_keras_net(jm.model, params, {}).predict(
        xs if len(xs) > 1 else xs[0]))
    jm.save_model(str(tmp_path / "jax"))
    reset_name_scope()
    got = ZooModel.load_model(str(tmp_path / "jax"), device="cpu")
    assert type(got) is type(tm) and got.config() == json.load(
        open(tmp_path / "jax" / "config.json"))["config"]
    np.testing.assert_allclose(_forward(got, xs), want, rtol=0, atol=ATOL)
    tm.save_model(str(tmp_path / "port"))
    reset_name_scope()
    back = ZooModel.load_model(str(tmp_path / "port"), device="cpu")
    np.testing.assert_array_equal(_forward(back, xs), _forward(tm, xs))


# ---------------------------------------------------------------------------
# the text pipeline

TEXTS = ["The cat sat on the mat.", "A dog's bark; the CAT ran!",
         "mat mat mat, dog", "", "Unseen words only here"]


def _stages(mod, **word2idx):
    ts = mod.TextSet.from_texts(TEXTS, labels=[0, 1, 2, 1, 0])
    return ts.tokenize().normalize().word2idx(**word2idx)


@pytest.mark.parametrize("word2idx", [{}, {"remove_topN": 1,
                                           "max_words_num": 4},
                                      {"min_freq": 2}])
@pytest.mark.parametrize("trunc_mode", ["pre", "post"])
def test_textset_pipeline_matches_jax(word2idx, trunc_mode):
    want = _stages(jtext, **word2idx)
    got = _stages(ttext, **word2idx)
    assert got.word_index == want.word_index
    assert ([f["tokens"] for f in got.features]
            == [f["tokens"] for f in want.features])
    for ws, gs in ((want, got),
                   (want.shape_sequence(4, trunc_mode).generate_sample(),
                    got.shape_sequence(4, trunc_mode).generate_sample())):
        assert ([f["indexed"] for f in gs.features]
                == [f["indexed"] for f in ws.features])
    wx, wy = want.shape_sequence(4, trunc_mode).generate_sample().to_arrays()
    gx, gy = got.shape_sequence(4, trunc_mode).generate_sample().to_arrays()
    np.testing.assert_array_equal(gx, wx)
    np.testing.assert_array_equal(gy, wy)
    assert gx.dtype == np.int32 and gx.shape == (len(TEXTS), 4)
    reuse = (ttext.TextSet.from_texts(["cat zebra mat"]).tokenize()
             .normalize().word2idx(existing_map=got.word_index))
    assert reuse.features[0]["indexed"][1] == 0      # unknown -> 0


def test_text_readers_word_index_and_glove_match_jax(tmp_path):
    for c, docs in (("sci", ["atoms and stars", "stars"]),
                    ("art", ["paint the cat", "cat art"])):
        (tmp_path / "corpus" / c).mkdir(parents=True)
        for i, doc in enumerate(docs):
            (tmp_path / "corpus" / c / f"{i}.txt").write_text(doc)
    folder = str(tmp_path / "corpus")
    w, g = jtext.TextSet.read(folder), ttext.TextSet.read(folder)
    assert g.label_map == w.label_map and list(g.features) == list(
        w.features)
    wt, wl, wm = jds.read_text_folder(folder)
    gt, gl, gm = tds.read_text_folder(folder)
    assert gt == wt and gm == wm
    np.testing.assert_array_equal(gl, wl)
    texts, labels = tds.generate_text_classification(3, 7, seed=2)
    assert (texts, labels.tolist()) == (
        jds.generate_text_classification(3, 7, seed=2)[0],
        jds.generate_text_classification(3, 7, seed=2)[1].tolist())

    csv = tmp_path / "t.csv"
    csv.write_text("uid,text,label\n1,hello world,1\n2,bye now,0\n")
    assert (list(ttext.TextSet.read_csv(str(csv)).features)
            == list(jtext.TextSet.read_csv(str(csv)).features))

    ts = _stages(ttext)
    ts.save_word_index(str(tmp_path / "wi.json"))
    assert (jtext.TextSet.load_word_index(str(tmp_path / "wi.json"))
            == ttext.TextSet.load_word_index(str(tmp_path / "wi.json"))
            == ts.word_index)

    rs = np.random.RandomState(3)
    glove = tmp_path / "glove.txt"
    glove.write_text("".join(
        f"{word} " + " ".join(f"{v:.5f}" for v in rs.randn(6)) + "\n"
        for word in ("the", "cat", "zebra", "mat", "dog")))
    want = jtext.load_glove_embeddings(str(glove), ts.word_index)
    got = ttext.load_glove_embeddings(str(glove), ts.word_index, dim=6)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (max(ts.word_index.values()) + 1, 6)
    assert not got[0].any()
    with pytest.raises(ValueError, match="expected 5"):
        ttext.load_glove_embeddings(str(glove), ts.word_index, dim=5)
    with pytest.raises(ValueError, match="no vocabulary words"):
        ttext.load_glove_embeddings(str(glove), {"nowhere": 1})
    # a pretrained table goes into the classifier's embedding as given
    reset_name_scope()
    tc = TextClassifier(2, token_length=6, sequence_length=4,
                        max_words_num=got.shape[0] - 1,
                        embedding_weights=got, device="cpu")
    np.testing.assert_array_equal(
        tc.model.params()["tc_embed"]["table"].numpy(), got)


def test_ranking_metrics_and_ranker_match_jax():
    rs = np.random.RandomState(4)
    for _ in range(20):
        n = rs.randint(1, 9)
        labels = rs.randint(0, 3, n)
        scores = rs.randn(n).astype(np.float32)
        for k in (1, 3, 10):
            assert tmodels.ndcg(labels, scores, k) == jmodels.ndcg(
                labels, scores, k)
        assert (tmodels.mean_average_precision(labels, scores)
                == jmodels.mean_average_precision(labels, scores))
    qids = rs.randint(0, 5, 40)
    labels = rs.randint(0, 2, 40)
    scores = rs.randn(40)
    assert (Ranker.evaluate_ndcg(qids, labels, scores, k=3)
            == jmodels.Ranker.evaluate_ndcg(qids, labels, scores, k=3))
    assert (Ranker.evaluate_map(qids, labels, scores)
            == jmodels.Ranker.evaluate_map(qids, labels, scores))
    assert tmodels.ndcg([2, 1, 0], [3.0, 2.0, 1.0]) == 1.0
    assert tmodels.mean_average_precision([0, 0], [1.0, 2.0]) == 0.0


@pytest.mark.parametrize("name", ["reshape", "permute", "repeat", "masking",
                                  "lambda", "input", "maxout", "sampler"])
def test_core_layers_match_jax(name):
    """The rest of the core layers against the JAX layers (their eval
    forward), and each one's output shape against its forward's."""
    from analytics_zoo_tpu.nn.layers import core as jcore

    from analytics_zoo_tpu_torch.nn.layers import core as tcore

    rs = np.random.RandomState(len(name))
    x = rs.randn(4, 3, 6).astype(np.float32)
    x[1, 2] = 0.0                                # a masked timestep
    make, xs = {
        "reshape": (lambda m: m.Reshape((2, -1)), [x]),
        "permute": (lambda m: m.Permute((2, 1)), [x]),
        "repeat": (lambda m: m.RepeatVector(5), [x[:, 0]]),
        "masking": (lambda m: m.Masking(0.0), [x]),
        "lambda": (lambda m: m.Lambda(lambda a, b: a * 2.0 + b),
                   [x, x[::-1].copy()]),
        "input": (lambda m: m.InputLayer(), [x]),
        "maxout": (lambda m: m.MaxoutDense(5, nb_feature=3), [x]),
        "sampler": (lambda m: m.GaussianSampler(), [x, x * 0.5]),
    }[name]
    jl, tl = make(jcore), make(tcore)
    params = jax.tree_util.tree_map(
        np.array, jl.build_params(jax.random.PRNGKey(0), x.shape))
    for leaf, v in params.items():
        tl.set_leaf(leaf, v)
    want = np.asarray(jl.call(params, {}, *xs)[0])
    tl.eval()
    got = tl(*[torch.from_numpy(a) for a in xs]).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert tl.output_shape(*[a.shape for a in xs]) == got.shape
    if name == "sampler":
        # training draws mean + exp(log_var / 2) * eps from the generator
        tl.train()
        tl.generator = torch.Generator().manual_seed(0)
        drawn = tl(*[torch.from_numpy(a) for a in xs]).numpy()
        assert drawn.shape == got.shape and not np.allclose(drawn, got)
