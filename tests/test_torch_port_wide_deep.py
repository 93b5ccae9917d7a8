"""The port's WideAndDeep and SessionRecommender against the JAX package.

Both models are built in both packages at small widths, given the same
weights drawn by ``np.random.RandomState`` in the JAX package's tree
layout, and fed the same inputs: the forward of WideAndDeep in all three
``model_type``s with and without indicator columns, and of
SessionRecommender with and without the history tower; one Adam step
through ``fit`` against the JAX package's step; serving in float32, int8
and int4 through ``InferenceModel`` against the JAX one (the quantized
trees equal leaf for leaf, the GRUs' ``recurrent`` matrices and the
embedding tables included); ``recommend_for_session``; and
``save_model`` / ``load_model`` across the two packages.  The JAX models
place every table ``"replicated"`` (``"auto"`` may route one to the
sharded layer on the 8-device CPU mesh).  Everything runs on the CPU.

Tolerances, with their reasons:

- forwards and served answers: atol 2e-6 on probabilities (f32 sums in
  other orders, over logits of magnitude up to about 10 from weights of
  scale 0.5; int8/int4 answers come from the same dequantized f32
  weights on both sides);
- one Adam step: every leaf within atol 1e-5 of the JAX step (f32
  gradient sums in other orders; Adam's first update is ``lr · g / (|g|
  + eps)``, so an element whose gradient is near 0 moves by a share of
  ``lr`` that rounding can change, by at most 1e-5 here);
- ``recommend_for_session``: the same items in the same order, their
  probabilities within 2e-6.
"""

import json

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.deploy.inference import InferenceModel as JaxIM
from analytics_zoo_tpu.models import SessionRecommender as JaxSession
from analytics_zoo_tpu.models import WideAndDeep as JaxWnd
from analytics_zoo_tpu.nn import reset_name_scope as jax_reset_names
from analytics_zoo_tpu.train import optimizers as jopt

from analytics_zoo_tpu_torch.convert import export_params, load_jax_params
from analytics_zoo_tpu_torch.core import context
from analytics_zoo_tpu_torch.data import CacheLevel, FeatureSet
from analytics_zoo_tpu_torch.deploy import DynamicBatcher
from analytics_zoo_tpu_torch.models import SessionRecommender, WideAndDeep
from analytics_zoo_tpu_torch.models.common import ZooModel
from analytics_zoo_tpu_torch.nn import reset_name_scope
from analytics_zoo_tpu_torch.train import optimizers as topt

ATOL = 2e-6
STEP_ATOL = 1e-5

# census-shaped WideAndDeep, narrow: the wide table (1,220 x 2) and the
# first deep kernel reach quantize_pytree's 1024-element floor; odd
# embedding rows (101) keep int8 under int4
WND = dict(class_num=2, wide_base_dims=(600, 600), wide_cross_dims=(20,),
           embed_in_dims=(100, 40), embed_out_dims=(16, 8),
           continuous_cols=3, hidden_layers=(32, 16))
INDICATORS = (3, 2)
# a narrow SessionRecommender whose two tables, head and first GRU's
# recurrent matrix (20 x 60) reach the floor
SESSION = dict(item_count=1023, item_embed=16, rnn_hidden_layers=(20, 12),
               session_length=6, mlp_hidden_layers=(12, 8),
               history_length=4)


@pytest.fixture(autouse=True)
def fresh_context():
    context.set_zoo_context(None)
    yield
    context.set_zoo_context(None)


def _numpy_params(jax_net, seed, scale=0.5):
    shapes = jax.eval_shape(lambda k: jax_net.build(k)[0],
                            jax.random.PRNGKey(0))
    rs = np.random.RandomState(seed)
    return {layer: {leaf: (rs.randn(*v.shape) * scale).astype(np.float32)
                    for leaf, v in sub.items()}
            for layer, sub in shapes.items()}


def _wnd_kw(model_type, indicators):
    kw = dict(WND, model_type=model_type)
    if indicators:
        kw["indicator_dims"] = INDICATORS
    return kw


def _pair(kind, seed=0, **kw):
    """(JAX model, port model, numpy params) of one configuration."""
    jax_reset_names()
    reset_name_scope()
    if kind == "wnd":
        jm = JaxWnd(table_placement="replicated", **kw)
        tm = WideAndDeep(device="cpu", **kw)
    else:
        jm = JaxSession(**kw)
        tm = SessionRecommender(device="cpu", **kw)
    params = _numpy_params(jm.model, seed)
    load_jax_params(tm.model, params)
    return jm, tm, params


def _wnd_inputs(kw, n, seed):
    """Inputs in the model's order: wide ids offset into the shared
    table, indicator 0/1 columns, embed ids in [0, in_dim], continuous
    floats."""
    rs = np.random.RandomState(seed)
    xs = []
    if kw["model_type"] != "deep":
        dims = kw["wide_base_dims"] + kw["wide_cross_dims"]
        offs = np.concatenate([[0], np.cumsum(dims)[:-1]])
        xs.append(np.stack([rs.randint(0, d, n) + o
                            for d, o in zip(dims, offs)], 1)
                  .astype(np.int32))
    if kw["model_type"] != "wide":
        if kw.get("indicator_dims"):
            xs.append((rs.rand(n, sum(kw["indicator_dims"])) < 0.5)
                      .astype(np.float32))
        xs.append(np.stack([rs.randint(0, d + 1, n)
                            for d in kw["embed_in_dims"]], 1)
                  .astype(np.int32))
        xs.append(rs.randn(n, kw["continuous_cols"]).astype(np.float32))
    return xs


def _session_inputs(kw, n, seed, history):
    rs = np.random.RandomState(seed)
    xs = [rs.randint(1, kw["item_count"] + 1, (n, kw["session_length"]))
          .astype(np.int32)]
    if history:
        xs.append(rs.randint(1, kw["item_count"] + 1,
                             (n, kw["history_length"])).astype(np.int32))
    return xs


def _forward(tm, xs):
    return tm.model(*[torch.from_numpy(x) for x in xs]).detach().numpy()


@pytest.mark.parametrize("model_type,indicators", [
    ("wide", False), ("deep", False), ("deep", True),
    ("wide_n_deep", False), ("wide_n_deep", True)])
def test_wide_and_deep_forward_matches_jax(model_type, indicators):
    kw = _wnd_kw(model_type, indicators)
    jm, tm, params = _pair("wnd", **kw)
    assert set(tm.model.params()) == set(params)
    xs = _wnd_inputs(kw, 37, seed=1)
    want = np.asarray(JaxIM.from_keras_net(jm.model, params, {})
                      .predict(xs))
    got = _forward(tm, xs)
    assert got.shape == (37, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if model_type != "deep":
        # the wide table starts at zero, as the JAX layer's init="zero"
        reset_name_scope()
        fresh = WideAndDeep(device="cpu", **kw)
        assert not fresh.model.params()["wide_linear"]["table"].any()


@pytest.mark.parametrize("history", [False, True])
def test_session_recommender_forward_matches_jax(history):
    kw = dict(SESSION, include_history=history)
    jm, tm, params = _pair("session", **kw)
    assert set(tm.model.params()) == set(params)
    xs = _session_inputs(kw, 21, seed=2, history=history)
    want = np.asarray(JaxIM.from_keras_net(jm.model, params, {})
                      .predict(xs))
    got = _forward(tm, xs)
    assert got.shape == (21, SESSION["item_count"] + 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _one_step(kind, kw, xs, y):
    """One Adam step (lr 1e-3) from the same weights: the port's through
    ``fit``, the JAX package's as its step computes it (its loss over its
    model's training forward, ``jax.grad``, its ``Adam``), in one
    compiled program rather than through its ``Estimator``, whose
    8-device step takes seconds to compile.  Returns (JAX params, port
    params, initial params) as numpy trees."""
    import optax

    from analytics_zoo_tpu.nn import objectives as jobj

    jm, tm, params = _pair(kind, seed=3, **kw)
    loss_fn = jobj.get("sparse_categorical_crossentropy")
    tx = jopt.Adam(lr=1e-3)

    @jax.jit
    def step(p, xs, y):
        def loss(q):
            return loss_fn(y, jm.model.call(q, {}, *xs, training=True)[0])

        updates, _ = tx.update(jax.grad(loss)(p), tx.init(p), p)
        return optax.apply_updates(p, updates)

    want = jax.tree_util.tree_map(np.asarray, step(params, xs, y))
    tm.compile(optimizer=topt.Adam(lr=1e-3),
               loss="sparse_categorical_crossentropy")
    tm.fit(xs, y, batch_size=len(y), nb_epoch=1, verbose=False)
    return want, export_params(tm.model), params


@pytest.mark.parametrize("kind", ["wnd", "session"])
def test_one_adam_step_matches_jax(kind):
    if kind == "wnd":
        kw = _wnd_kw("wide_n_deep", True)
        xs = _wnd_inputs(kw, 32, seed=4)
        y = np.random.RandomState(5).randint(0, 2, 32).astype(np.int32)
    else:
        kw = dict(SESSION, include_history=True)
        xs = _session_inputs(kw, 32, seed=4, history=True)
        y = np.random.RandomState(5).randint(
            0, SESSION["item_count"] + 1, 32).astype(np.int32)
    want, got, init = _one_step(kind, kw, xs, y)
    assert set(got) == set(want)
    moved = 0
    for layer, leaves in want.items():
        for leaf, w in leaves.items():
            np.testing.assert_allclose(got[layer][leaf], w, rtol=0,
                                       atol=STEP_ATOL,
                                       err_msg=f"{layer}.{leaf}")
            moved += int(np.any(got[layer][leaf] != init[layer][leaf]))
    # every leaf took the step (each table has ids in the batch)
    assert moved == sum(len(v) for v in want.values())


@pytest.mark.parametrize("weight_dtype", ["float32", "int8", "int4"])
@pytest.mark.parametrize("kind", ["wnd", "session"])
def test_serving_matches_jax(kind, weight_dtype):
    if kind == "wnd":
        kw = _wnd_kw("wide_n_deep", True)
        xs = _wnd_inputs(kw, 40, seed=6)
    else:
        kw = dict(SESSION, include_history=True)
        xs = _session_inputs(kw, 40, seed=6, history=True)
    jm, tm, params = _pair(kind, **kw)
    jim = JaxIM.from_keras_net(jm.model, params, {},
                               weight_dtype=weight_dtype)
    tim = tm.inference_model(weight_dtype=weight_dtype)
    want = np.asarray(jim.predict(xs))
    got = tim.predict(xs)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if weight_dtype == "float32":
        return
    quantized = {(layer, leaf): sorted(v)
                 for layer, sub in tim.params().items()
                 for leaf, v in sub.items() if isinstance(v, dict)}
    jq = jim._qparams
    assert quantized == {(layer, leaf): sorted(v)
                         for layer, sub in jq.items()
                         for leaf, v in sub.items() if isinstance(v, dict)}
    for (layer, leaf), kinds in quantized.items():
        for k in kinds:
            np.testing.assert_array_equal(
                tim.params()[layer][leaf][k].numpy(),
                np.asarray(jq[layer][leaf][k]))
    want_q = ({("wide_linear", "table"), ("deep_embed_0", "table"),
               ("deep_dense_0", "kernel")} if kind == "wnd" else
              {("session_embed", "table"), ("history_embed", "table"),
               ("session_gru_0", "recurrent"), ("session_head", "kernel")})
    assert want_q <= set(quantized)


def test_recommend_for_session_matches_jax():
    kw = dict(SESSION, include_history=False)
    jm, tm, params = _pair("session", **kw)
    jm.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    jm.estimator.set_initial_weights(params)
    (sessions,) = _session_inputs(kw, 9, seed=7, history=False)
    want = jm.recommend_for_session(sessions, max_items=5)
    got = tm.recommend_for_session(sessions, max_items=5)
    assert [[i for i, _ in row] for row in got] == \
        [[i for i, _ in row] for row in want]
    np.testing.assert_allclose([[p for _, p in row] for row in got],
                               [[p for _, p in row] for row in want],
                               atol=ATOL)
    # int8 serving behind the helper, with the history tower: the top
    # items of the JAX int8 forward
    kw = dict(SESSION, include_history=True)
    jm, tm, params = _pair("session", **kw)
    xs = _session_inputs(kw, 9, seed=8, history=True)
    probs = np.asarray(JaxIM.from_keras_net(
        jm.model, params, {}, weight_dtype="int8").predict(xs))
    tm.inference_model(weight_dtype="int8")
    got = tm.recommend_for_session(xs, max_items=5)
    assert [[i for i, _ in row] for row in got] == \
        np.argsort(-probs, axis=-1)[:, :5].tolist()


@pytest.mark.parametrize("kind", ["wnd", "session"])
def test_save_model_and_load_model_across_packages(kind, tmp_path):
    """A JAX ``save_model`` directory loads into the port (registered by
    class name) and predicts as the JAX model.  The port's directory
    holds the JAX archive layout: the same leaf keys, dtypes and shapes
    in its manifest, and a JAX model of its ``config.json`` given its
    leaves predicts the same.  (The JAX reader unpickles a JAX treedef,
    which the port, importing no jax, does not write.)"""
    from analytics_zoo_tpu.models.common import _MODEL_REGISTRY

    from analytics_zoo_tpu_torch.train.checkpoint import load_pytree

    if kind == "wnd":
        kw = _wnd_kw("wide_n_deep", True)
        xs = _wnd_inputs(kw, 16, seed=9)
    else:
        kw = dict(SESSION, include_history=True)
        xs = _session_inputs(kw, 16, seed=9, history=True)
    jm, tm, params = _pair(kind, **kw)
    jm.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    jm.estimator._ensure_built(xs)
    jm.estimator.set_initial_weights(params)
    want = np.asarray(JaxIM.from_keras_net(jm.model, params, {}).predict(xs))
    jm.save_model(str(tmp_path / "jax"))
    reset_name_scope()
    got = ZooModel.load_model(str(tmp_path / "jax"), device="cpu")
    assert type(got) is type(tm) and got.config() == json.load(
        open(tmp_path / "jax" / "config.json"))["config"]
    np.testing.assert_allclose(_forward(got, xs), want, rtol=0, atol=ATOL)

    tm.save_model(str(tmp_path / "port"))

    def manifest(d):
        with np.load(tmp_path / d / "weights.npz") as z:
            m = json.loads(z["__manifest__"].tobytes())["leaves"]
        return {k: (v["dtype"], v["shape"]) for k, v in m.items()
                if k != "__treedef__"}

    assert manifest("port") == manifest("jax")
    blob = json.load(open(tmp_path / "port" / "config.json"))
    cfg = dict(blob["config"])
    if kind == "wnd":
        cfg["table_placement"] = "replicated"
    jax_reset_names()
    back = _MODEL_REGISTRY[blob["class"]](**cfg)
    leaves = load_pytree(str(tmp_path / "port" / "weights.npz"))["params"]
    np.testing.assert_allclose(np.asarray(JaxIM.from_keras_net(
        back.model, leaves, {}).predict(xs)), want, rtol=0, atol=ATOL)


def test_three_mixed_inputs_through_the_batcher():
    """Census-shaped requests of three inputs each (wide int32, embed
    int32, continuous f32), one row per request, through
    ``DynamicBatcher`` in int4: the answers equal the direct predict's,
    and the ids reach the tables as int32."""
    kw = dict(WND, model_type="wide_n_deep")
    _, tm, _ = _pair("wnd", **kw)
    im = tm.inference_model(weight_dtype="int4")
    xs = _wnd_inputs(kw, 24, seed=10)
    want = im.predict(xs)
    batcher = DynamicBatcher(im, max_batch=8, max_latency_ms=2.0)
    try:
        got = [batcher.predict([x[r:r + 1] for x in xs]) for r in range(24)]
    finally:
        batcher.close()
    np.testing.assert_allclose(np.concatenate(got), want, rtol=0, atol=ATOL)


def test_resident_featureset_k_step_matches_host_arrays():
    """Three mixed-dtype inputs in a device-resident ``FeatureSet``
    trained by K = 4-step programs, against the host-array path one step
    at a time, both without shuffling (the same batches): the same
    weights within 1e-6; then bf16 compute keeps the ids int32 and
    trains to a finite loss."""
    kw = dict(WND, model_type="wide_n_deep")
    xs = _wnd_inputs(kw, 128, seed=11)
    y = (xs[0][:, 0] % 2).astype(np.int32)

    def run(data, k, compute_dtype=None):
        context.init_zoo_context(steps_per_execution=k)
        reset_name_scope()
        m = WideAndDeep(device="cpu", **kw)
        m.compile(optimizer=topt.Adam(lr=1e-2),
                  loss="sparse_categorical_crossentropy",
                  compute_dtype=compute_dtype)
        hist = m.fit(*data, batch_size=32, nb_epoch=2, shuffle=False,
                     verbose=False)
        return m, [h["loss"] for h in hist]

    fs = FeatureSet.from_ndarrays(xs, y).cache(CacheLevel.DEVICE)
    resident, r_loss = run((fs,), 4)
    assert resident.estimator.last_data_path == "device_resident"
    host, h_loss = run((xs, y), 1)
    assert host.estimator.last_data_path == "host_prefetch"
    np.testing.assert_allclose(r_loss, h_loss, rtol=1e-6)
    a, b = export_params(resident.model), export_params(host.model)
    for layer in a:
        for leaf in a[layer]:
            np.testing.assert_allclose(a[layer][leaf], b[layer][leaf],
                                       rtol=0, atol=1e-6)
    bf16, loss = run((fs,), 4, compute_dtype="bfloat16")
    assert np.all(np.isfinite(loss)) and loss[1] < loss[0]
