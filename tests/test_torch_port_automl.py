"""The port's ``automl`` against the JAX package's.

- The metrics, the samplers (``expand_grid``, ``sample_config``,
  ``TPESampler``) and the engine's trial order are pure Python: for seeds
  0, 3 and 42 the two packages propose identical configs and score them
  identically.
- The vmap backend runs one numpy-made trainable (a small MLP trained
  full-batch) written once with ``jax.grad`` / ``lax.scan`` and once with
  ``torch.func.grad`` / a loop: scores within rtol 1e-4 (60 f32 gradient
  steps in other summation orders).
- ``TimeSequenceFeatureTransformer`` is host code: outputs and saved JSON
  are exact.
- ``MTNetBlock`` and the encoder-decoder block from one numpy init:
  forward within rtol 1e-5 / atol 1e-6, gradients of every leaf within
  rtol 1e-4 (atol 1e-6; sums over time steps in other orders).
- ``fit_eval`` from one init (carried by name), dropout 0 and one
  full-size batch per epoch (so both packages see the same order): the
  validation metric within rtol 1e-4.
- Pipeline directories written by either package load in the other and
  predict within rtol 1e-5 / atol 1e-6.  The JAX archive reader unpickles
  a JAX treedef, which a torch process cannot write: the port's archive
  is read on the JAX side with the port's ``load_pytree`` (JSON treedef),
  the leaves and the JSON files as the port wrote them.

Everything runs on the CPU (``init_zoo_context(device="cpu")``).
"""

import json
import math
import random

import numpy as np
import pandas as pd
import pytest
import torch

from analytics_zoo_tpu.automl import search as jsearch
from analytics_zoo_tpu.automl.common import metrics as jmetrics
from analytics_zoo_tpu.automl.feature import time_sequence as jfeat
from analytics_zoo_tpu.automl.model import mtnet as jmtnet
from analytics_zoo_tpu.automl.model import time_sequence as jts
from analytics_zoo_tpu.automl.pipeline import time_sequence as jpipe
from analytics_zoo_tpu.automl.search import population as jpop
from analytics_zoo_tpu.automl.search import tpe as jtpe

from analytics_zoo_tpu_torch.automl import (MTNetSmokeRecipe,
                                            TimeSequencePredictor)
from analytics_zoo_tpu_torch.automl import search
from analytics_zoo_tpu_torch.automl.common import metrics
from analytics_zoo_tpu_torch.automl.feature import time_sequence as feat
from analytics_zoo_tpu_torch.automl.model import mtnet
from analytics_zoo_tpu_torch.automl.model import time_sequence as ts
from analytics_zoo_tpu_torch.automl.pipeline import time_sequence as pipe
from analytics_zoo_tpu_torch.automl.search import population as pop
from analytics_zoo_tpu_torch.automl.search import tpe
from analytics_zoo_tpu_torch.convert import load_jax_params
from analytics_zoo_tpu_torch.core import context

SEEDS = (0, 3, 42)
FWD_RTOL, FWD_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


@pytest.fixture(autouse=True)
def cpu_context():
    from analytics_zoo_tpu import init_zoo_context as jax_init_context

    jax_init_context()
    context.init_zoo_context(device="cpu")
    yield
    context.set_zoo_context(None)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def _close(got, want, rtol, atol, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close(got[k], want[k], rtol, atol, f"{path}.{k}")
        return
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=path)


# ---------------------------------------------------------------------------
# metrics and samplers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(metrics._METRICS))
def test_metrics_are_the_jax_metrics(name):
    rs = np.random.RandomState(0)
    y, p = rs.randn(50) + 2.0, rs.randn(50) + 2.0
    y[3] = 0.0
    assert metrics.Evaluator.evaluate(name, y, p) == \
        jmetrics.Evaluator.evaluate(name, y, p)
    assert metrics.Evaluator.get_metric_mode(name) == \
        jmetrics.Evaluator.get_metric_mode(name)
    with pytest.raises(ValueError, match="known"):
        metrics.Evaluator.evaluate("nope", y, p)
    with pytest.raises(ValueError, match="shape"):
        metrics.Evaluator.evaluate(name, y, p[:3])


def _recipes(m):
    feats = ["HOUR(datetime)", "DAY(datetime)", "IS_AWAKE(datetime)",
             "load"]
    return {
        "random": m.RandomRecipe(3, look_back=(2, 6)).search_space(feats),
        "grid_random": m.GridRandomRecipe(2).search_space(feats),
        "mtnet_grid": m.MTNetGridRandomRecipe(2).search_space(feats),
        "bayes": m.BayesRecipe(8).search_space(feats),
        "smoke": m.SmokeRecipe().search_space(feats),
    }


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("recipe", ["random", "grid_random", "mtnet_grid",
                                    "bayes", "smoke"])
def test_samplers_propose_the_jax_configs(recipe, seed):
    space, jspace = _recipes(search)[recipe], _recipes(jsearch)[recipe]
    grid, jgrid = search.expand_grid(space), jsearch.expand_grid(jspace)
    assert len(grid) == len(jgrid)
    rng, jrng = random.Random(seed), random.Random(seed)
    for g, jg in zip(grid, jgrid):
        for _ in range(5):
            got = search.sample_config(g, rng)
            want = jsearch.sample_config(jg, jrng)
            assert got == want
            assert search.finalize_config(got) == \
                jsearch.finalize_config(want)


def _score(cfg):
    """A deterministic objective over every recipe's keys."""
    c = search.finalize_config(cfg)
    return ((math.log10(c.get("lr", 1e-3)) + 2.5) ** 2
            + 0.01 * c.get("lstm_1_units", c.get("cnn_hid_size", 16))
            + (c.get("dropout", 0.3) - 0.3) ** 2
            + 0.1 * len(c.get("selected_features", []))
            + 0.05 * c.get("past_seq_len", 2))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("recipe", ["random", "mtnet_grid", "bayes"])
def test_tpe_proposals_are_the_jax_proposals(recipe, seed):
    space, jspace = _recipes(search)[recipe], _recipes(jsearch)[recipe]
    sampler = tpe.TPESampler(space, n_startup=4, seed=seed)
    jsampler = jtpe.TPESampler(jspace, n_startup=4, seed=seed)
    history = []
    for _ in range(16):
        got, want = sampler.propose(history), jsampler.propose(history)
        assert got == want
        history.append((got, _score(got)))
    assert sampler.rng.getstate() == jsampler.rng.getstate()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("alg,parallel", [("random", 1), ("random", 3),
                                          ("tpe", 1), ("tpe", 2)])
def test_engine_runs_the_jax_trial_sequence(seed, alg, parallel):
    def run(m, recipe):
        space = _recipes(m)[recipe]
        eng = m.SearchEngine(space, num_samples=6, seed=seed,
                             search_alg=alg, max_parallel=parallel,
                             n_startup=3)
        eng.run(_score)
        return eng

    for recipe in ("random", "mtnet_grid"):
        got, want = run(search, recipe), run(jsearch, recipe)
        assert [(r.config, r.metric) for r in got.results] == \
            [(r.config, r.metric) for r in want.results]
        assert got.best().config == want.best().config


def test_failed_trials_and_process_fallback():
    def flaky(cfg):
        if cfg["lr"] < 1e-3:
            raise RuntimeError("boom")
        return _score(cfg)

    space = _recipes(search)["random"]
    eng = search.SearchEngine(space, num_samples=12, seed=3,
                              max_parallel=2, backend="process")
    eng.run(flaky)                      # a closure: falls back to threads
    assert len(eng.results) == 12
    failed = [r for r in eng.results if "error" in r.extra]
    assert failed and all(r.metric == float("inf") for r in failed)
    assert eng.best().config["lr"] >= 1e-3
    with pytest.raises(RuntimeError, match="run"):
        search.SearchEngine(space).best()


def test_device_backend_pins_trials_to_the_context_device():
    seen = []

    def trainable(cfg):
        seen.append(str(torch.empty(1).device))
        return _score(cfg)

    eng = search.SearchEngine(_recipes(search)["random"], num_samples=4,
                              seed=0, max_parallel=4, backend="device")
    eng.run(trainable)
    assert [r.extra["device"] for r in eng.results] == ["cpu"] * 4
    assert seen == ["cpu"] * 4


# ---------------------------------------------------------------------------
# the vmap backend
# ---------------------------------------------------------------------------

def _mlp_data():
    rs = np.random.RandomState(11)
    x = rs.randn(128, 8).astype(np.float32)
    y = x @ rs.randn(8, 1).astype(np.float32)
    return x, y, rs.randn(8, 16).astype(np.float32), \
        rs.randn(16, 1).astype(np.float32)


def _jax_trainable():
    import jax
    import jax.numpy as jnp

    x, y, w1, w2 = (jnp.asarray(a) for a in _mlp_data())

    def trainable(cfg, **shared):
        lr, scale = cfg["lr"], cfg["scale"]

        def loss_fn(params):
            a, b = params
            return jnp.mean((jnp.tanh(x @ a) @ b - y) ** 2)

        def body(params, _):
            g = jax.grad(loss_fn)(params)
            return tuple(p - lr * gg for p, gg in zip(params, g)), 0.0

        params, _ = jax.lax.scan(body, (scale * w1, scale * w2), None,
                                 length=cfg["steps"])
        return loss_fn(params)

    return trainable


def _torch_trainable(device="cpu"):
    from torch.func import grad

    x, y, w1, w2 = (torch.from_numpy(a).to(device) for a in _mlp_data())

    def loss_fn(params):
        a, b = params
        return torch.mean((torch.tanh(x @ a) @ b - y) ** 2)

    def trainable(cfg, **shared):
        lr, scale = cfg["lr"], cfg["scale"]
        params = (scale * w1, scale * w2)
        for _ in range(cfg["steps"]):
            g = grad(loss_fn)(params)
            params = tuple(p - lr * gg for p, gg in zip(params, g))
        return loss_fn(params)

    return trainable


def _vmap_space(m):
    return {"lr": m.LogUniform(1e-3, 3e-1), "scale": m.Uniform(0.05, 0.3),
            "steps": 60}


@pytest.mark.parametrize("seed", SEEDS)
def test_vmap_scores_match_the_jax_population(seed):
    eng = search.SearchEngine(_vmap_space(search), num_samples=16,
                              backend="vmap", seed=seed)
    jeng = jsearch.SearchEngine(_vmap_space(jsearch), num_samples=16,
                                backend="vmap", seed=seed)
    got = eng.run(_torch_trainable())
    want = jeng.run(_jax_trainable())
    assert all("error" not in r.extra for r in got), got[0].extra
    assert [r.config for r in got] == [r.config for r in want]
    np.testing.assert_allclose([r.metric for r in got],
                               [r.metric for r in want], rtol=1e-4)
    # one by one, outside vmap: the same scores
    one = _torch_trainable()
    for r in got[:3]:
        np.testing.assert_allclose(float(one(r.config)), r.metric,
                                   rtol=1e-5)


def test_vmap_reuses_its_wrapper_and_bounds_the_cache(monkeypatch):
    pop._VMAP_CACHE.clear()
    fn = _torch_trainable()
    cfgs = [{"lr": 0.01 * (k + 1), "scale": 0.1, "steps": 3}
            for k in range(4)]
    a = pop.vmapped_trials(fn, cfgs)
    b = pop.vmapped_trials(fn, cfgs)
    assert a == b and len(pop._VMAP_CACHE) == 1
    monkeypatch.setattr(pop, "_VMAP_CACHE_MAX", 2)
    for steps in (1, 2, 4):
        pop.vmapped_trials(fn, [dict(c, steps=steps) for c in cfgs])
    assert len(pop._VMAP_CACHE) == 2


def test_vmap_split_and_int_leaves_match_jax():
    cfgs = [{"lr": 0.1, "k": 3, "name": "a", "flag": True},
            {"lr": 0.2, "k": 5, "name": "a", "flag": True}]
    got, want = pop.split_config(cfgs), jpop.split_config(cfgs)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    assert got[0]["k"].dtype == np.int32
    for v in (1, 2.0, np.float32(1), np.int64(2), True, "x", None):
        assert pop.is_numeric_hparam(v) == jpop.is_numeric_hparam(v)
    with pytest.raises(ValueError, match="structural"):
        pop.split_config([{"name": "a"}, {"name": "b"}])
    seen = {}

    def trainable(cfg, **structural):
        seen["k"] = cfg["k"]
        seen["structural"] = structural
        return cfg["lr"] * cfg["k"].to(torch.float32)

    scores = pop.vmapped_trials(trainable, cfgs)
    np.testing.assert_allclose(scores, [0.3, 1.0], rtol=1e-6)
    assert seen["structural"] == {"name": "a", "flag": True}


def test_vmap_trainable_that_draws_random_numbers_fails_its_batch():
    """The contract: a vmapped trainable draws no random numbers (the
    population runs under ``randomness="error"``), so such a batch is
    scored as failed, as any raising batch is."""
    def noisy(cfg, **shared):
        return cfg["lr"] * torch.randn(())

    eng = search.SearchEngine({"lr": search.Uniform(0.1, 1.0)},
                              num_samples=4, backend="vmap", seed=0)
    res = eng.run(noisy)
    assert all("error" in r.extra and r.metric == float("inf")
               for r in res)
    assert "random" in res[0].extra["error"]


def test_vmap_constant_numeric_and_degenerate_population():
    seen = {}

    def trainable(cfg, **structural):
        seen.update(cfg)
        return torch.as_tensor(cfg["lr"]) * 0 + cfg["scale"]

    eng = search.SearchEngine({"lr": search.GridSearch([0.01]),
                               "scale": search.Uniform(0.1, 0.9)},
                              num_samples=4, backend="vmap", seed=1)
    res = eng.run(trainable)
    assert all("error" not in r.extra for r in res)
    np.testing.assert_allclose([r.metric for r in res],
                               [r.config["scale"] for r in res], rtol=1e-6)
    assert set(seen) == {"lr", "scale"}
    same = pop.vmapped_trials(lambda cfg: torch.tensor(2.0),
                              [{"a": 1}, {"a": 1}])
    assert same == [2.0, 2.0]


# ---------------------------------------------------------------------------
# the feature transformer
# ---------------------------------------------------------------------------

def _series_df(n=200, seed=0, extra=True):
    rs = np.random.RandomState(seed)
    dt = pd.date_range("2019-01-01", periods=n, freq="30min")
    t = np.arange(n)
    value = np.sin(2 * np.pi * t / 48.0) + 0.1 * rs.randn(n) + 2.0
    df = pd.DataFrame({"datetime": dt, "value": value.astype(np.float32)})
    if extra:
        df["load"] = (rs.rand(n) * 3).astype(np.float32)
    return df


@pytest.mark.parametrize("future,past,selected", [
    (1, 5, None), (2, 4, []), (3, 6, ["HOUR(datetime)", "load"])])
def test_feature_transformer_is_exact(tmp_path, future, past, selected):
    df = _series_df()
    df.loc[7, "value"] = np.nan                 # dropped as missing

    def run(m, name):
        ft = m.TimeSequenceFeatureTransformer(future_seq_len=future,
                                              extra_features_col=["load"])
        cfg = {"past_seq_len": past}
        if selected is not None:
            cfg["selected_features"] = selected
        x, y = ft.fit_transform(df, **cfg)
        xt, _ = ft.transform(df.iloc[-40:], is_train=False)
        x2, y2 = ft.transform(df.iloc[:60], is_train=True)
        post = ft.post_processing(df.iloc[-40:], xt[:, -future:, 0]
                                  if future > 1 else xt[:, -1:, 0])
        path = str(tmp_path / f"{name}.json")
        ft.save(path)
        return (x, y, xt, x2, y2, post, open(path).read(),
                m.TimeSequenceFeatureTransformer.load(path))

    got, want = run(feat, "port"), run(jfeat, "jax")
    for g, w in zip(got[:5], want[:5]):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    pd.testing.assert_frame_equal(got[5], want[5])
    assert got[6] == want[6]
    assert json.loads(got[6])["config"]["past_seq_len"] == past
    np.testing.assert_array_equal(got[7].scale_min, want[7].scale_min)
    assert got[7].config == want[7].config


def test_feature_transformer_errors():
    df = _series_df(4, extra=False)
    ft = feat.TimeSequenceFeatureTransformer(future_seq_len=2)
    with pytest.raises(ValueError, match="too short"):
        ft.fit_transform(df, past_seq_len=5, selected_features=[])
    with pytest.raises(RuntimeError, match="fit_transform"):
        feat.TimeSequenceFeatureTransformer().transform(df)
    with pytest.raises(ValueError, match="unknown feature"):
        feat.TimeSequenceFeatureTransformer().fit_transform(
            df, past_seq_len=1, selected_features=["nope"])


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

MTNET_BLOCKS = {
    "two_layer_gru": dict(output_dim=2, time_step=4, long_num=3,
                          ar_window=2, cnn_height=2, cnn_hid_size=8,
                          rnn_hid_sizes=[4, 8]),
    "no_ar": dict(output_dim=1, time_step=3, long_num=2, ar_window=0,
                  cnn_height=3, cnn_hid_size=6, rnn_hid_sizes=[5]),
}


@pytest.mark.parametrize("case", sorted(MTNET_BLOCKS))
def test_mtnet_block_forward_and_gradients_match_jax(case):
    import jax
    import jax.numpy as jnp

    kw = MTNET_BLOCKS[case]
    t, n = kw["time_step"], kw["long_num"]
    rs = np.random.RandomState(0)
    long = rs.randn(5, n, t, 3).astype(np.float32)
    short = rs.randn(5, t, 3).astype(np.float32)
    probe = rs.randn(5, kw["output_dim"]).astype(np.float32)
    jblk = jmtnet.MTNetBlock(**kw)
    params = _numpy(jblk.build_params(jax.random.PRNGKey(1), long.shape,
                                      short.shape))
    # a numpy init of the JAX tree's shapes (not the JAX draw): both
    # packages start from the same arrays
    params = jax.tree_util.tree_map(
        lambda a: (rs.randn(*a.shape) * 0.3).astype(np.float32), params)
    blk = mtnet.MTNetBlock(**kw)
    blk.build(torch.Generator().manual_seed(0), long.shape, short.shape)
    load_jax_params(blk, params)

    def jloss(p):
        return jnp.sum(jblk.forward(p, long, short) * probe)

    want = np.asarray(jblk.forward(params, long, short))
    got = blk(torch.from_numpy(long), torch.from_numpy(short))
    assert tuple(got.shape) == blk.output_shape(long.shape, short.shape)
    _close(got, want, FWD_RTOL, FWD_ATOL)
    (got * torch.from_numpy(probe)).sum().backward()
    jgrads = jax.grad(jloss)(params)

    def grads_of(layer):
        out = {n: layer._parameters[n].grad for n in layer._leaf_names}
        out.update({k: grads_of(sub) for k, sub in layer._tree.items()})
        return out

    tgrads = grads_of(blk)
    _close(tgrads, _numpy(jgrads), GRAD_RTOL, GRAD_ATOL)
    # every leaf group receives gradient (over one conv window the
    # attention softmax is constant and the GRU takes one step from h = 0,
    # so the attention vector and the recurrent kernels get none)
    moving = [tgrads["head_w"], tgrads["ctx"]["gru0"]["wi"],
              tgrads["query"]["conv_w"]]
    if kw["time_step"] > kw["cnn_height"]:
        moving += [tgrads["mem"]["attn_v"], tgrads["ctx"]["gru0"]["wh"]]
    assert all(float(v.abs().sum()) > 0 for v in moving)


def test_load_jax_params_names_a_wrong_path():
    kw = MTNET_BLOCKS["no_ar"]
    blk = mtnet.MTNetBlock(**kw)
    blk.build(torch.Generator().manual_seed(0), (2, 2, 3, 3), (2, 3, 3))
    tree = {k: v for k, v in _numpy(blk.params()).items()}
    tree["mem"] = dict(tree["mem"])
    tree["mem"]["gru0"] = {"wi": tree["mem"]["gru0"]["wi"],
                           "wh": np.zeros((1, 1), np.float32),
                           "b": tree["mem"]["gru0"]["b"]}
    with pytest.raises(ValueError, match=r"mem\.gru0\.wh"):
        load_jax_params(blk, tree)
    del tree["mem"]["gru0"]["b"]
    with pytest.raises(ValueError, match=r"mem\.gru0: missing leaves"):
        load_jax_params(blk, tree)


@pytest.mark.parametrize("future,out_dim", [(1, 1), (3, 1), (2, 2)])
def test_encoder_decoder_block_matches_jax(future, out_dim):
    import jax
    import jax.numpy as jnp

    rs = np.random.RandomState(2)
    x = rs.randn(4, 6, 3).astype(np.float32)
    jblk = jts._build_encdec_block()(future, latent_dim=5, out_dim=out_dim)
    params = jax.tree_util.tree_map(
        lambda a: (rs.randn(*a.shape) * 0.4).astype(np.float32),
        _numpy(jblk.build_params(jax.random.PRNGKey(0), x.shape)))
    blk = ts.Seq2SeqBlock(future, latent_dim=5, out_dim=out_dim)
    blk.build(torch.Generator().manual_seed(0), x.shape)
    load_jax_params(blk, params)
    probe = rs.randn(4, future * out_dim).astype(np.float32)
    got = blk(torch.from_numpy(x))
    want = np.asarray(jblk.forward(params, x))
    assert tuple(got.shape) == blk.output_shape(x.shape) == want.shape
    _close(got, want, FWD_RTOL, FWD_ATOL)
    (got * torch.from_numpy(probe)).sum().backward()
    jg = _numpy(jax.grad(lambda p: jnp.sum(jblk.forward(p, x) * probe))(
        params))
    _close({"enc": {k: blk.subtree("enc")._parameters[k].grad
                    for k in ("wi", "wh", "b")},
            "dec": {k: blk.subtree("dec")._parameters[k].grad
                    for k in ("wi", "wh", "b")},
            "proj_w": blk._parameters["proj_w"].grad,
            "proj_b": blk._parameters["proj_b"].grad},
           jg, GRAD_RTOL, GRAD_ATOL)


# ---------------------------------------------------------------------------
# fit_eval from one init
# ---------------------------------------------------------------------------

def _windows(n=96, past=8, d=2, seed=0):
    rs = np.random.RandomState(seed)
    t = np.arange(n + past + 1)
    series = np.stack([np.sin(t / 4.0)] + [rs.randn(len(t)) * 0.1
                                           for _ in range(d - 1)], -1)
    x = np.stack([series[i:i + past] for i in range(n)]).astype(np.float32)
    y = series[past:past + n, :1].astype(np.float32)
    return x, y


MODELS = {
    "mtnet": (lambda m: m[0].MTNet(), dict(
        time_step=2, long_num=3, cnn_height=2, cnn_hid_size=4,
        rnn_hid_sizes=[3, 4], ar_window=2, lr=5e-3, epochs=4), 1),
    "lstm": (lambda m: m[1].VanillaLSTM(), dict(
        lstm_1_units=4, lstm_2_units=3, dropout=0.0, lr=5e-3, epochs=4), 1),
    "seq2seq": (lambda m: m[1].Seq2SeqForecaster(future_seq_len=2), dict(
        latent_dim=4, lr=5e-3, epochs=4), 2),
}


def _carried(model, init, jax_side):
    """``model`` whose every build starts from ``init``."""
    ensure = model._ensure

    def _ensure(x, y, config):
        ensure(x, y, config)
        if jax_side:
            model.model.estimator.set_initial_weights(init)
        else:
            model.model.set_initial_weights(init)

    model._ensure = _ensure
    return model


def _jax_init(name, x, y, cfg):
    """The JAX model's own init, as numpy: both packages start from it."""
    make, _, _ = MODELS[name]
    m = make((jmtnet, jts))
    m._ensure(x, y, cfg)
    xs = list(m._split(x, cfg)) if name == "mtnet" else [x]
    m.model.estimator._ensure_built(xs)
    return _numpy(m.model.estimator.params)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_fit_eval_from_one_init_matches_jax(name):
    make, cfg, horizon = MODELS[name]
    x, y = _windows()
    if horizon > 1:
        y = np.concatenate([np.roll(y, -k, 0) for k in range(horizon)], 1)
    vx, vy = x[-24:], y[-24:]
    x, y = x[:-24], y[:-24]
    cfg = dict(cfg, batch_size=len(x))      # one batch: the same order
    init = _jax_init(name, x, y, cfg)
    jm = _carried(make((jmtnet, jts)), init, jax_side=True)
    tm = _carried(make((mtnet, ts)), init, jax_side=False)
    want = jm.fit_eval(x, y, validation_data=(vx, vy), metric="mse", **cfg)
    got = tm.fit_eval(x, y, validation_data=(vx, vy), metric="mse", **cfg)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    first = jm.model.estimator.history[0]["loss"]
    assert tm.model.estimator.history[0]["loss"] == pytest.approx(
        first, rel=1e-4)
    np.testing.assert_allclose(tm.predict(vx), np.asarray(jm.predict(vx)),
                               rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# pipelines across packages
# ---------------------------------------------------------------------------

PIPE_CONFIGS = {
    "MTNet": dict(model="MTNet", past_seq_len=8, time_step=2, long_num=3,
                  cnn_height=1, cnn_hid_size=4, rnn_hid_sizes=[4],
                  ar_window=1, lr=1e-3, batch_size=32, epochs=1,
                  selected_features=["HOUR(datetime)", "load"]),
    "VanillaLSTM": dict(past_seq_len=4, lstm_1_units=4, lstm_2_units=3,
                        dropout=0.0, lr=1e-3, batch_size=32, epochs=1,
                        selected_features=["IS_BUSY_HOURS(datetime)"]),
    "Seq2SeqForecaster": dict(past_seq_len=5, latent_dim=4, lr=1e-3,
                              batch_size=32, epochs=1,
                              selected_features=[]),
}


def _fitted_pipeline(m_feat, m_pipe, models, kind, df):
    cfg = PIPE_CONFIGS[kind]
    fsl = 2 if kind == "Seq2SeqForecaster" else 1
    ft = m_feat.TimeSequenceFeatureTransformer(future_seq_len=fsl,
                                               extra_features_col=["load"])
    x, y = ft.fit_transform(df, **cfg)
    mod_mtnet, mod_ts = models
    model = {"MTNet": lambda: mod_mtnet.MTNet(),
             "VanillaLSTM": lambda: mod_ts.VanillaLSTM(),
             "Seq2SeqForecaster":
                 lambda: mod_ts.Seq2SeqForecaster(fsl)}[kind]()
    model.fit_eval(x, y, **cfg)
    return m_pipe.TimeSequencePipeline(ft, model, cfg)


@pytest.mark.parametrize("kind", sorted(PIPE_CONFIGS))
def test_jax_pipeline_directory_loads_in_the_port(tmp_path, kind):
    df = _series_df(160)
    jp = _fitted_pipeline(jfeat, jpipe, (jmtnet, jts), kind, df)
    jp.save(str(tmp_path))
    got = pipe.load_ts_pipeline(str(tmp_path))
    assert type(got.model).__name__ == kind
    want = jp.predict(df.iloc[-50:])
    out = got.predict(df.iloc[-50:])
    assert list(out.columns) == list(want.columns)
    for c in want.columns[1:]:
        np.testing.assert_allclose(out[c].to_numpy(), want[c].to_numpy(),
                                   rtol=FWD_RTOL, atol=FWD_ATOL)
    np.testing.assert_array_equal(out["datetime"].to_numpy(),
                                  want["datetime"].to_numpy())
    np.testing.assert_allclose(got.evaluate(df), jp.evaluate(df),
                               rtol=1e-5)


@pytest.mark.parametrize("kind", sorted(PIPE_CONFIGS))
def test_port_pipeline_directory_loads_in_jax(tmp_path, kind, monkeypatch):
    from analytics_zoo_tpu.train import checkpoint as jax_ckpt

    from analytics_zoo_tpu_torch.train.checkpoint import load_pytree

    df = _series_df(160)
    tp = _fitted_pipeline(feat, pipe, (mtnet, ts), kind, df)
    tp.save(str(tmp_path))
    monkeypatch.setattr(jax_ckpt, "load_pytree", load_pytree)
    got = jpipe.load_ts_pipeline(str(tmp_path))
    assert type(got.model).__name__ == kind
    want = tp.predict(df.iloc[-50:])
    out = got.predict(df.iloc[-50:])
    for c in want.columns[1:]:
        np.testing.assert_allclose(out[c].to_numpy(), want[c].to_numpy(),
                                   rtol=FWD_RTOL, atol=FWD_ATOL)


def test_predictor_fit_save_load_predict_and_release(tmp_path,
                                                     monkeypatch):
    from analytics_zoo_tpu_torch.train.estimator import Estimator

    released = []
    real = Estimator.release_graphs
    monkeypatch.setattr(Estimator, "release_graphs",
                        lambda est: released.append(est) or real(est))
    df = _series_df(200)
    tsp = TimeSequencePredictor(future_seq_len=1, extra_features_col=["load"])
    recipe = search.MTNetGridRandomRecipe(1, time_steps=(2,),
                                          long_nums=(2, 3))
    recipe.search_space = (lambda orig: lambda feats: dict(
        orig(feats), epochs=1))(recipe.search_space)
    pipeline = tsp.fit(df, metric="mse", recipe=recipe, max_parallel=2)
    assert len(released) == 1
    out = tsp.predict(df.iloc[-60:])
    pipeline.save(str(tmp_path))
    again = pipe.load_ts_pipeline(str(tmp_path))
    pd.testing.assert_frame_equal(again.predict(df.iloc[-60:]), out)
    smoke = TimeSequencePredictor().fit(df, recipe=MTNetSmokeRecipe())
    assert np.isfinite(smoke.evaluate(df))


def test_concurrent_trials_equal_sequential_trials():
    """Trials in threads build and train their own models (thread-local
    layer names): the scores are those of the trials run one by one."""
    x, y = _windows(n=64, past=8)

    def trainable(cfg):
        m = mtnet.MTNet()
        return m.fit_eval(x[:48], y[:48], validation_data=(x[48:], y[48:]),
                          **cfg)

    space = dict(search.MTNetGridRandomRecipe(1, time_steps=(2,),
                                              long_nums=(3,)).search_space(
        []), epochs=1, batch_size=16)
    space["cnn_hid_size"] = search.Choice([4, 8])
    runs = []
    for par in (1, 3):
        eng = search.SearchEngine(space, num_samples=3, seed=0,
                                  max_parallel=par)
        runs.append([(r.config, r.metric) for r in eng.run(trainable)])
    assert runs[0] == runs[1]
