"""The PyTorch port training image models against the JAX package's
``Estimator``, with layer state (BatchNormalization's moving statistics).

Weights, state and data come from ``np.random.RandomState``; the port
trains on the CPU (``device="cpu"``), the JAX package on its 8-device
CPU mesh (batches are multiples of 8; its BN statistics are the whole
batch's, as the port's are).  Each JAX ResNet-50 run is built and
compiled once per module.  Tolerances, with their reasons:

- ResNet-50 at full depth, 32x32, 10 classes, f32: the eval forward
  within 1e-4 of the largest |logit|; two SGD steps (lr 0.01, batch 8):
  losses rtol 1e-5, parameters atol 1e-4 and moving statistics atol
  1e-5 (measured on one host: 1e-9, 3e-5 and 1e-6, with parameters
  moving 0.036 and statistics 0.1 — f32 sums through 53 BN layers in
  another order).  Plain SGD keeps parameter differences proportional
  to gradient differences (Adam's first steps move an element by about
  its learning rate whatever its gradient's size, so gradients near 0
  would decide the sign).
- One bf16 step (``compute_dtype="bfloat16"``) against the JAX bf16
  step: loss rtol 1e-2, the update's cosine with the JAX update at
  least 0.85, parameters atol 3e-2 and moving statistics atol 3e-2
  (measured: 3.6e-3, 0.942, 0.0085 and 0.0094; each package's bf16
  update has a cosine of 0.94-0.96 with its own f32 update).  Both
  packages round every layer's result to bf16 (a relative step of
  2^-8), but the JAX package normalizes and takes the batch statistics
  in bf16 arithmetic, the port in ``F.batch_norm``'s f32, and both
  reduce in other orders.
- A small conv net (conv, BN, max pooling, dense) over several epochs:
  losses rtol 1e-5, parameters and statistics atol 1e-5.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.nn import reset_name_scope as jax_reset_names

from analytics_zoo_tpu_torch.convert import (export_params, export_state,
                                             load_archive_params,
                                             load_jax_params)
from analytics_zoo_tpu_torch.core import context
from analytics_zoo_tpu_torch.core.profiling import TIMERS
from analytics_zoo_tpu_torch.models import image as timage
from analytics_zoo_tpu_torch.nn import GraphNet, Sequential, reset_name_scope
from analytics_zoo_tpu_torch.nn.layers import (Activation,
                                               BatchNormalization,
                                               Convolution2D, Dense, Flatten,
                                               MaxPooling2D)
from analytics_zoo_tpu_torch.robust import FaultInjector
from analytics_zoo_tpu_torch.train import checkpoint as tckpt
from analytics_zoo_tpu_torch.train import optimizers as topt

jopt = importlib.import_module("analytics_zoo_tpu.train.optimizers")
CE = "sparse_categorical_crossentropy_with_logits"
LR = 0.01


@pytest.fixture(autouse=True)
def fresh_context():
    context.set_zoo_context(None)
    yield
    context.set_zoo_context(None)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 4))
    yield
    torch.set_num_threads(before)


def _weights(net, seed):
    """Seeded params (gamma near 1) and moving statistics for ``net``."""
    rs = np.random.RandomState(seed)
    params = {name: {leaf: ((1.0 + 0.1 * rs.randn(*v.shape)) if leaf ==
                            "gamma" else 0.05 * rs.randn(*v.shape)).astype(
                                np.float32) for leaf, v in sub.items()}
              for name, sub in net.params().items()}
    state = {name: ({"moving_mean": (0.1 * rs.randn(*s["moving_mean"].shape)
                                     ).astype(np.float32),
                     "moving_var": (0.5 + rs.rand(*s["moving_var"].shape)
                                    ).astype(np.float32)} if s else {})
             for name, s in net.state().items()}
    return params, state


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees_close(got, want, atol, what):
    want = {k: v for k, v in _np(want).items() if v}
    got = {k: v for k, v in got.items() if v}
    assert set(got) == set(want), what
    for layer, leaves in want.items():
        for leaf, w in leaves.items():
            np.testing.assert_allclose(got[layer][leaf], w, rtol=0,
                                       atol=atol,
                                       err_msg=f"{what} {layer}.{leaf}")


def _moved(got, init):
    return max(float(np.abs(got[k][leaf] - init[k][leaf]).max())
               for k in init for leaf in init[k])


# ---------------------------------------------------------------------------
# ResNet-50 at full depth


@pytest.fixture(scope="module")
def resnet_setup():
    """The port's ResNet-50 (10 classes, 32x32), seeded weights and
    state, and 16 seeded images with labels.  The last BN of every
    residual branch (``*_c_bn``) starts with gamma drawn around 0 (std
    0.1), the practice of starting each block near the identity: a
    random net with unit gammas there normalizes, in its last stage, 8
    nearly equal values per channel per batch, and its training forward
    then amplifies a 1e-7 change of a weight into a 1% change of the
    loss, so no two f32 implementations could agree on it."""
    reset_name_scope()
    net = timage.resnet50(10, (32, 32, 3))
    params, state = _weights(net, 0)
    rs = np.random.RandomState(9)
    for name, sub in params.items():
        if name.endswith("_c_bn"):
            sub["gamma"] = (0.1 * rs.randn(*sub["gamma"].shape)).astype(
                np.float32)
    rs = np.random.RandomState(1)
    x = rs.randn(16, 32, 32, 3).astype(np.float32)
    y = rs.randint(0, 10, 16).astype(np.int32)
    return params, state, x, y


def _jax_resnet(compute_dtype, params, state):
    from analytics_zoo_tpu import init_zoo_context as jax_init_context
    from analytics_zoo_tpu.models.image import resnet50

    jax_init_context(compute_dtype=compute_dtype)
    jax_reset_names()
    jnet = resnet50(10, (32, 32, 3))
    jnet.compile(optimizer=jopt.SGD(lr=LR), loss=CE)
    # marked built, so set_initial_weights places the seeded trees and
    # initializes the optimizer at once, and the estimator's own random
    # build (an eval_shape per layer, 10 s at this depth), which the
    # seeded trees would replace, never runs
    jnet.estimator.params = {}
    jnet.estimator.set_initial_weights(params, state)
    return jnet


def _port_resnet(params, state, compute_dtype=None):
    reset_name_scope()
    net = timage.resnet50(10, (32, 32, 3))
    load_jax_params(net, params, state)
    net.compile(topt.SGD(lr=LR), CE, device="cpu",
                compute_dtype=compute_dtype)
    return net


@pytest.fixture(scope="module")
def jax_f32_fit(resnet_setup):
    """The JAX package's ResNet-50: the eval forward of the first 8
    images (``call`` with ``training=False``, what its ``predict``
    jits), then two f32 SGD steps of batch 8 through ``fit``."""
    params, state, x, y = resnet_setup
    jnet = _jax_resnet("float32", params, state)
    logits = np.asarray(jax.jit(
        lambda p, s, x: jnet.call(p, s, x, training=False)[0])(
            jax.tree_util.tree_map(jnp.asarray, params),
            jax.tree_util.tree_map(jnp.asarray, state), jnp.asarray(x[:8])))
    hist = jnet.fit(x, y, batch_size=8, nb_epoch=1, verbose=False)
    return (logits, [h["loss"] for h in hist], _np(jnet.estimator.params),
            _np(jnet.estimator.state))


def test_resnet50_full_depth_eval_forward(resnet_setup, jax_f32_fit):
    """``predict`` normalizes with the moving statistics, as the JAX
    eval forward does: the logits within 1e-4 of the largest."""
    params, state, x, _ = resnet_setup
    net = _port_resnet(params, state)
    got = net.predict(x[:8], batch_size=8)
    want = jax_f32_fit[0]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_resnet50_two_f32_fit_steps(resnet_setup, jax_f32_fit):
    """Two f32 SGD steps through ``fit`` (the same batches: both packages
    shuffle with ``RandomState(seed)``): losses, all 25.6 M-parameter
    leaves and all 53 BN layers' moving statistics against the JAX
    ``fit``; the statistics moved well past the tolerance."""
    params, state, x, y = resnet_setup
    net = _port_resnet(params, state)
    hist = net.fit(x, y, batch_size=8, nb_epoch=1, verbose=False)
    _, jloss, jparams, jstate = jax_f32_fit
    np.testing.assert_allclose([h["loss"] for h in hist], jloss, rtol=1e-5)
    got_p, got_s = export_params(net), export_state(net)
    _assert_trees_close(got_p, jparams, 1e-4, "params")
    _assert_trees_close(got_s, jstate, 1e-5, "state")
    assert _moved(got_s, state) > 0.05
    assert _moved(got_p, params) > 1e-2


def test_resnet50_bf16_step(resnet_setup):
    """One ``compute_dtype="bfloat16"`` step against the JAX package's:
    the state reaches the BN layers in bf16 and returns to f32; the
    masters and the state stay f32."""
    params, state, x, y = resnet_setup
    jnet = _jax_resnet("bfloat16", params, state)
    jhist = jnet.fit(x[:8], y[:8], batch_size=8, nb_epoch=1, verbose=False)
    net = _port_resnet(params, state, compute_dtype="bfloat16")
    hist = net.fit(x[:8], y[:8], batch_size=8, nb_epoch=1, verbose=False)
    np.testing.assert_allclose(hist[0]["loss"], jhist[0]["loss"], rtol=1e-2)
    got_p, got_s = export_params(net), export_state(net)
    _assert_trees_close(got_p, jnet.estimator.params, 3e-2, "bf16 params")
    _assert_trees_close(got_s, jnet.estimator.state, 3e-2, "bf16 state")

    def update(tree):
        return np.concatenate([np.asarray(tree[k][leaf]).ravel()
                               - params[k][leaf].ravel()
                               for k in sorted(params)
                               for leaf in sorted(params[k])])

    a, b = update(got_p), update(_np(jnet.estimator.params))
    assert a @ b / np.linalg.norm(a) / np.linalg.norm(b) > 0.85
    assert all(t.dtype == torch.float32 for t in net.parameters())
    assert all(t.dtype == torch.float32 for s in net.state().values()
               for t in s.values())
    assert _moved(got_s, state) > 0.02


# ---------------------------------------------------------------------------
# a small conv net: the guard, freezing, metrics and checkpoints


def _small(jax_pkg=False):
    """Conv(6, 3x3, same) - BN("bn") - relu - 2x2 max pool - flatten -
    Dense(7), over 8x8x3 inputs, from either package."""
    if jax_pkg:
        from analytics_zoo_tpu.nn import Sequential as S
        from analytics_zoo_tpu.nn.layers import (Activation as A,
                                                 BatchNormalization as B,
                                                 Convolution2D as C,
                                                 Dense as D, Flatten as F,
                                                 MaxPooling2D as M)
        jax_reset_names()
    else:
        S, A, B, C, D, F, M = (Sequential, Activation, BatchNormalization,
                               Convolution2D, Dense, Flatten, MaxPooling2D)
        reset_name_scope()
    return S([C(6, 3, 3, border_mode="same", input_shape=(8, 8, 3),
                name="conv"),
              B(name="bn", momentum=0.8), A("relu", name="relu"),
              M((2, 2), name="pool"), F(name="flat"), D(7, name="head")])


def _small_data(n=32, seed=2):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, 8, 8, 3).astype(np.float32),
            rs.randint(0, 7, n).astype(np.int32))


def _small_port(weights, **kw):
    net = _small()
    net.build(torch.Generator().manual_seed(0))
    load_jax_params(net, *weights)
    net.compile(topt.SGD(lr=0.05), CE, metrics=["accuracy", "top5accuracy"],
                device="cpu", **kw)
    return net


@pytest.fixture(scope="module")
def small_weights():
    net = _small()
    net.build(torch.Generator().manual_seed(0))
    return _weights(net, 4)


@pytest.fixture(scope="module")
def jax_small_frozen(small_weights, tmp_path_factory):
    """The JAX package's small net, BN frozen, two epochs with a
    checkpoint each, then ``evaluate`` with top-5 accuracy."""
    from analytics_zoo_tpu import init_zoo_context as jax_init_context
    from analytics_zoo_tpu.nn.net import GraphNet as JGraphNet

    x, y = _small_data()
    jax_init_context()
    jnet = _small(jax_pkg=True)
    JGraphNet(jnet).freeze(["bn"])
    jnet.compile(optimizer=jopt.SGD(lr=0.05), loss=CE,
                 metrics=["accuracy", "top5accuracy"])
    jnet.estimator.set_initial_weights(*small_weights)
    ckpt = str(tmp_path_factory.mktemp("jax_ckpt"))
    jnet.set_checkpoint(ckpt)
    hist = jnet.fit(x, y, batch_size=8, nb_epoch=2, verbose=False)
    ev = jnet.evaluate(x, y, batch_size=8)
    return (hist, _np(jnet.estimator.params), _np(jnet.estimator.state), ev,
            ckpt, np.asarray(jnet.predict(x, batch_size=8)))


def test_frozen_bn_still_moves_its_statistics(small_weights,
                                              jax_small_frozen):
    """``GraphNet.freeze`` stops the BN layer's gamma and beta but not
    its moving statistics, as in the JAX step: every weight and statistic
    after two epochs against the JAX run; evaluate's loss, accuracy and
    top-5 accuracy (``compile(metrics=["top5accuracy"])``) read the
    moving statistics and match."""
    x, y = _small_data()
    net = _small_port(small_weights)
    GraphNet(net).freeze(["bn"])
    hist = net.fit(x, y, batch_size=8, nb_epoch=2, verbose=False)
    jhist, jparams, jstate, jev, _, _ = jax_small_frozen
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in jhist], rtol=1e-5)
    got_p, got_s = export_params(net), export_state(net)
    _assert_trees_close(got_p, jparams, 1e-5, "params")
    _assert_trees_close(got_s, jstate, 1e-5, "state")
    for leaf in ("gamma", "beta"):
        np.testing.assert_array_equal(got_p["bn"][leaf],
                                      small_weights[0]["bn"][leaf])
    assert _moved(got_s, small_weights[1]) > 0.1
    ev = net.evaluate(x, y, batch_size=8)
    assert set(ev) == {"loss", "accuracy", "top5_accuracy"}
    for k, v in ev.items():
        assert v == pytest.approx(float(jev[k]), rel=1e-5, abs=1e-6), k


def test_nan_guard_keeps_the_bn_state(small_weights):
    """A step whose loss is not finite keeps the moving statistics (and
    the weights) as they were, as the JAX step's ``keep_if_finite``:
    two steps with the second made NaN end where one step ends."""
    x, y = _small_data(16)
    a = _small_port(small_weights)
    n0 = TIMERS.count("robust/nan_steps")
    with FaultInjector().plan("estimator.step", at=1, action="nan"):
        a.fit(x, y, batch_size=8, nb_epoch=1, shuffle=False, verbose=False)
    assert TIMERS.count("robust/nan_steps") - n0 == 1
    b = _small_port(small_weights)
    b.fit(x[:8], y[:8], batch_size=8, nb_epoch=1, shuffle=False,
          verbose=False)
    for got, want in ((export_state(a), export_state(b)),
                      (export_params(a), export_params(b))):
        for layer, leaves in want.items():
            for leaf, w in leaves.items():
                np.testing.assert_array_equal(got[layer][leaf], w)
    assert _moved(export_state(b), small_weights[1]) > 0


def test_checkpoints_with_state_across_packages(small_weights,
                                                jax_small_frozen, tmp_path):
    """A JAX ``fit`` checkpoint's params and state load into the port net
    (answers within 1e-5 of the JAX ``predict``); the port's snapshot
    holds the state under the JAX keys (the same leaf keys, dtypes and
    shapes as the JAX snapshot's params and state), and a restore copies
    it into the live buffers."""
    import json

    x, y = _small_data()
    _, _, jstate, _, jckpt, jpred = jax_small_frozen
    _, tree = tckpt.CheckpointManager(jckpt).restore()
    net = _small_port(small_weights)
    load_archive_params(net, tree["params"], tree["state"])
    np.testing.assert_allclose(net.predict(x, batch_size=8), jpred, rtol=0,
                               atol=1e-5)
    est = net.estimator
    est.set_checkpoint(str(tmp_path))
    net.fit(x, y, batch_size=8, nb_epoch=1, verbose=False)
    live = net.subtree("bn").state_leaf("moving_var")
    saved = export_state(net)

    def leaf_specs(directory, parts):
        mgr = tckpt.CheckpointManager(directory)
        path = mgr._path(mgr.latest_step())
        with np.load(path) as z:
            m = json.loads(z["__manifest__"].tobytes())["leaves"]
        return {k.split("|", 1)[1]: (v["dtype"], tuple(v["shape"]))
                for k, v in m.items() if k.split("|", 1)[-1].split("/")[0]
                in parts}

    assert leaf_specs(str(tmp_path), ("params", "state")) == leaf_specs(
        jckpt, ("params", "state"))
    with torch.no_grad():
        live.fill_(7.0)
    est.load_checkpoint(str(tmp_path))
    assert net.subtree("bn").state_leaf("moving_var") is live
    np.testing.assert_array_equal(live.numpy(), saved["bn"]["moving_var"])
