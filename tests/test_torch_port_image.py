"""The PyTorch port's image layers, builders and image serving against
the JAX package on the CPU.

Inputs, weights and state come from ``np.random.RandomState``; the JAX
layer runs through its ``call`` (jitted for whole nets), the port's on
CPU tensors.  Tolerances, with their reasons:

- a layer in f32 (convolution, pooling, BatchNormalization): within
  1e-5 of the largest |JAX output| (f32 sums of up to a few hundred
  products in another order; max pooling and the window counts are
  exact, so pooling holds 1e-6); BN's moving statistics within 1e-6
  (one mean and one biased variance per channel, a momentum step);
- a whole net's eval forward (ResNet-50, Inception-v1, MobileNet,
  VGG-16): within 1e-4 of the largest |JAX logit| (50-odd layers of f32
  sums in another order);
- int8 and int4 serving: the same, since both packages quantize
  bit-identically and dequantize to the same f32 values;
- uint8 wire served in bf16: every layer rounds to bf16 (a relative
  step of 2^-8) in both packages, reducing in other orders and at other
  internal widths (cuDNN/oneDNN f32 accumulation against XLA's), so
  logits are held to 0.1 of the largest |logit| and top-1 must agree
  on all but one row in eight.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.deploy.inference import InferenceModel as JaxIM
from analytics_zoo_tpu.deploy.inference import (
    imagenet_preprocess as jax_imagenet_preprocess)
from analytics_zoo_tpu.nn import reset_name_scope as jax_reset_names
from analytics_zoo_tpu.nn.layers import convolutional as jconv
from analytics_zoo_tpu.nn.layers import normalization as jnorm
from analytics_zoo_tpu.nn.layers import pooling as jpool
from analytics_zoo_tpu.nn.layers.merge import Merge as JMerge
from analytics_zoo_tpu.nn import metrics as jmetrics

from analytics_zoo_tpu_torch.convert import (export_params, export_state,
                                             load_jax_params)
from analytics_zoo_tpu_torch.deploy import InferenceModel, imagenet_preprocess
from analytics_zoo_tpu_torch.models import image as timage
from analytics_zoo_tpu_torch.nn import metrics as tmetrics
from analytics_zoo_tpu_torch.nn import reset_name_scope
from analytics_zoo_tpu_torch.nn.layers import convolutional as tconv
from analytics_zoo_tpu_torch.nn.layers import normalization as tnorm
from analytics_zoo_tpu_torch.nn.layers import pooling as tpool
from analytics_zoo_tpu_torch.nn.layers.merge import Merge as TMerge

LAYER_TOL = 1e-5
NET_TOL = 1e-4
BF16_TOL = 0.1


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 4))
    yield
    torch.set_num_threads(before)


def _rand_like(tree, rs, scale=0.1):
    """Seeded arrays shaped as ``tree``'s leaves (a port tree)."""
    if isinstance(tree, dict):
        return {k: _rand_like(v, rs, scale) for k, v in tree.items()}
    return rs.randn(*tree.shape).astype(np.float32) * scale


def _bn_trees(layer, rs):
    """Random gamma/beta and moving statistics for a built port BN."""
    params = {k: (1.0 + 0.2 * rs.randn(*v.shape)).astype(np.float32)
              if k == "gamma" else (0.2 * rs.randn(*v.shape)).astype(
                  np.float32) for k, v in layer.params().items()}
    state = {"moving_mean": (0.3 * rs.randn(*layer.state()[
        "moving_mean"].shape)).astype(np.float32),
             "moving_var": (0.5 + rs.rand(*layer.state()[
                 "moving_var"].shape)).astype(np.float32)}
    return params, state


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()),
                               err_msg=what)


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _port_layer(layer, shape, params=None, state=None):
    layer.build(torch.Generator().manual_seed(0), shape)
    if params is not None or state is not None:
        load_jax_params(layer, params if params is not None
                        else layer.params(), state)
    return layer


# ---------------------------------------------------------------------------
# BatchNormalization


@pytest.mark.parametrize("ordering,fraction",
                         [("tf", 1.0), ("th", 1.0), ("tf", 0.5),
                          ("th", 0.5)])
def test_batch_norm_train_eval_and_moving_stats(ordering, fraction):
    """Three training forwards (new batches, state carried) then an eval
    forward: outputs within 1e-5, moving statistics within 1e-6 after
    every step (ghost-BN takes them over the first ceil(B/2) rows)."""
    rs = np.random.RandomState(1)
    shape = (7, 5, 6, 4) if ordering == "tf" else (7, 4, 5, 6)
    kw = dict(dim_ordering=ordering, stats_fraction=fraction, momentum=0.9)
    t = _port_layer(tnorm.BatchNormalization(**kw), shape)
    params, state = _bn_trees(t, rs)
    load_jax_params(t, params, state)
    j = jnorm.BatchNormalization(**kw)
    jp, js = _jtree(params), _jtree(state)
    t.train()
    for step in range(3):
        x = (rs.randn(*shape) * 2 + 0.5).astype(np.float32)
        want, js = j.call(jp, js, jnp.asarray(x), training=True)
        got = t(torch.from_numpy(x))
        _close(got.detach(), want, LAYER_TOL, f"train step {step}")
        for k in ("moving_mean", "moving_var"):
            np.testing.assert_allclose(t.state()[k].numpy(), js[k],
                                       rtol=0, atol=1e-6, err_msg=k)
    t.eval()
    x = rs.randn(*shape).astype(np.float32)
    want, js2 = j.call(jp, js, jnp.asarray(x), training=False)
    _close(t(torch.from_numpy(x)).detach(), want, LAYER_TOL, "eval")
    assert js2 is js


def test_batch_norm_without_scale_or_center_and_2d_inputs():
    rs = np.random.RandomState(2)
    x = rs.randn(9, 6).astype(np.float32)
    for kw in (dict(scale=False), dict(center=False),
               dict(scale=False, center=False)):
        t = _port_layer(tnorm.BatchNormalization(**kw), x.shape)
        assert set(t.params()) == {"gamma", "beta"} - (
            {"gamma"} if not kw.get("scale", True) else set()) - (
            {"beta"} if not kw.get("center", True) else set())
        j = jnorm.BatchNormalization(**kw)
        jp, js = j.build(jax.random.PRNGKey(0), x.shape)
        t.train()
        want, _ = j.call(jp, js, jnp.asarray(x), training=True)
        _close(t(torch.from_numpy(x)).detach(), want, LAYER_TOL, str(kw))


# ---------------------------------------------------------------------------
# convolution


CONV_CASES = [
    # (spatial, kernel, stride, border, size, dilation, bias, ordering)
    (2, 1, 1, "valid", 9, 1, True, "tf"),
    (2, 1, 2, "same", 10, 1, False, "tf"),
    (2, 3, 1, "same", 9, 1, True, "tf"),
    (2, 3, 2, "same", 10, 1, False, "th"),
    (2, 3, 2, "valid", 9, 1, True, "tf"),
    (2, 3, 1, "same", 10, 2, True, "tf"),
    (2, 7, 2, "same", 16, 1, False, "tf"),
    (2, 7, 2, "same", 15, 1, True, "th"),
    (2, 7, 1, "valid", 12, 1, True, "tf"),
    (1, 3, 2, "same", 11, 1, True, "tf"),
    (1, 3, 1, "valid", 10, 2, False, "th"),
    (3, 3, 2, "same", 7, 1, True, "tf"),
]


@pytest.mark.parametrize("spatial,k,s,border,size,d,bias,ordering",
                         CONV_CASES)
def test_conv_matches_jax(spatial, k, s, border, size, d, bias, ordering):
    """Convolution1D/2D/3D: kernels 1/3/7, strides 1/2, valid/same on odd
    and even sizes (TF's asymmetric SAME padding), dilation, bias, both
    orderings; the leaf keeps the JAX shape (*k, in, out)."""
    rs = np.random.RandomState(k * 10 + s + size)
    cin, cout = 3, 5
    dims = (size,) * spatial
    shape = ((2,) + dims + (cin,)) if ordering == "tf" else (2, cin) + dims
    kw = dict(border_mode=border, subsample=s, dilation=d, bias=bias,
              dim_ordering=ordering, activation="relu")
    cls = {1: "Convolution1D", 2: "Convolution2D", 3: "Convolution3D"}[
        spatial]
    args = (cout,) + (k,) * spatial
    t = _port_layer(getattr(tconv, cls)(*args, **kw), shape)
    assert tuple(t.params()["kernel"].shape) == (k,) * spatial + (cin, cout)
    params = _rand_like(t.params(), rs, 0.3)
    load_jax_params(t, params)
    j = getattr(jconv, cls)(*args, **kw)
    x = rs.randn(*shape).astype(np.float32)
    want, _ = j.call(_jtree(params), {}, jnp.asarray(x))
    got = t(torch.from_numpy(x))
    assert tuple(got.shape) == tuple(t.output_shape(shape))
    _close(got.detach(), want, LAYER_TOL, cls)


@pytest.mark.parametrize("atrous", ["AtrousConvolution1D",
                                    "AtrousConvolution2D"])
def test_atrous_conv_matches_jax(atrous):
    rs = np.random.RandomState(5)
    one = atrous.endswith("1D")
    shape = (2, 13, 4) if one else (2, 11, 12, 4)
    args = (6, 3) if one else (6, 3, 3)
    kw = dict(atrous_rate=2 if one else (2, 3), border_mode="same")
    t = _port_layer(getattr(tconv, atrous)(*args, **kw), shape)
    params = _rand_like(t.params(), rs, 0.3)
    load_jax_params(t, params)
    x = rs.randn(*shape).astype(np.float32)
    want, _ = getattr(jconv, atrous)(*args, **kw).call(
        _jtree(params), {}, jnp.asarray(x))
    _close(t(torch.from_numpy(x)).detach(), want, LAYER_TOL, atrous)


@pytest.mark.parametrize("ordering", ["tf", "th"])
@pytest.mark.parametrize("size", [16, 15])
def test_space_to_depth_stem_matches_jax_and_plain(ordering, size):
    """The stem against the JAX layer (its space-to-depth computation on
    even inputs, the plain convolution on odd ones) and against the plain
    7x7/s2 SAME Convolution2D on the same leaf."""
    rs = np.random.RandomState(size)
    shape = (2, size, size, 3) if ordering == "tf" else (2, 3, size, size)
    kw = dict(bias=True, dim_ordering=ordering)
    t = _port_layer(tconv.SpaceToDepthStemConv(8, **kw), shape)
    params = _rand_like(t.params(), rs, 0.3)
    load_jax_params(t, params)
    x = rs.randn(*shape).astype(np.float32)
    want, _ = jconv.SpaceToDepthStemConv(8, **kw).call(
        _jtree(params), {}, jnp.asarray(x))
    got = t(torch.from_numpy(x)).detach()
    _close(got, want, LAYER_TOL, "stem")
    plain = _port_layer(tconv.Convolution2D(8, 7, 7, subsample=2,
                                            border_mode="same", **kw),
                        shape, params)
    _close(got, plain(torch.from_numpy(x)).detach(), LAYER_TOL, "plain")
    with pytest.raises(ValueError, match="exactly the 7x7"):
        tconv.SpaceToDepthStemConv(8, subsample=1)


@pytest.mark.parametrize("ordering", ["tf", "th"])
def test_separable_conv_matches_jax(ordering):
    rs = np.random.RandomState(7)
    shape = (2, 9, 10, 4) if ordering == "tf" else (2, 4, 9, 10)
    kw = dict(border_mode="same", subsample=(2, 2), depth_multiplier=2,
              dim_ordering=ordering)
    t = _port_layer(tconv.SeparableConvolution2D(6, 3, 3, **kw), shape)
    assert {k: tuple(v.shape) for k, v in t.params().items()} == {
        "depthwise": (3, 3, 1, 8), "pointwise": (1, 1, 8, 6), "bias": (6,)}
    params = _rand_like(t.params(), rs, 0.3)
    load_jax_params(t, params)
    x = rs.randn(*shape).astype(np.float32)
    want, _ = jconv.SeparableConvolution2D(6, 3, 3, **kw).call(
        _jtree(params), {}, jnp.asarray(x))
    got = t(torch.from_numpy(x))
    assert tuple(got.shape) == tuple(t.output_shape(shape))
    _close(got.detach(), want, LAYER_TOL, "separable")


def test_conv_rejects_unknown_modes():
    with pytest.raises(ValueError, match="border_mode"):
        tconv.Convolution2D(2, 3, 3, border_mode="full")
    with pytest.raises(ValueError, match="dim_ordering"):
        tconv.Convolution2D(2, 3, 3, dim_ordering="nchw")


# ---------------------------------------------------------------------------
# pooling and merge


POOL_CASES = [
    ("MaxPooling2D", (3, 3), (2, 2), "same", (9, 7), "tf"),
    ("MaxPooling2D", (3, 3), (2, 2), "same", (112, 112), "tf"),
    ("MaxPooling2D", (2, 2), None, "valid", (9, 7), "th"),
    ("MaxPooling2D", (3, 3), (1, 1), "same", (7, 7), "tf"),
    ("AveragePooling2D", (3, 3), (2, 2), "same", (9, 7), "tf"),
    ("AveragePooling2D", (2, 2), None, "valid", (9, 7), "th"),
    ("MaxPooling1D", 3, 2, "same", (11,), "tf"),
    ("AveragePooling1D", 3, 2, "same", (11,), "th"),
    ("MaxPooling3D", (2, 2, 2), None, "same", (5, 6, 7), "tf"),
    ("AveragePooling3D", (3, 3, 3), (2, 2, 2), "same", (5, 6, 7), "tf"),
]


@pytest.mark.parametrize("cls,pool,strides,border,dims,ordering",
                         POOL_CASES)
def test_pooling_matches_jax(cls, pool, strides, border, dims, ordering):
    """Max pooling pads SAME with -inf asymmetrically (the 3x3/s2 pool on
    112 pads (0, 1)); a SAME average divides by the real elements; both
    within 1e-6."""
    rs = np.random.RandomState(len(dims) * 31 + dims[0])
    c = 3
    shape = ((2,) + dims + (c,)) if ordering == "tf" else (2, c) + dims
    args = ((pool, strides) if not cls.endswith("1D")
            else (pool,) + ((strides,) if strides else ()))
    kw = dict(border_mode=border, dim_ordering=ordering)
    t = getattr(tpool, cls)(*args, **kw)
    x = (rs.randn(*shape) - 1.0).astype(np.float32)   # mostly negative
    want, _ = getattr(jpool, cls)(*args, **kw).call({}, {}, jnp.asarray(x))
    got = t(torch.from_numpy(x))
    assert tuple(got.shape) == tuple(t.output_shape(shape))
    _close(got, want, 1e-6, cls)


@pytest.mark.parametrize("cls,ordering", [
    ("GlobalMaxPooling2D", "tf"), ("GlobalAveragePooling2D", "th"),
    ("GlobalMaxPooling3D", "th"), ("GlobalAveragePooling3D", "tf"),
    ("GlobalAveragePooling1D", "th"), ("GlobalMaxPooling1D", "tf")])
def test_global_pooling_matches_jax(cls, ordering):
    rs = np.random.RandomState(3)
    spatial = int(cls[-2])
    dims = (5, 6, 7)[:spatial]
    shape = ((2,) + dims + (4,)) if ordering == "tf" else (2, 4) + dims
    x = rs.randn(*shape).astype(np.float32)
    t = getattr(tpool, cls)(dim_ordering=ordering)
    want, _ = getattr(jpool, cls)(dim_ordering=ordering).call(
        {}, {}, jnp.asarray(x))
    got = t(torch.from_numpy(x))
    assert tuple(got.shape) == tuple(t.output_shape(shape)) == (2, 4)
    _close(got, want, 1e-6, cls)


@pytest.mark.parametrize("mode", ["concat", "sum"])
def test_merge_on_4d_tensors(mode):
    """Inception's channel concat and ResNet's residual sum on NHWC."""
    rs = np.random.RandomState(4)
    xs = [rs.randn(2, 5, 5, c).astype(np.float32)
          for c in ((3, 4, 2) if mode == "concat" else (3, 3, 3))]
    t = TMerge(mode=mode, concat_axis=-1)
    want, _ = JMerge(mode=mode, concat_axis=-1).call(
        {}, {}, *[jnp.asarray(x) for x in xs])
    got = t(*[torch.from_numpy(x) for x in xs])
    assert tuple(got.shape) == t.output_shape(*[x.shape for x in xs])
    _close(got, want, 1e-6, mode)


# ---------------------------------------------------------------------------
# the builders


def _random_weights(net, seed):
    rs = np.random.RandomState(seed)
    params = _rand_like(net.params(), rs, 0.05)
    for name, sub in params.items():
        if "gamma" in sub:
            sub["gamma"] = (1.0 + 0.1 * rs.randn(*sub["gamma"].shape)
                            ).astype(np.float32)
    state = {name: ({"moving_mean": (0.1 * rs.randn(*s["moving_mean"].shape)
                                     ).astype(np.float32),
                     "moving_var": (0.5 + rs.rand(*s["moving_var"].shape)
                                    ).astype(np.float32)} if s else {})
             for name, s in net.state().items()}
    return params, state


def _pair(builder, *args, seed=0, **kw):
    """The JAX and the port net from one builder, the port's with seeded
    weights and state, which the JAX net takes as its trees."""
    from analytics_zoo_tpu.models import image as jimage

    jax_reset_names()
    jnet = getattr(jimage, builder)(*args, **kw)
    reset_name_scope()
    tnet = getattr(timage, builder)(*args, **kw)
    params, state = _random_weights(tnet, seed)
    load_jax_params(tnet, params, state)
    return jnet, tnet, params, state


# ResNet-50's eval forward is held at full depth by the serving tests
# below and by test_torch_port_image_training.py
BUILDER_CASES = [
    ("inception_v1", (7, (64, 64, 3)), {}),
    ("mobilenet", (5, (64, 64, 3)), {"alpha": 0.25}),
    ("vgg16", (4, (32, 32, 3)), {}),
]


@pytest.mark.parametrize("builder,args,kw", BUILDER_CASES)
def test_builders_eval_forward_match_jax(builder, args, kw):
    """Inception-v1, MobileNet and VGG-16 make the JAX graph (the same
    layer names, leaves and state leaves) and their eval forward
    matches, within 1e-4."""
    jnet, tnet, params, state = _pair(builder, *args, **kw)
    x = np.random.RandomState(1).randn(2, *args[1]).astype(np.float32)
    want, _ = jax.jit(lambda p, s, x: jnet.call(p, s, x, training=False))(
        _jtree(params), _jtree(state), jnp.asarray(x))
    tnet.eval()
    with torch.no_grad():
        got = tnet(torch.from_numpy(x))
    assert got.shape == (2, args[0])
    _close(got, want, NET_TOL, builder)


def test_resnet50_width_and_image_classifier():
    """ResNet-50 at ImageNet's width: 25,557,032 parameters and 53,120
    state values; ImageClassifier registers and wraps the builders, and
    its host image pipeline (``preprocessing``, ``predict_image_set``)
    answers as the JAX classifier's from the same weights: the same
    preprocessed pixels within 1e-5 (uint8 images whose short side is
    the chain's scale, so no resize rounds; float32 images resized
    within 1e-5) and the same top-2 classes."""
    reset_name_scope()
    net = timage.resnet50()
    assert sum(p.numel() for p in net.parameters()) == 25_557_032
    assert sum(t.numel() for s in net.state().values()
               for t in s.values()) == 53_120
    assert isinstance(net.subtree("stem_conv"), tconv.SpaceToDepthStemConv)
    from analytics_zoo_tpu_torch.models.common import _MODEL_REGISTRY

    clf = timage.ImageClassifier("mobilenet", class_num=3,
                                 input_shape=(32, 32, 3), device="cpu")
    assert _MODEL_REGISTRY["ImageClassifier"] is timage.ImageClassifier
    assert clf.config() == {"model_name": "mobilenet", "class_num": 3,
                            "input_shape": [32, 32, 3]}
    from analytics_zoo_tpu.data.image import ImageSet as JImageSet
    from analytics_zoo_tpu.models.image import ImageClassifier as JClf
    from analytics_zoo_tpu.train.optimizers import SGD as JSGD
    from analytics_zoo_tpu_torch.data.image import ImageSet

    rs = np.random.RandomState(4)
    imgs = [rs.randint(0, 256, hw + (3,)).astype(np.uint8)
            for hw in ((36, 48), (40, 36), (36, 36))]
    imgs += [(rs.rand(*hw, 3) * 255).astype(np.float32)
             for hw in ((50, 61), (45, 39))]
    jax_reset_names()
    jclf = JClf("mobilenet", class_num=3, input_shape=(32, 32, 3))
    params, state = _random_weights(clf.model, 5)
    load_jax_params(clf.model, params, state)
    ce = "sparse_categorical_crossentropy_with_logits"
    jclf.model.compile(optimizer=JSGD(0.1), loss=ce)
    jp, js = jax.eval_shape(lambda k: jclf.model.build(k, (1, 32, 32, 3)),
                            jax.random.PRNGKey(0))
    jclf.model.estimator.params = {}
    jclf.model.estimator.set_initial_weights(
        {k: params.get(k, {}) for k in jp}, {k: state.get(k, {}) for k in js})
    clf.compile("sgd", ce)
    want_x, _ = JImageSet.from_arrays(imgs).transform(
        jclf.preprocessing()).to_arrays()
    got_x, _ = ImageSet.from_arrays(imgs).transform(
        clf.preprocessing()).to_arrays()
    _close(got_x, want_x, 1e-5, "preprocessed")
    np.testing.assert_array_equal(got_x[:3], want_x[:3])
    want = jclf.predict_image_set(JImageSet.from_arrays(imgs), batch_size=4,
                                  top_k=2)
    got = clf.predict_image_set(ImageSet.from_arrays(imgs), batch_size=4,
                                top_k=2)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown model"):
        timage.ImageClassifier("resnet-18", device="cpu")


# ---------------------------------------------------------------------------
# serving


@pytest.fixture(scope="module")
def resnet_pair():
    return _pair("resnet50", 10, (32, 32, 3), seed=3)


def _images(n, seed):
    return np.random.RandomState(seed).randint(
        0, 256, (n, 32, 32, 3)).astype(np.uint8)


def _host_tree(tree):
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    return tree.numpy() if isinstance(tree, torch.Tensor) else tree


def test_quantize_pytree_conv_and_bn_leaves_bit_identical(resnet_pair):
    """The port's ``quantize_pytree`` on 4-D conv kernels (int8 per output
    channel), a 2048-channel BN gamma and beta (one scale each) and the fc
    head (int8, and packed int4) gives the JAX package's bits."""
    from analytics_zoo_tpu.deploy.inference import quantize_pytree as jq
    from analytics_zoo_tpu_torch.deploy.inference import quantize_pytree

    _, _, params, _ = resnet_pair
    for bits, sub in ((8, {"s3b2_c_bn": params["s3b2_c_bn"],
                           "s0b0_a_conv": params["s0b0_a_conv"],
                           "fc": params["fc"]}),
                      (4, {"fc": params["fc"]})):
        want = jq(sub, bits=bits)
        got = _host_tree(quantize_pytree(sub, bits=bits))
        flat_w, _ = jax.tree_util.tree_flatten_with_path(want)
        flat_g, _ = jax.tree_util.tree_flatten_with_path(got)
        assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
        for (path, w), (_, g) in zip(flat_w, flat_g):
            np.testing.assert_array_equal(g, np.asarray(w),
                                          err_msg=f"int{bits} {path}")
        assert set(got["fc"]["kernel"]) == {"q4" if bits == 4 else "q",
                                            "scale"}
    conv = quantize_pytree({"c": params["s0b0_a_conv"]})["c"]["kernel"]
    assert conv["q"].shape == (1, 1, 64, 64)
    assert conv["scale"].shape == (1, 1, 1, 64)


@pytest.mark.parametrize("weight_dtype", ["float32", "int8", "int4"])
def test_resnet_serving_matches_jax(resnet_pair, weight_dtype, monkeypatch):
    """ResNet-50 served in f32, int8 and int4 weights (conv kernels int8
    per output channel, the 1024/2048-channel BN gamma/beta int8, the fc
    head int8 or packed int4 through the dequantize-matmul) against the
    JAX serving forward from the same trees, within 1e-4; the state is
    applied and never quantized.  The JAX side is handed the port's
    quantized tree (bit-identical, as the test above holds on every kind
    of leaf): quantizing 160 leaves eagerly in JAX costs 18 s here."""
    import analytics_zoo_tpu.deploy.inference as jinf
    from analytics_zoo_tpu_torch.deploy.inference import quantize_pytree

    jnet, tnet, params, state = resnet_pair
    monkeypatch.setattr(jinf, "quantize_pytree", lambda p, bits=8: _jtree(
        _host_tree(quantize_pytree(params, bits=bits))))
    x = (_images(5, 1).astype(np.float32) / 127.5 - 1.0)
    want = JaxIM.from_keras_net(jnet, _jtree(params), _jtree(state),
                                weight_dtype=weight_dtype).predict(x)
    m = InferenceModel.from_keras_net(tnet, params, state, device="cpu",
                                      weight_dtype=weight_dtype,
                                      batch_buckets=(1, 8))
    got = m.predict(x)
    _close(got, want, NET_TOL, weight_dtype)
    served = m.params()
    if weight_dtype != "float32":
        assert set(served["fc"]["kernel"]) == (
            {"q4", "scale"} if weight_dtype == "int4" else {"q", "scale"})
        assert set(served["s3b2_c_bn"]["gamma"]) == {"q", "scale"}
        assert set(served["s1b0_a_conv"]["kernel"]) == {"q", "scale"}
    st = m._net.state()
    for layer, leaves in state.items():
        for leaf, v in leaves.items():
            np.testing.assert_array_equal(st[layer][leaf].numpy(), v)


def test_resnet_uint8_wire_serves_bf16_like_jax(resnet_pair):
    """uint8 images normalized on the card by ``imagenet_preprocess``
    select bf16 inference (params and state cast inside the program,
    logits back in f32), against the JAX package's bf16 serving forward:
    logits within 0.1 of the largest, top-1 on 7 rows of 8 at least."""
    jnet, tnet, params, state = resnet_pair
    x = _images(8, 2)
    want = np.asarray(JaxIM.from_keras_net(
        jnet, _jtree(params), _jtree(state),
        preprocess=jax_imagenet_preprocess()).predict(x))
    m = InferenceModel.from_keras_net(tnet, params, state, device="cpu",
                                      preprocess=imagenet_preprocess(),
                                      batch_buckets=(8,))
    got = m.predict(x)
    assert got.dtype == np.float32
    _close(got, want, BF16_TOL, "bf16")
    assert np.sum(got.argmax(-1) == want.argmax(-1)) >= 7
    # the f32 weights stay f32 in the served net
    assert all(p.dtype == torch.float32 for p in m._net.parameters())
    f32 = InferenceModel.from_keras_net(tnet, params, state, device="cpu")
    ref = f32.predict(x.astype(np.float32) / 127.5 - 1.0)
    assert np.abs(got - ref).max() > 0          # it did run in bf16


def test_imagenet_preprocess_matches_jax():
    x = _images(2, 3)
    want = np.asarray(jax_imagenet_preprocess()(jnp.asarray(x)),
                      np.float32)
    got = imagenet_preprocess()(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_from_keras_net_takes_state_third(resnet_pair):
    """The JAX signature ``from_keras_net(net, params, state)``: the
    state is applied and the model serves float32 (a state dict in the
    third place once landed in ``int8``), equal to the net's own eval
    forward with that state; another state answers otherwise and has
    another fingerprint; a state leaf of the wrong shape raises, naming
    its path."""
    _, tnet, params, state = resnet_pair
    x = _images(3, 4).astype(np.float32) / 127.5 - 1.0
    m = InferenceModel.from_keras_net(tnet, params, state, device="cpu",
                                      batch_buckets=(4,))
    assert m._weight_dtype == "float32"
    assert all(p.dtype == torch.float32 for p in m._net.parameters())
    tnet.eval()
    with torch.no_grad():
        want = tnet(torch.from_numpy(x)).numpy()
    _close(m.predict(x), want, 1e-6, "state third")
    fresh = {k: ({"moving_mean": np.zeros_like(v["moving_mean"]),
                  "moving_var": np.ones_like(v["moving_var"])} if v else {})
             for k, v in state.items()}
    other = InferenceModel.from_keras_net(tnet, params, fresh, device="cpu",
                                          batch_buckets=(4,))
    assert np.abs(other.predict(x) - want).max() > 1e-3
    assert m.fingerprint() != other.fingerprint()
    bad = {k: dict(v) for k, v in state.items()}
    bad["s0b0_a_bn"]["moving_mean"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="s0b0_a_bn.moving_mean"):
        InferenceModel.from_keras_net(tnet, params, bad, device="cpu")


# ---------------------------------------------------------------------------
# metric and archives


def test_top5_accuracy_matches_jax():
    rs = np.random.RandomState(6)
    scores = rs.randn(37, 12).astype(np.float32)
    labels = rs.randint(0, 12, 37).astype(np.int32)
    for zero_based in (True, False):
        lab = labels if zero_based else labels + 1
        j = jmetrics.get("top5accuracy")
        j.zero_based = zero_based
        t = tmetrics.get("top5accuracy")
        t.zero_based = zero_based
        want = j.finalize(j.update(jnp.asarray(lab), jnp.asarray(scores)))
        got = t.finalize(t.update(torch.from_numpy(lab),
                                  torch.from_numpy(scores)))
        assert t.name == j.name == "top5_accuracy"
        assert float(got) == pytest.approx(float(want), abs=1e-7)


def test_save_weights_with_state_across_packages(tmp_path, resnet_pair):
    """``save_weights`` writes the state beside the params, in the JAX
    package's archive layout (the same leaf keys, dtypes, shapes and
    CRC32s as the JAX ``save_weights`` of the same trees: every manifest
    entry but the tree structure, which the JAX package pickles); a JAX
    archive's state loads into the port net (``load_weights`` applies
    it)."""
    import json

    jnet, tnet, params, state = resnet_pair
    tnet.save_weights(str(tmp_path / "port.npz"))
    jnet.save_weights(str(tmp_path / "same.npz"), params, state)
    manifests = []
    for name in ("port.npz", "same.npz"):
        with np.load(tmp_path / name) as z:
            m = json.loads(z["__manifest__"].tobytes())
        m["leaves"].pop("__treedef__")
        manifests.append(m)
    assert manifests[0] == manifests[1]
    assert any(k.endswith("|state/stem_bn/moving_var")
               for k in manifests[0]["leaves"])
    back = {k: ({"moving_mean": v["moving_mean"] + 1.0,
                 "moving_var": v["moving_var"] * 2.0} if v else {})
            for k, v in state.items()}
    jpath = str(tmp_path / "jax.npz")
    jnet.save_weights(jpath, params, back)
    reset_name_scope()
    other = timage.resnet50(10, (32, 32, 3))
    _, got_state = other.load_weights(jpath)
    got = export_state(other)
    for layer, leaves in back.items():
        for leaf, v in leaves.items():
            np.testing.assert_array_equal(got[layer][leaf], v)
            np.testing.assert_array_equal(got_state[layer][leaf], v)
    np.testing.assert_array_equal(export_params(other)["fc"]["kernel"],
                                  params["fc"]["kernel"])
