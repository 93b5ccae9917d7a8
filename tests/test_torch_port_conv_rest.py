"""The rest of the convolutional layers (``Deconvolution2D``, the locally
connected layers, ZeroPadding, Cropping, UpSampling, ``ResizeBilinear``,
``ShareConvolution2D``) and the local response normalizations
(``LRN2D``, ``WithinChannelLRN2D``) of the PyTorch port against the JAX
package's layers on the CPU, forward and gradient, in both
``dim_ordering``s where the layer takes one.

Weights come from ``np.random.RandomState`` in the JAX tree's shapes and
reach the port through ``convert.load_jax_params``; the JAX layer runs
its ``forward`` and ``jax.grad`` of ``sum(forward * g)`` for a seeded
``g``, the port its forward and autograd.  Tolerances, with their
reasons:

- outputs and gradients within 1e-5 of the largest |JAX value|: f32 sums
  of a few dozen products (a convolution, a locally connected patch, a
  window of squares) in another order;
- padding, cropping and upsampling move values without arithmetic, and
  their forward and gradient are held exactly;
- ``ResizeBilinear`` shrinking (``jax.image.resize``'s antialiased
  triangle filter against ``F.interpolate(antialias=True)``): within
  1e-5 as well, both weigh the same taps with normalised weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.nn.layers import convolutional as jconv
from analytics_zoo_tpu.nn.layers import normalization as jnorm

from analytics_zoo_tpu_torch.convert import load_jax_params
from analytics_zoo_tpu_torch.nn import layers as tlayers
from analytics_zoo_tpu_torch.nn.layers import convolutional as tconv
from analytics_zoo_tpu_torch.nn.layers import normalization as tnorm

TOL = 1e-5


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if tol == 0:
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()),
                               err_msg=what)


def _pair_check(jlayer, tlayer, x_shape, seed=0, tol=TOL, scale=0.3):
    """Forward and the gradients of ``sum(y * g)`` (input and every
    leaf) of the two layers on the same seeded input and weights."""
    rs = np.random.RandomState(seed)
    x = rs.randn(*x_shape).astype(np.float32)
    tlayer.build(torch.Generator().manual_seed(0), x_shape)
    params = {k: (rs.randn(*v.shape) * scale).astype(np.float32)
              for k, v in tlayer.params().items()}
    load_jax_params(tlayer, params)
    assert tuple(tlayer.output_shape(x_shape)) == tuple(
        np.asarray(jlayer.forward(params, jnp.asarray(x))).shape)
    want = np.asarray(jlayer.forward(params, jnp.asarray(x)))
    g = rs.randn(*want.shape).astype(np.float32)
    jgp, jgx = jax.grad(lambda p, v: jnp.sum(jlayer.forward(p, v) * g),
                        argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tlayer(xt)
    _close(got.detach(), want, tol, "forward")
    (got * torch.from_numpy(g)).sum().backward()
    _close(xt.grad, jgx, tol, "input gradient")
    for k in params:
        _close(tlayer._parameters[k].grad, jgp[k], tol, f"{k} gradient")
    return got


DECONV_CASES = [
    # (ordering, border, kernel, stride, input spatial)
    ("tf", "same", (3, 3), (2, 2), (5, 7)),
    ("th", "same", (3, 3), (2, 2), (5, 7)),
    ("tf", "valid", (3, 3), (2, 2), (5, 7)),
    ("th", "valid", (3, 3), (2, 2), (5, 7)),
    ("tf", "same", (2, 2), (2, 2), (4, 5)),
    ("tf", "valid", (2, 2), (3, 3), (3, 4)),
    ("tf", "same", (3, 2), (1, 2), (5, 6)),
    ("th", "valid", (4, 4), (1, 1), (3, 5)),
]


@pytest.mark.parametrize("ordering,border,kernel,stride,hw", DECONV_CASES)
def test_deconvolution2d_matches_jax(ordering, border, kernel, stride, hw):
    """``lax.conv_transpose`` (no kernel flip, its own SAME / VALID
    padding), stride 2 on odd sizes included, with bias and an
    activation."""
    kw = dict(subsample=stride, border_mode=border, dim_ordering=ordering,
              activation="tanh")
    shape = (2,) + hw + (3,) if ordering == "tf" else (2, 3) + hw
    _pair_check(jconv.Deconvolution2D(4, *kernel, **kw),
                tconv.Deconvolution2D(4, *kernel, **kw), shape)


@pytest.mark.parametrize("stride,bias", [(1, True), (2, False), (3, True)])
def test_locally_connected1d_matches_jax(stride, bias):
    kw = dict(subsample_length=stride, bias=bias, activation="relu")
    _pair_check(jconv.LocallyConnected1D(5, 3, **kw),
                tconv.LocallyConnected1D(5, 3, **kw), (3, 11, 4))


@pytest.mark.parametrize("ordering,stride", [("tf", (1, 1)), ("th", (1, 1)),
                                             ("tf", (2, 1)), ("th", (2, 2))])
def test_locally_connected2d_matches_jax(ordering, stride):
    kw = dict(subsample=stride, dim_ordering=ordering)
    shape = (2, 7, 6, 3) if ordering == "tf" else (2, 3, 7, 6)
    _pair_check(jconv.LocallyConnected2D(4, 3, 2, **kw),
                tconv.LocallyConnected2D(4, 3, 2, **kw), shape)


def test_locally_connected_refuse_same_padding():
    for cls in (tconv.LocallyConnected1D,):
        with pytest.raises(ValueError, match="valid"):
            cls(2, 3, border_mode="same")
    with pytest.raises(ValueError, match="valid"):
        tconv.LocallyConnected2D(2, 3, 3, border_mode="same")


def _spatial_shape(ordering, spatial, c=3):
    sizes = (5, 6, 4)[:spatial]
    return (2,) + sizes + (c,) if ordering == "tf" else (2, c) + sizes


SHAPE_CASES = [
    ("ZeroPadding1D", (2,), {}),
    ("ZeroPadding2D", ((1, 2),), {}),
    ("ZeroPadding3D", (1,), {}),
    ("Cropping1D", ((1, 2),), {}),
    ("Cropping2D", ((1, 0), (2, 1)), {}),
    ("Cropping2D", ((0, 5), (1, 1)), {}),     # size - after == 0
    ("Cropping3D", ((1, 1), (0, 2), (1, 0)), {}),
    ("UpSampling1D", (3,), {}),
    ("UpSampling2D", ((2, 3),), {}),
    ("UpSampling3D", ((1, 2, 2),), {}),
]


@pytest.mark.parametrize("ordering", ["tf", "th"])
@pytest.mark.parametrize("name,args,kw", SHAPE_CASES)
def test_padding_cropping_upsampling_match_jax_exactly(name, args, kw,
                                                       ordering):
    spatial = int(name[-2])
    if spatial == 1 and ordering == "th":
        # the JAX 1-D layers take dim_ordering too: (B, C, L)
        pass
    jl = getattr(jconv, name)(*args, dim_ordering=ordering, **kw)
    tl = getattr(tconv, name)(*args, dim_ordering=ordering, **kw)
    _pair_check(jl, tl, _spatial_shape(ordering, spatial), tol=0)


RESIZE_CASES = [
    # (in hw, out hw, align_corners)
    ((6, 8), (3, 4), False),      # shrink: antialiased
    ((5, 7), (11, 9), False),     # enlarge
    ((9, 4), (4, 10), False),     # one dim each way
    ((6, 8), (3, 4), True),
    ((5, 7), (11, 9), True),
]


@pytest.mark.parametrize("ordering", ["tf", "th"])
@pytest.mark.parametrize("hw,out,align", RESIZE_CASES)
def test_resize_bilinear_matches_jax(hw, out, align, ordering):
    kw = dict(align_corners=align, dim_ordering=ordering)
    shape = (2,) + hw + (3,) if ordering == "tf" else (2, 3) + hw
    _pair_check(jconv.ResizeBilinear(*out, **kw),
                tconv.ResizeBilinear(*out, **kw), shape)


@pytest.mark.parametrize("ordering", ["tf", "th"])
def test_share_convolution2d_is_convolution2d(ordering):
    kw = dict(border_mode="same", dim_ordering=ordering, subsample=(2, 2))
    shape = (2, 7, 6, 3) if ordering == "tf" else (2, 3, 7, 6)
    _pair_check(jconv.ShareConvolution2D(4, 3, 3, **kw),
                tconv.ShareConvolution2D(4, 3, 3, **kw), shape)
    assert issubclass(tconv.ShareConvolution2D, tconv.Convolution2D)


@pytest.mark.parametrize("ordering", ["tf", "th"])
@pytest.mark.parametrize("n", [5, 4, 1])
def test_lrn2d_matches_jax(ordering, n):
    """The channel window padded (n // 2, n - 1 - n // 2): uneven for an
    even n."""
    kw = dict(alpha=0.3, k=1.5, beta=0.75, n=n, dim_ordering=ordering)
    shape = (2, 4, 5, 7) if ordering == "tf" else (2, 7, 4, 5)
    _pair_check(jnorm.LRN2D(**kw), tnorm.LRN2D(**kw), shape)


@pytest.mark.parametrize("size", [3, 4])
def test_within_channel_lrn2d_matches_jax(size):
    """Always NHWC, a SAME window over H and W."""
    kw = dict(size=size, alpha=0.8, beta=0.6)
    _pair_check(jnorm.WithinChannelLRN2D(**kw),
                tnorm.WithinChannelLRN2D(**kw), (2, 6, 5, 3))


def test_new_layers_are_exported_like_jax():
    from analytics_zoo_tpu.nn import layers as jlayers

    for name in ("Deconvolution2D", "LocallyConnected1D",
                 "LocallyConnected2D", "ZeroPadding1D", "ZeroPadding2D",
                 "ZeroPadding3D", "Cropping1D", "Cropping2D", "Cropping3D",
                 "UpSampling1D", "UpSampling2D", "UpSampling3D",
                 "ResizeBilinear", "ShareConvolution2D", "Conv1D",
                 "Conv2D", "Conv3D", "LRN2D", "WithinChannelLRN2D"):
        assert hasattr(jlayers, name), name
        assert hasattr(tlayers, name), name


def test_deconvolution_in_a_graph_model_loads_jax_params():
    """A graph model with a Deconvolution2D and a LocallyConnected2D
    takes the JAX tree (their kernel and locally connected weights) by
    name through ``load_jax_params`` and answers as the JAX model."""
    from analytics_zoo_tpu.nn import Input as JInput, Model as JModel
    from analytics_zoo_tpu.nn import reset_name_scope as jreset
    from analytics_zoo_tpu_torch.nn import Input as TInput, Model as TModel
    from analytics_zoo_tpu_torch.nn import reset_name_scope as treset

    def build(I, M, conv):
        x = I(shape=(6, 5, 3))
        y = conv.Deconvolution2D(4, 3, 3, subsample=(2, 2),
                                 border_mode="same", name="deconv")(x)
        y = conv.LocallyConnected2D(2, 3, 3, subsample=(2, 2),
                                    name="lc")(y)
        return M(x, y)

    jreset()
    jm = build(JInput, JModel, jconv)
    treset()
    tm = build(TInput, TModel, tconv)
    tm.build(torch.Generator().manual_seed(0))
    rs = np.random.RandomState(4)
    params = {ln: {k: (rs.randn(*v.shape) * 0.3).astype(np.float32)
                   for k, v in leaves.items()}
              for ln, leaves in tm.params().items()}
    load_jax_params(tm, params)
    x = rs.randn(2, 6, 5, 3).astype(np.float32)
    _, jstate = jm.build(jax.random.PRNGKey(0), (2, 6, 5, 3))
    want, _ = jm.call(jax.tree_util.tree_map(jnp.asarray, params), jstate,
                      jnp.asarray(x), training=False)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _close(got, want, TOL, "graph model")
