"""The port's layer vocabulary against the JAX package: every merge mode
and merge class, the advanced activations, the torch-style layers, the
Keras-2 classes, and ``WordEmbedding`` / ``SparseEmbedding`` /
``SparseDense``.

Each case builds the layer in both packages, draws its weights with
``np.random.RandomState`` in the JAX tree's shapes (loaded into the port
with ``load_jax_params``), and runs both on the same seeded inputs in
inference mode: the forward, and, where the output is a float the JAX
layer differentiates, the gradients of a seeded projection of the output
with respect to every float input and every leaf.  The noise layers'
training draws are not ``jax.random``'s bits: they are held to their law
(mean, spread, whole dropped channels) and to the JAX layers' refusal to
train without a generator.  Everything runs on the CPU.

Tolerances: forwards within atol 2e-6 and rtol 1e-6, gradients within
atol 2e-5 and rtol 1e-5 (f32 sums of a few hundred terms at most, in
other orders); integer outputs exactly.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu.nn.keras2 as jk2
import analytics_zoo_tpu.nn.layers as jlayers
from analytics_zoo_tpu.data.text import load_glove_embeddings as jax_glove
from analytics_zoo_tpu.nn import reset_name_scope as jax_reset_names

import analytics_zoo_tpu_torch.nn.keras2 as tk2
import analytics_zoo_tpu_torch.nn.layers as tlayers
from analytics_zoo_tpu_torch.convert import load_jax_params
from analytics_zoo_tpu_torch.data.text import load_glove_embeddings
from analytics_zoo_tpu_torch.nn import Sequential, reset_name_scope

FWD_ATOL, FWD_RTOL = 2e-6, 1e-6
GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-5

X = (3, 4, 5)


# name -> (maker(layers namespace), input shapes, input kind, gradient)
# kinds: "any" N(0, 1); "pos" U(0.5, 2); ("ids", V) ints in [0, V);
# ("pad_ids", V) ints in [0, V) with about a third of them 0
CASES = {
    # merge modes and classes
    **{f"merge_{m}_{n}": ((lambda L, m=m: L.Merge(mode=m)), [X] * n, "any",
                          True)
       for m in ("concat", "sum", "mul", "ave", "max", "min")
       for n in (2, 3)},
    "merge_concat_axis1": (lambda L: L.Merge(mode="concat", concat_axis=1),
                           [(3, 2, 5), (3, 4, 5)], "any", True),
    "merge_dot": (lambda L: L.Merge(mode="dot"), [X] * 2, "any", True),
    "merge_cos": (lambda L: L.Merge(mode="cos"), [X] * 2, "any", True),
    "concatenate": (lambda L: L.Concatenate(axis=1), [(3, 2, 5), X], "any",
                    True),
    "add": (lambda L: L.Add(), [X] * 3, "any", True),
    "multiply": (lambda L: L.Multiply(), [X] * 2, "any", True),
    "average": (lambda L: L.Average(), [X] * 3, "any", True),
    "maximum": (lambda L: L.Maximum(), [X] * 2, "any", True),
    "minimum": (lambda L: L.Minimum(), [X] * 2, "any", True),
    # advanced activations (the noise layers in inference)
    "leaky_relu": (lambda L: L.LeakyReLU(0.2), [X], "any", True),
    "elu": (lambda L: L.ELU(0.7), [X], "any", True),
    "thresholded_relu": (lambda L: L.ThresholdedReLU(0.3), [X], "any",
                         True),
    "prelu": (lambda L: L.PReLU(), [X], "any", True),
    "srelu": (lambda L: L.SReLU(), [X], "any", True),
    "gaussian_noise": (lambda L: L.GaussianNoise(0.3), [X], "any", True),
    "gaussian_dropout": (lambda L: L.GaussianDropout(0.3), [X], "any",
                         True),
    "spatial_dropout1d": (lambda L: L.SpatialDropout1D(0.4), [X], "any",
                          True),
    "spatial_dropout2d": (lambda L: L.SpatialDropout2D(0.4), [(2, 3, 4, 5)],
                          "any", True),
    "spatial_dropout3d": (lambda L: L.SpatialDropout3D(0.4),
                          [(2, 2, 3, 4, 5)], "any", True),
    "rrelu": (lambda L: L.RReLU(), [X], "any", True),
    # torch-style layers
    "square": (lambda L: L.Square(), [X], "any", True),
    "sqrt": (lambda L: L.Sqrt(), [X], "pos", True),
    "log": (lambda L: L.Log(), [X], "pos", True),
    "exp": (lambda L: L.Exp(), [X], "any", True),
    "negative": (lambda L: L.Negative(), [X], "any", True),
    "identity": (lambda L: L.Identity(), [X], "any", True),
    "power": (lambda L: L.Power(2.5, scale=0.5, shift=1.0), [X], "pos",
              True),
    "add_constant": (lambda L: L.AddConstant(1.5), [X], "any", True),
    "mul_constant": (lambda L: L.MulConstant(-2.0), [X], "any", True),
    "hard_tanh": (lambda L: L.HardTanh(-0.5, 0.8), [X], "any", True),
    "hard_shrink": (lambda L: L.HardShrink(0.3), [X], "any", True),
    "soft_shrink": (lambda L: L.SoftShrink(0.3), [X], "any", True),
    "threshold": (lambda L: L.Threshold(0.1, -1.0), [X], "any", True),
    "binary_threshold": (lambda L: L.BinaryThreshold(0.2), [X], "any",
                         False),
    "cadd": (lambda L: L.CAdd((1, 5)), [X], "any", True),
    "cadd_broadcast_up": (lambda L: L.CAdd((2, 1, 4, 5)), [X], "any", True),
    "cmul": (lambda L: L.CMul((4, 1)), [X], "any", True),
    "mul": (lambda L: L.Mul(), [X], "any", True),
    "scale": (lambda L: L.Scale((4, 5)), [X], "any", True),
    "select": (lambda L: L.Select(1, -1), [X], "any", True),
    "narrow": (lambda L: L.Narrow(2, 1, 3), [X], "any", True),
    "narrow_to_end": (lambda L: L.Narrow(-1, -3, -1), [X], "any", True),
    "squeeze_all": (lambda L: L.Squeeze(), [(3, 1, 4, 1)], "any", True),
    "squeeze_dim": (lambda L: L.Squeeze(3), [(3, 1, 4, 1)], "any", True),
    "select_table": (lambda L: L.SelectTable(1), [X, (3, 2)], "any", True),
    "max": (lambda L: L.Max(2), [X], "any", True),
    "max_argmax": (lambda L: L.Max(-1, return_value=False), [X], "any",
                   False),
    "expand": (lambda L: L.Expand((-1, 4, 5)), [(3, 1, 5)], "any", True),
    "get_shape": (lambda L: L.GetShape(), [X], "any", False),
    # embeddings and the sparse dense layer
    "sparse_embedding_sum": (lambda L: L.SparseEmbedding(
        11, 4, combiner="sum"), [(5, 6)], ("pad_ids", 11), True),
    "sparse_embedding_mean": (lambda L: L.SparseEmbedding(
        11, 4, combiner="mean"), [(5, 6)], ("pad_ids", 11), True),
    "sparse_embedding_sqrtn": (lambda L: L.SparseEmbedding(
        11, 4, combiner="sqrtn", pad_id=3), [(5, 6)], ("pad_ids", 11), True),
    "sparse_dense": (lambda L: L.SparseDense(6, 13, activation="tanh"),
                     [(4, 5)], ("pad_ids", 13), True),
    "sparse_dense_values": (lambda L: L.SparseDense(6, 13),
                            [(4, 5), (4, 5)], ("pad_ids", 13), True),
    "word_embedding_frozen": (lambda L: L.WordEmbedding(9, 4), [(3, 5)],
                              ("ids", 9), True),
    "word_embedding_trainable": (lambda L: L.WordEmbedding(
        9, 4, trainable=True), [(3, 5)], ("ids", 9), True),
}

# the Keras-2 classes (the namespace ``nn.keras2``)
K2_CASES = {
    "Dense": (lambda K: K.Dense(6, activation="relu"), [(3, 5)], "any"),
    "Conv1D": (lambda K: K.Conv1D(4, 3, padding="same", activation="relu"),
               [(2, 7, 3)], "any"),
    "Conv2D": (lambda K: K.Conv2D(4, (3, 2), strides=(1, 2)),
               [(2, 6, 6, 3)], "any"),
    "Conv3D": (lambda K: K.Conv3D(2, 2), [(1, 3, 4, 4, 2)], "any"),
    "Conv2DTranspose": (lambda K: K.Conv2DTranspose(3, 2, strides=2),
                        [(2, 3, 3, 2)], "any"),
    "SeparableConv2D": (lambda K: K.SeparableConv2D(
        4, 3, depth_multiplier=2, padding="same"), [(2, 5, 5, 3)], "any"),
    "MaxPooling1D": (lambda K: K.MaxPooling1D(2), [(2, 6, 3)], "any"),
    "MaxPooling2D": (lambda K: K.MaxPooling2D((2, 2)), [(2, 4, 4, 3)],
                     "any"),
    "AveragePooling1D": (lambda K: K.AveragePooling1D(3, strides=1),
                         [(2, 6, 3)], "any"),
    "AveragePooling2D": (lambda K: K.AveragePooling2D(2, padding="same"),
                         [(2, 5, 5, 3)], "any"),
    "Embedding": (lambda K: K.Embedding(10, 4), [(3, 5)], ("ids", 10)),
    "BatchNormalization": (lambda K: K.BatchNormalization(), [(4, 6)],
                           "any"),
    "LSTM": (lambda K: K.LSTM(5, return_sequences=True), [(2, 4, 3)],
             "any"),
    "GRU": (lambda K: K.GRU(4), [(2, 4, 3)], "any"),
    "SimpleRNN": (lambda K: K.SimpleRNN(3, return_sequences=True),
                  [(2, 4, 3)], "any"),
    "LeakyReLU": (lambda K: K.LeakyReLU(0.1), [X], "any"),
    "Activation": (lambda K: K.Activation("tanh"), [X], "any"),
    "Dropout": (lambda K: K.Dropout(0.3), [X], "any"),
    "Flatten": (lambda K: K.Flatten(), [X], "any"),
    "Reshape": (lambda K: K.Reshape((20,)), [X], "any"),
    "Permute": (lambda K: K.Permute((2, 1)), [X], "any"),
    "RepeatVector": (lambda K: K.RepeatVector(3), [(2, 4)], "any"),
    "GlobalMaxPooling1D": (lambda K: K.GlobalMaxPooling1D(), [X], "any"),
    "GlobalMaxPooling2D": (lambda K: K.GlobalMaxPooling2D(), [(2, 3, 4, 5)],
                           "any"),
    "GlobalAveragePooling1D": (lambda K: K.GlobalAveragePooling1D(), [X],
                               "any"),
    "GlobalAveragePooling2D": (lambda K: K.GlobalAveragePooling2D(),
                               [(2, 3, 4, 5)], "any"),
    "Add": (lambda K: K.Add(), [X] * 2, "any"),
    "Maximum": (lambda K: K.Maximum(), [X] * 2, "any"),
    "Minimum": (lambda K: K.Minimum(), [X] * 2, "any"),
    "Average": (lambda K: K.Average(), [X] * 2, "any"),
    "Multiply": (lambda K: K.Multiply(), [X] * 2, "any"),
    "Concatenate": (lambda K: K.Concatenate(axis=1), [X] * 2, "any"),
}


def _input(rs, shape, kind, position):
    if kind == "any":
        return rs.randn(*shape).astype(np.float32)
    if kind == "pos":
        return rs.uniform(0.5, 2.0, shape).astype(np.float32)
    if position > 0:                     # SparseDense's values
        return rs.uniform(-1.0, 2.0, shape).astype(np.float32)
    name, vocab = kind
    ids = rs.randint(0, vocab, size=shape).astype(np.int32)
    if name == "pad_ids":
        ids[rs.rand(*shape) < 0.35] = 0
        ids[0] = 0                       # an all-pad row
    return ids


def _numpy_tree(tree, rs, positive=False):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v, rs, positive) for k, v in tree.items()}
    a = np.asarray(rs.randn(*np.shape(tree)) * 0.5, np.float32)
    return np.abs(a) + 0.5 if positive else a


def _pair(make_jax, make_port, shapes, kind, seed):
    jax_reset_names()
    jl = make_jax()
    reset_name_scope()
    tl = make_port()
    rs = np.random.RandomState(seed)
    xs = [_input(rs, s, kind, i) for i, s in enumerate(shapes)]
    pshapes, sshapes = jax.eval_shape(lambda k: jl.init(k, *shapes),
                                      jax.random.PRNGKey(0))
    params = _numpy_tree(pshapes, rs)
    state = _numpy_tree(sshapes, rs, positive=True)
    tl.build(torch.Generator().manual_seed(0), *shapes)
    load_jax_params(tl, params, state or None)
    tl.eval()
    return jl, tl, params, state, xs, rs


def _module_path(prefix):
    return tuple(p for k in prefix for p in ("_tree", k))


def _check(jl, tl, params, state, xs, rs, grad, what):
    floats = [i for i, x in enumerate(xs) if x.dtype == np.float32]

    def jforward(p, fxs):
        args = list(xs)
        for i, f in zip(floats, fxs):
            args[i] = f
        y, _ = jl.call(p, state, *args, training=False, rng=None)
        return y

    want = np.asarray(jax.jit(jforward)(params, [xs[i] for i in floats]))
    txs = [torch.from_numpy(x) for x in xs]
    for i in floats:
        txs[i].requires_grad_(grad)
    got = tl(*txs)
    assert tuple(tl.output_shape(*[x.shape for x in xs])) == want.shape, what
    assert tuple(got.shape) == want.shape, what
    if not np.issubdtype(want.dtype, np.floating):
        assert got.dtype == torch.int32, what
        np.testing.assert_array_equal(got.numpy(), want, err_msg=what)
        return
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=FWD_RTOL,
                               atol=FWD_ATOL, err_msg=what)
    if not grad:
        return
    proj = rs.randn(*want.shape).astype(np.float32)

    def jloss(p, fxs):
        return jnp.sum(jforward(p, fxs) * proj)

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        params, [xs[i] for i in floats])
    names = [n for n, _ in tl.named_parameters()]
    leaves = [p for _, p in tl.named_parameters()]
    wrt = [txs[i] for i in floats] + leaves
    if got.requires_grad:
        grads = torch.autograd.grad((got * torch.from_numpy(proj)).sum(),
                                    wrt, allow_unused=True)
    else:                       # nothing differentiable (a frozen table)
        grads = [None] * len(wrt)
    grads = [torch.zeros(t.shape) if g is None else g
             for g, t in zip(grads, wrt)]
    for g, w in zip(grads, jgx):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=what)
    flat = dict(zip(names, grads[len(floats):]))

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
                continue
            g = flat[".".join(_module_path(prefix) + (k,))]
            np.testing.assert_allclose(g.numpy(), np.asarray(v),
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=f"{what} {prefix + (k,)}")

    walk(jgp, ())


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_matches_jax(case):
    make, shapes, kind, grad = CASES[case]
    pair = _pair(lambda: make(jlayers), lambda: make(tlayers), shapes,
                 kind, zlib.crc32(case.encode()))
    _check(*pair, grad, case)


@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_keras2_class_matches_jax(case):
    make, shapes, kind = K2_CASES[case]
    pair = _pair(lambda: make(jk2), lambda: make(tk2), shapes, kind,
                 zlib.crc32(case.encode()))
    _check(*pair, True, case)


def test_keras2_names_are_the_jax_ones():
    assert tk2.__all__ == jk2.__all__
    for name in tk2.__all__:
        assert hasattr(tk2, name), name


def test_merge_modes_in_a_graph():
    """``merge`` over autograd Variables takes every mode, and the graph's
    output shape is the forward's."""
    from analytics_zoo_tpu_torch.nn import Input, Model

    a, b = Input((4, 5)), Input((4, 5))
    outs = [tlayers.merge([a, b], mode=m) for m in
            ("concat", "sum", "mul", "ave", "max", "min", "dot", "cos")]
    model = Model([a, b], outs)
    model.build(torch.Generator().manual_seed(0))
    x = [torch.randn(2, 4, 5), torch.randn(2, 4, 5)]
    for y, shape in zip(model(*x), model.output_shape((2, 4, 5),
                                                      (2, 4, 5))):
        assert tuple(y.shape) == tuple(shape)
    with pytest.raises(ValueError, match="unknown merge mode"):
        tlayers.Merge(mode="prod")


# ----------------------------------------------------------------------
# the noise layers in training
# ----------------------------------------------------------------------

NOISE = {
    "GaussianNoise": lambda L: L.GaussianNoise(0.5),
    "GaussianDropout": lambda L: L.GaussianDropout(0.3),
    "SpatialDropout1D": lambda L: L.SpatialDropout1D(0.5),
    "SpatialDropout2D": lambda L: L.SpatialDropout2D(0.5),
    "SpatialDropout3D": lambda L: L.SpatialDropout3D(0.5),
}


@pytest.mark.parametrize("name", sorted(NOISE))
def test_noise_layer_needs_a_generator_in_training(name):
    """Training without a generator raises, as the JAX layer does
    without an rng."""
    x = np.ones((2, 3, 4, 5), np.float32)
    jl = NOISE[name](jlayers)
    with pytest.raises(ValueError, match="needs rng"):
        jl.call({}, {}, jnp.asarray(x), training=True, rng=None)
    tl = NOISE[name](tlayers)
    tl.train()
    with pytest.raises(ValueError, match="needs a generator"):
        tl(torch.from_numpy(x))
    tl.eval()
    assert torch.equal(tl(torch.from_numpy(x)), torch.from_numpy(x))


def test_noise_layers_follow_the_jax_law():
    """With a generator, the training draws follow the JAX layers' law:
    GaussianNoise adds N(0, sigma^2); GaussianDropout multiplies by
    N(1, p / (1 - p)); SpatialDropout keeps whole channels with
    probability 1 - p, scaled by 1 / (1 - p); RReLU's negative slope lies
    in [lower, upper].  The JAX layers' draws, from ``jax.random``, are
    held to the same statistics."""
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    n = 200_000
    x = np.ones((n,), np.float32)
    for L, draw in ((tlayers, "port"), (jlayers, "jax")):
        outs = {}
        for name, layer in (("noise", L.GaussianNoise(0.5)),
                            ("gdrop", L.GaussianDropout(0.3))):
            if draw == "port":
                layer.train()
                layer.generator = gen
                outs[name] = layer(torch.from_numpy(x)).numpy()
            else:
                outs[name] = np.asarray(layer.call(
                    {}, {}, jnp.asarray(x), training=True, rng=key)[0])
        assert abs(outs["noise"].mean() - 1.0) < 0.01, draw
        assert abs(outs["noise"].std() - 0.5) < 0.01, draw
        assert abs(outs["gdrop"].mean() - 1.0) < 0.01, draw
        assert abs(outs["gdrop"].std() - (0.3 / 0.7) ** 0.5) < 0.01, draw
    t = tlayers.SpatialDropout2D(0.5)
    t.train()
    t.generator = gen
    y = t(torch.ones(64, 3, 4, 32)).numpy()
    per_map = y.reshape(64, 12, 32)
    assert set(np.unique(y)) <= {0.0, 2.0}
    # a channel is dropped or kept whole across its spatial positions
    assert np.all(per_map.min(axis=1) == per_map.max(axis=1))
    assert 0.4 < (y > 0).mean() < 0.6
    th = tlayers.SpatialDropout2D(0.5, dim_ordering="th")
    th.train()
    th.generator = gen
    y = th(torch.ones(64, 16, 3, 3)).numpy().reshape(64, 16, 9)
    assert np.all(y.min(axis=2) == y.max(axis=2))
    r = tlayers.RReLU(0.1, 0.3)
    r.train()
    r.generator = gen
    slope = (r(-torch.ones(10_000)) / -1.0).numpy()
    assert slope.min() >= 0.1 and slope.max() <= 0.3
    assert abs(slope.mean() - 0.2) < 0.005
    r.generator = None          # no generator: the mean slope, as in JAX
    np.testing.assert_allclose(r(-torch.ones(3)).numpy(), -0.2, rtol=1e-6)


def test_estimator_installs_the_generator_on_noise_layers():
    """``fit`` installs its generator on every layer that draws from it,
    the noise layers among them (training without one would raise), and
    takes it away after."""
    from analytics_zoo_tpu_torch.nn.layers import Dense

    noise = tlayers.GaussianNoise(0.1, input_shape=(6,))
    drop = tlayers.GaussianDropout(0.2)
    net = Sequential([noise, drop, Dense(3)])
    net.compile("sgd", "mse", device="cpu")
    rs = np.random.RandomState(0)
    net.fit(rs.randn(16, 6).astype(np.float32),
            rs.randn(16, 3).astype(np.float32), batch_size=8, nb_epoch=1)
    assert noise.generator is None and drop.generator is None


# ----------------------------------------------------------------------
# GloVe tables
# ----------------------------------------------------------------------

def _write_glove(path, rs, words, dim):
    with open(path, "w", encoding="utf-8") as f:
        for w in words:
            vec = rs.randn(dim).astype(np.float32)
            f.write(w + " " + " ".join(f"{v:.6f}" for v in vec) + "\n")


def test_word_embedding_from_glove_matches_jax(tmp_path):
    """``WordEmbedding.from_glove`` and ``load_glove_embeddings`` read a
    GloVe file the test writes into the JAX package's tables (equal),
    frozen by default; words the file lacks are zero rows; no vocabulary
    word, or another ``dim``, raises."""
    rs = np.random.RandomState(0)
    path = str(tmp_path / "glove.6B.8d.txt")
    _write_glove(path, rs, ["the", "cat", "sat", "on", "mat", "zebra"], 8)
    word_index = {"the": 1, "cat": 2, "sat": 3, "dog": 4, "mat": 5}
    jemb = jlayers.WordEmbedding.from_glove(path, word_index)
    temb = tlayers.WordEmbedding.from_glove(path, word_index)
    np.testing.assert_array_equal(temb.pretrained, jemb.pretrained)
    assert (temb.input_dim, temb.output_dim) == (6, 8)
    assert not temb.trainable and not jemb.trainable
    assert not np.any(temb.pretrained[[0, 4]])
    np.testing.assert_array_equal(load_glove_embeddings(path, word_index),
                                  jax_glove(path, word_index))
    with pytest.raises(ValueError, match="expected 50"):
        load_glove_embeddings(path, word_index, dim=50)
    with pytest.raises(ValueError, match="no vocabulary words"):
        load_glove_embeddings(path, {"dog": 1})
    # the table serves the lookup and takes no gradient when frozen
    temb.build(torch.Generator().manual_seed(0), (2, 3))
    ids = torch.tensor([[1, 2, 4], [5, 0, 3]], dtype=torch.int32)
    out = temb(ids)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  temb.pretrained[ids.numpy()])
    assert not out.requires_grad
    live = tlayers.WordEmbedding.from_glove(path, word_index,
                                            trainable=True)
    live.build(torch.Generator().manual_seed(0), (2, 3))
    assert live(ids).requires_grad
