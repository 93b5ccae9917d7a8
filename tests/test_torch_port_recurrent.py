"""The port's recurrent layers and autograd DSL against the JAX package.

Every recurrent layer of ``nn/layers/recurrent.py`` (SimpleRNN, LSTM,
GRU, Highway, Bidirectional, TimeDistributed, ConvLSTM2D/3D) is built in
both packages under the same name, given the same weights drawn by
``np.random.RandomState`` in the JAX package's tree layout (loaded into
the port with ``load_jax_params``), and run on the same inputs: the
forward with and without ``return_sequences`` and ``go_backwards``, the
gradients of a seeded projection of the output with respect to the input
and every leaf, and the initial-carry hook (``run(x, initial_carry,
return_state=True)``).  Then ``Variable.slice`` and the other operators
and free functions of ``nn/autograd.py``, and ``Parameter`` in a graph.
Everything runs on the CPU.

Tolerances: forwards within atol 2e-6 and gradients within atol 2e-5
plus rtol 1e-5 (f32 sums of at most a few hundred terms in other orders;
an LSTM's or ConvLSTM's gradient passes through T steps of products, each
adding a few ulps); the ``orthogonal`` initializer is held to its law
(orthonormal rows or columns), since the two packages draw different
bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu.nn.autograd as jag
from analytics_zoo_tpu.nn import Model as JaxModel
from analytics_zoo_tpu.nn import reset_name_scope as jax_reset_names
from analytics_zoo_tpu.nn.layers import core as jcore
from analytics_zoo_tpu.nn.layers import recurrent as jrec

import analytics_zoo_tpu_torch.nn.autograd as tag
from analytics_zoo_tpu_torch.convert import load_jax_params
from analytics_zoo_tpu_torch.nn import Model, initializers, reset_name_scope
from analytics_zoo_tpu_torch.nn.layers import core as tcore
from analytics_zoo_tpu_torch.nn.layers import recurrent as trec

FWD_ATOL = 2e-6
GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-5


def _numpy_tree(tree, rs, scale=0.5):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v, rs, scale) for k, v in tree.items()}
    return (rs.randn(*np.shape(tree)) * scale).astype(np.float32)


# (name, maker(module of layers, module of core layers), input shape)
CASES = {
    "simple_rnn_seq_back": (lambda r, c: r.SimpleRNN(
        6, return_sequences=True, go_backwards=True), (3, 5, 4)),
    "lstm": (lambda r, c: r.LSTM(5), (3, 4, 4)),
    "lstm_seq_back": (lambda r, c: r.LSTM(5, return_sequences=True,
                                          go_backwards=True), (3, 4, 4)),
    "gru": (lambda r, c: r.GRU(4), (3, 5, 5)),
    "gru_seq_back_sigmoid": (lambda r, c: r.GRU(
        4, inner_activation="sigmoid", return_sequences=True,
        go_backwards=True), (3, 5, 5)),
    "highway": (lambda r, c: r.Highway(), (4, 6)),
    "bidirectional_concat": (lambda r, c: r.Bidirectional(
        r.LSTM(5, return_sequences=True)), (3, 4, 4)),
    "bidirectional_mul": (lambda r, c: r.Bidirectional(
        r.GRU(4), merge_mode="mul"), (3, 4, 4)),
    "bidirectional_ave": (lambda r, c: r.Bidirectional(
        r.SimpleRNN(4, return_sequences=True), merge_mode="ave"), (2, 4, 3)),
    "time_distributed": (lambda r, c: r.TimeDistributed(
        c.Dense(3, activation="tanh")), (3, 5, 4)),
    "convlstm2d_seq_s2_back": (lambda r, c: r.ConvLSTM2D(
        2, (3, 2), subsample=2, return_sequences=True, go_backwards=True),
        (2, 3, 5, 6, 2)),
    "convlstm3d": (lambda r, c: r.ConvLSTM3D(2, 2), (1, 2, 3, 4, 3, 2)),
}


def _jax_shapes(jl, *shapes):
    """The JAX layer's parameter tree as shapes, traced, not run (its
    initializers' eager ops would compile for every shape)."""
    return jax.eval_shape(lambda k: jl.init(k, *shapes)[0],
                          jax.random.PRNGKey(0))


def _pair(case, seed=0):
    """The JAX layer with its params, and the port layer with the same
    weights (params drawn by numpy in the JAX tree's shapes)."""
    make, shape = CASES[case]
    jax_reset_names()
    jl = make(jrec, jcore)
    reset_name_scope()
    tl = make(trec, tcore)
    assert tl.name == jl.name
    shapes = _jax_shapes(jl, shape)
    params = _numpy_tree(shapes, np.random.RandomState(seed))
    tl.build(torch.Generator().manual_seed(0), shape)
    load_jax_params(tl, params)
    return jl, tl, params, shape


def _jax_forward(jl, params, x):
    y, _ = jl.call(params, {}, x)
    return y


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_forward_and_gradients_match_jax(case):
    jl, tl, params, shape = _pair(case)
    rs = np.random.RandomState(1)
    x = rs.randn(*shape).astype(np.float32)
    out_shape = tl.output_shape(shape)
    proj = rs.randn(*out_shape).astype(np.float32)

    def jloss(p, xx):
        y = _jax_forward(jl, p, xx)
        return jnp.sum(y * proj), y

    # one compiled program for the forward and both gradients
    (jgp, jgx), want = jax.jit(jax.grad(jloss, argnums=(0, 1),
                                        has_aux=True))(params,
                                                       jnp.asarray(x))
    want = np.asarray(want)
    assert want.shape == tuple(out_shape)

    xt = torch.from_numpy(x).requires_grad_(True)
    got = tl(xt)
    assert tuple(got.shape) == tuple(out_shape)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=FWD_ATOL)
    names = [n for n, _ in tl.named_parameters()]
    leaves = [p for _, p in tl.named_parameters()]
    grads = torch.autograd.grad((got * torch.from_numpy(proj)).sum(),
                                [xt] + leaves)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    flat = dict(zip(names, grads[1:]))

    def check(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                check(v, prefix + (k,))
                continue
            key = ".".join(_module_path(tl, prefix) + (k,))
            np.testing.assert_allclose(flat[key].numpy(), np.asarray(v),
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=f"{case} {prefix + (k,)}")

    check(jgp, ())


def _module_path(layer, prefix):
    """The ``named_parameters`` prefix of the sub-tree at ``prefix``."""
    if isinstance(layer, trec.TimeDistributed):
        return ("inner",)
    return tuple(p for k in prefix for p in ("_tree", k))


@pytest.mark.parametrize("cls", ["LSTM", "GRU", "SimpleRNN"])
def test_initial_carry_and_return_state_match_jax(cls):
    """The seq2seq hook: ``run`` from a given carry, returning the
    sequence and the last carry."""
    jax_reset_names()
    jl = getattr(jrec, cls)(4, return_sequences=True)
    reset_name_scope()
    tl = getattr(trec, cls)(4, return_sequences=True)
    params = _numpy_tree(_jax_shapes(jl, (3, 5, 6)),
                         np.random.RandomState(2))
    tl.build(torch.Generator().manual_seed(0), (3, 5, 6))
    load_jax_params(tl, params)
    rs = np.random.RandomState(3)
    x = rs.randn(3, 5, 6).astype(np.float32)
    h0 = rs.randn(3, 4).astype(np.float32)
    carry = ((h0, rs.randn(3, 4).astype(np.float32)) if cls == "LSTM"
             else h0)
    jy, jc = jl.run(params, jnp.asarray(x),
                    initial_carry=jax.tree_util.tree_map(jnp.asarray, carry),
                    return_state=True)
    ty, tc = tl.run(torch.from_numpy(x),
                    initial_carry=(tuple(map(torch.from_numpy, carry))
                                   if cls == "LSTM"
                                   else torch.from_numpy(carry)),
                    return_state=True)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=FWD_ATOL)
    for a, b in zip(jax.tree_util.tree_leaves(tc),
                    jax.tree_util.tree_leaves(jc)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=FWD_ATOL)


def test_rnn_in_a_bf16_graph_keeps_an_f32_carry():
    """Under bf16 parameters and input, as ``compute_dtype="bfloat16"``
    runs them, the recurrence and the output are f32 (the JAX package's
    f32 carry), and a Dense after it promotes to f32 as ``jnp`` does."""
    reset_name_scope()
    from analytics_zoo_tpu_torch.nn import Input

    x = Input(shape=(5, 4))
    out = tcore.Dense(3)(trec.GRU(6)(x))
    net = Model(x, out)
    net.build(torch.Generator().manual_seed(0))
    from analytics_zoo_tpu_torch.nn.module import cast_floats

    xs = torch.randn(2, 5, 4, dtype=torch.bfloat16)
    y = torch.func.functional_call(net, cast_floats(net, torch.bfloat16),
                                   (xs,))
    assert y.dtype == torch.float32
    want = net(xs.float())
    assert float((y - want).abs().max().detach()) < 0.05


@pytest.mark.parametrize("shape", [(40, 120), (120, 40), (3, 3, 4, 16)])
def test_orthogonal_initializer_law(shape):
    """Orthonormal columns (tall) or rows (wide) over (prod(other dims),
    last dim), as ``jax.nn.initializers.orthogonal`` draws; seeded draws
    repeat."""
    init = initializers.get("orthogonal")
    w = init(torch.Generator().manual_seed(5), shape)
    assert tuple(w.shape) == shape and w.dtype == torch.float32
    m = w.reshape(-1, shape[-1]).double()
    gram = m.T @ m if m.shape[0] >= m.shape[1] else m @ m.T
    np.testing.assert_allclose(gram.numpy(), np.eye(gram.shape[0]),
                               atol=1e-5)
    assert torch.equal(w, init(torch.Generator().manual_seed(5), shape))
    if shape == (40, 120):
        # the JAX law on the GRU's recurrent shape: orthonormal rows too
        jw = jax.nn.initializers.orthogonal()(jax.random.PRNGKey(0), shape)
        jm = np.asarray(jw).astype(np.float64)
        np.testing.assert_allclose(jm @ jm.T, np.eye(40), atol=1e-5)


# ---------------------------------------------------------------------------
# the autograd DSL

# (name, builder(autograd module, a, b) -> Variable); a is (B, 4, 6), b
# is (B, 6, 5), both positive
OPS = {
    "slice": lambda ag, a, b: a.slice(1, 1, 2),
    "slice_last": lambda ag, a, b: a.slice(2, 3, 3),
    "getitem": lambda ag, a, b: a[:, 1:3, ::2],
    "index_select": lambda ag, a, b: a.index_select(1, 2),
    "index_select_array": lambda ag, a, b: a.index_select(2, np.array([0, 3, 5])),
    "squeeze": lambda ag, a, b: a.slice(1, 0, 1).squeeze(1),
    "expand_dims": lambda ag, a, b: a.expand_dims(1),
    "reshape": lambda ag, a, b: a.reshape(3, 24),
    "radd_rsub_rmul_rdiv_pow": lambda ag, a, b: (
        (2.0 + a) * (1.0 - a) + 3.0 * a - 1.0 / a + a ** 2),
    "neg_div": lambda ag, a, b: -a / (a + 1.0),
    "unary": lambda ag, a, b: (ag.abs(a) + ag.square(a) + ag.sqrt(a)
                               + ag.log(a) + ag.exp(a) + ag.erf(a)
                               + ag.softsign(a) + ag.softplus(a)),
    "pow_clip": lambda ag, a, b: ag.pow(a, 3) + ag.clip(a, 0.2, 0.7),
    "sum_mean": lambda ag, a, b: ag.sum(a, axis=2) + ag.mean(
        a, axis=2, keepdims=False),
    "sum_keepdims": lambda ag, a, b: ag.sum(a, axis=1, keepdims=True),
    "maximum": lambda ag, a, b: ag.maximum(a, 0.5) + ag.maximum(0.4, a)
    + ag.maximum(a, a * 0.9),
    "stack": lambda ag, a, b: ag.stack([a, a * 2.0], axis=1),
    "mm": lambda ag, a, b: ag.mm(a, b),
    "mm_axes": lambda ag, a, b: ag.mm(a, a, axes=(2, 2)),
    "batch_dot": lambda ag, a, b: ag.batch_dot(a, b, axes=(2, 1)),
    "l2_normalize": lambda ag, a, b: ag.l2_normalize(a, axis=-1),
    "contiguous_expand": lambda ag, a, b: ag.expand_dims(
        ag.contiguous(a), 0),
}


def _graph(ag, name, op):
    a = ag.Input(shape=(4, 6), name="a")
    b = ag.Input(shape=(6, 5), name="b")
    return a, b, OPS[op](ag, a, b)


def _eval(ag_mod, out, a, b, xa, xb):
    order = ag_mod.topo_sort([out])
    env = {a.id: xa, b.id: xb}
    if ag_mod is tag:
        return ag_mod.evaluate(order, env)[out.id]
    return ag_mod.evaluate(order, env, {}, {})[0][out.id]


@pytest.mark.parametrize("op", sorted(OPS))
def test_autograd_operator_matches_jax(op):
    rs = np.random.RandomState(4)
    xa = rs.rand(3, 4, 6).astype(np.float32) + 0.1
    xb = rs.rand(3, 6, 5).astype(np.float32) + 0.1
    ja, jb, jout = _graph(jag, "jax", op)
    ta, tb, tout = _graph(tag, "port", op)
    def jfn(x, y):
        return _eval(jag, jout, ja, jb, x, y)

    want, jg = jax.jit(lambda x, y: (jfn(x, y), jax.grad(
        lambda xx: jnp.sum(jfn(xx, y)))(x)))(jnp.asarray(xa),
                                             jnp.asarray(xb))
    want = np.asarray(want)
    ta_t = torch.from_numpy(xa).requires_grad_(True)
    got = _eval(tag, tout, ta, tb, ta_t, torch.from_numpy(xb))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                               atol=FWD_ATOL)
    # the gradient of the summed output with respect to ``a``
    (tg,) = torch.autograd.grad(got.sum(), [ta_t])
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


def test_parameter_in_a_graph_matches_jax():
    """A ``Parameter`` is a leaf ``value`` under its layer's name, in the
    tree, the forward and the gradients."""
    def build(ag, core, model_cls):
        x = ag.Input(shape=(4,), name="x")
        p = ag.Parameter((4, 6), name="scale")
        h = core.Dense(3, name="proj")(ag.mm(x, p) + 1.0)
        return model_cls(x, ag.sum(h, axis=1))

    jax_reset_names()
    jm = build(jag, jcore, JaxModel)
    reset_name_scope()
    tm = build(tag, tcore, Model)
    shapes = jax.eval_shape(lambda k: jm.build(k)[0], jax.random.PRNGKey(0))
    params = _numpy_tree(shapes, np.random.RandomState(6))
    tm.build(torch.Generator().manual_seed(0))
    assert set(tm.params()) == set(params) and set(
        tm.params()["scale"]) == {"value"}
    load_jax_params(tm, params)
    x = np.random.RandomState(7).randn(5, 4).astype(np.float32)
    want, jg = jax.jit(lambda p: (jm.call(p, {}, jnp.asarray(x))[0],
                                  jax.grad(lambda q: jnp.sum(jm.call(
                                      q, {}, jnp.asarray(x))[0]))(p)))(params)
    got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=FWD_ATOL)
    (tg,) = torch.autograd.grad(got.sum(), [tm.subtree("scale")
                                            ._parameters["value"]])
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg["scale"]["value"]),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
