"""The PyTorch port's training surface against the JAX package's
``Estimator``: ``compute_dtype="bfloat16"``, ``grad_accum_steps`` (optax
``MultiSteps``) and ``GraphNet.freeze`` / ``unfreeze`` / ``freeze_up_to``.

Weights and inputs come from ``np.random.RandomState``; the port trains
on the CPU (``device="cpu"``), the JAX package on its 8-device CPU mesh.
Tolerances, with their reasons:

- f32 runs (accumulation, freezing): per-epoch losses within rtol 1e-4,
  weights and Adam moments within atol 1e-4, the training slice's
  tolerance (the JAX step sums its gradients across the mesh);
- ``multi_steps`` against ``optax.MultiSteps`` on one vector: atol 1e-7
  (the same f32 operations);
- bf16 BERT fine-tuning: per-epoch losses within rtol 1e-3 and weights
  within atol 2e-3 (measured on one host: 1.0e-5 and 1.2e-3; the same
  run in f32 agrees to 9e-8 and 1.6e-7).  Both packages round every
  matmul, LayerNorm, GELU and softmax result to bf16 (a relative step of
  2^-8), but reduce in other orders and at other internal widths (XLA's
  CPU reductions against ATen's f32 accumulation), so single roundings
  land one bf16 step apart; AdamW's first steps move a weight by about
  lr = 5e-4 whatever the gradient's size, so a gradient element near 0
  whose sign differs moves its weight up to 2 lr apart.
"""

import copy
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from analytics_zoo_tpu.nn import reset_name_scope as jax_reset_names

from analytics_zoo_tpu_torch.convert import export_params, load_jax_params
from analytics_zoo_tpu_torch.core import context
from analytics_zoo_tpu_torch.models import NeuralCF
from analytics_zoo_tpu_torch.nn import GraphNet, reset_name_scope
from analytics_zoo_tpu_torch.train import optimizers as topt

jopt = importlib.import_module("analytics_zoo_tpu.train.optimizers")
jnet_mod = importlib.import_module("analytics_zoo_tpu.nn.net")

SMALL_NCF = dict(user_embed=8, item_embed=8, hidden_layers=(16, 8),
                 mf_embed=8)


@pytest.fixture(autouse=True)
def fresh_context():
    context.set_zoo_context(None)
    yield
    context.set_zoo_context(None)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _ncf_pair(n=992, seed=0):
    """A JAX and a port NeuralCF (50 users, 40 items, narrow) with the
    same seeded weights, and seeded (user, item, label) rows."""
    from analytics_zoo_tpu import init_zoo_context as jax_init_context
    from analytics_zoo_tpu.models import NeuralCF as JaxNCF

    rs = np.random.RandomState(seed)
    u = rs.randint(1, 51, (n, 1)).astype(np.int32)
    i = rs.randint(1, 41, (n, 1)).astype(np.int32)
    y = rs.randint(0, 5, n).astype(np.int32)
    jax_init_context()
    jax_reset_names()
    jncf = JaxNCF(50, 40, table_placement="replicated", **SMALL_NCF)
    reset_name_scope()
    tncf = NeuralCF(50, 40, device="cpu", **SMALL_NCF)
    wrs = np.random.RandomState(3)
    params = {layer: {leaf: (wrs.randn(*v.shape) * 0.1).astype(np.float32)
                      for leaf, v in sub.items()}
              for layer, sub in tncf.model.params().items()}
    load_jax_params(tncf.model, params)
    return jncf, tncf, params, (u, i, y)


def _flat_tree(net, flat):
    """A flat vector over ``net``'s trainable parameters, as the JAX
    package's tree (a copy of the net holds it)."""
    twin = copy.deepcopy(net)
    params = [p for p in twin.parameters() if p.requires_grad]
    with torch.no_grad():
        for p, v in zip(params, torch.split(flat.detach().cpu(),
                                            [p.numel() for p in params])):
            p.copy_(v.view_as(p))
    return export_params(twin)


def _assert_trees_close(got, want, atol, what=""):
    want = jax.tree_util.tree_map(np.asarray, want)
    got = {k: v for k, v in got.items() if v}
    assert set(got) == {k for k, v in want.items()
                        if jax.tree_util.tree_leaves(v)}, what
    for layer, leaves in got.items():
        for leaf, g in leaves.items():
            np.testing.assert_allclose(g, want[layer][leaf], rtol=0,
                                       atol=atol,
                                       err_msg=f"{what} {layer}.{leaf}")


# ---------------------------------------------------------------------------
# gradient accumulation


@pytest.mark.parametrize("k", [2, 3])
def test_multi_steps_matches_optax(k):
    """``multi_steps`` over Adam with clipping inside, against
    ``optax.MultiSteps(chain(clip, adam), k)``: the same updates and the
    same inner state after 2k+1 steps, emitted every k-th step."""
    rs = np.random.RandomState(k)
    p = rs.randn(37).astype(np.float32)
    grads = [rs.randn(37).astype(np.float32) * 3 for _ in range(2 * k + 1)]
    jtx = optax.MultiSteps(optax.chain(optax.clip_by_global_norm(1.0),
                                       optax.adam(1e-2)), k)
    ttx = topt.multi_steps(topt.chain(topt.clip_by_global_norm(1.0),
                                      topt.Adam(1e-2)), k)
    js, ts = jtx.init(jnp.asarray(p)), ttx.init(torch.from_numpy(p))
    for n, g in enumerate(grads):
        ju, js = jtx.update(jnp.asarray(g), js, jnp.asarray(p))
        tu, ts = ttx.update(torch.from_numpy(g), ts, torch.from_numpy(p))
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0,
                                   atol=1e-7)
        assert bool(np.any(np.asarray(ju) != 0)) == ((n + 1) % k == 0)
    assert int(ts[0]) == int(js.mini_step)
    assert int(ts[1]) == int(js.gradient_step) == 2
    np.testing.assert_allclose(ts[2].numpy(), np.asarray(js.acc_grads),
                               rtol=0, atol=1e-7)


def test_grad_accum_matches_jax_multisteps():
    """NeuralCF with ``grad_accum_steps=3`` trained two epochs from the
    same weights and batches as the JAX ``compile(grad_accum_steps=3)``:
    losses rtol 1e-4, weights atol 1e-4."""
    jncf, tncf, params, (u, i, y) = _ncf_pair()
    jncf.model.compile(optimizer=jopt.Adam(lr=1e-2),
                       loss="sparse_categorical_crossentropy",
                       grad_accum_steps=3)
    jncf.estimator.set_initial_weights(params)
    jhist = jncf.fit([u, i], y, batch_size=32, nb_epoch=2, verbose=False)
    tncf.compile(topt.Adam(lr=1e-2), "sparse_categorical_crossentropy",
                 grad_accum_steps=3)
    thist = tncf.fit([u, i], y, batch_size=32, nb_epoch=2, verbose=False)
    np.testing.assert_allclose([h["loss"] for h in thist],
                               [h["loss"] for h in jhist], rtol=1e-4)
    _assert_trees_close(export_params(tncf.model), jncf.estimator.params,
                        1e-4, "weights")
    # 62 micro-batches: 20 updates, 2 micro-batches in flight
    st = tncf.estimator.opt_state
    assert (int(st[0]), int(st[1])) == (2, 20)


def test_grad_accum_of_half_batches_is_the_full_batch_step():
    """The mean of two half-batch gradients is the full-batch gradient:
    batch 16 with ``grad_accum_steps=2`` and batch 32 without, on the same
    rows in the same order, end within atol 1e-6."""
    _, a, params, (u, i, y) = _ncf_pair(n=320)
    a.compile(topt.SGD(lr=0.5), "sparse_categorical_crossentropy",
              grad_accum_steps=2)
    a.fit([u, i], y, batch_size=16, nb_epoch=1, shuffle=False,
          verbose=False)
    reset_name_scope()
    b = NeuralCF(50, 40, device="cpu", **SMALL_NCF)
    load_jax_params(b.model, params)
    b.compile(topt.SGD(lr=0.5), "sparse_categorical_crossentropy")
    b.fit([u, i], y, batch_size=32, nb_epoch=1, shuffle=False, verbose=False)
    _assert_trees_close(export_params(a.model), export_params(b.model),
                        1e-6, "accumulated")


# ---------------------------------------------------------------------------
# freezing


def test_freeze_fit_unfreeze_fit_matches_jax():
    """Three layers frozen for one epoch, then unfrozen for a second:
    weights and both Adam moments against the JAX package's (atol 1e-4,
    losses rtol 1e-4).  The frozen layers do not move in epoch 1 while
    their moments do."""
    frozen = ["mlp_user_embed", "mf_item_embed", "mlp_dense_0"]
    jncf, tncf, params, (u, i, y) = _ncf_pair()
    jg = jnet_mod.GraphNet(jncf.model).freeze(frozen)
    jncf.compile(optimizer=jopt.Adam(lr=1e-2),
                 loss="sparse_categorical_crossentropy")
    jncf.estimator.set_initial_weights(params)
    tg = GraphNet(tncf.model).freeze(frozen)
    assert tg.frozen == jg.frozen == set(frozen)
    tncf.compile(topt.Adam(lr=1e-2), "sparse_categorical_crossentropy")
    hists = []
    for epochs, g in ((1, None), (2, "unfreeze")):
        if g:
            jg.unfreeze()
            tg.unfreeze()
        jh = jncf.fit([u, i], y, batch_size=32, nb_epoch=epochs,
                      verbose=False)
        th = tncf.fit([u, i], y, batch_size=32, nb_epoch=epochs,
                      verbose=False)
        hists.append((th[-1]["loss"], jh[-1]["loss"]))
        got = export_params(tncf.model)
        if epochs == 1:
            for name in frozen:
                for leaf, w in params[name].items():
                    np.testing.assert_array_equal(got[name][leaf], w)
            assert not np.array_equal(got["ncf_head"]["kernel"],
                                      params["ncf_head"]["kernel"])
        _assert_trees_close(got, jncf.estimator.params, 1e-4,
                            f"weights after epoch {epochs}")
        est = tncf.estimator
        adam = jncf.estimator.opt_state[0]
        for k, name in ((1, "mu"), (2, "nu")):
            _assert_trees_close(_flat_tree(tncf.model, est.opt_state[k]),
                                getattr(adam, name), 1e-4,
                                f"{name} after epoch {epochs}")
        mu = _flat_tree(tncf.model, est.opt_state[1])
        assert np.any(mu["mlp_user_embed"]["table"] != 0)
    np.testing.assert_allclose(*zip(*hists), rtol=1e-4)


def test_freeze_up_to_follows_the_layer_order_and_checks_names():
    jncf, tncf, _, _ = _ncf_pair(n=8)
    tg = GraphNet(tncf.model).freeze_up_to("mlp_dense_0")
    jg = jnet_mod.GraphNet(jncf.model).freeze_up_to("mlp_dense_0")
    assert tg.frozen == jg.frozen
    assert "mlp_dense_0" in tg.frozen and "ncf_head" not in tg.frozen
    with pytest.raises(ValueError, match="unknown layer"):
        tg.freeze_up_to("nope")
    with pytest.raises(ValueError, match="unknown layers"):
        tg.freeze(["nope"])
    assert tg.unfreeze(["mlp_dense_0"]).frozen == jg.frozen - {
        "mlp_dense_0"}
    assert tg.unfreeze().frozen == set()


# ---------------------------------------------------------------------------
# bf16 compute


BERT_SMALL = dict(vocab=300, hidden_size=128, n_block=2, nhead=2,
                  intermediate_size=256, max_position_len=64, hidden_drop=0.0,
                  attn_drop=0.0)


def _bert_fit_both(compute_dtype, epochs=2):
    """BERTClassifier (2 blocks, hidden 128) fine-tuned by both packages
    from the same seeded weights at ``compute_dtype``: AdamWeightDecay
    lr 5e-4, warmup 0.1, batch 16, 64 seeded sequences of 16 tokens."""
    from analytics_zoo_tpu import init_zoo_context as jax_init_context
    from analytics_zoo_tpu.tfpark import text_estimators as jtext

    from analytics_zoo_tpu_torch.tfpark import BERTClassifier

    rs = np.random.RandomState(1)
    ids = rs.randint(0, 300, (64, 16)).astype(np.int32)
    seg = (np.arange(16)[None, :] >= rs.randint(1, 16, 64)[:, None]
           ).astype(np.int32)
    y = (ids[:, 1] < 150).astype(np.int32)
    jax_init_context(compute_dtype=compute_dtype)
    jax_reset_names()
    jnet = jtext.BERTClassifier(2, bert_config=BERT_SMALL)
    jparams, _ = jnet.build(jax.random.PRNGKey(0), (2, 16), (2, 16))
    wrs = np.random.RandomState(0)

    def fill(path, x):
        if str(path[-1].key) == "gamma":
            return (1.0 + 0.1 * wrs.randn(*np.shape(x))).astype(np.float32)
        return (0.02 * wrs.randn(*np.shape(x))).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, jparams)
    total = epochs * 4
    ce = "sparse_categorical_crossentropy_with_logits"
    jnet.compile(optimizer=jopt.AdamWeightDecay(5e-4, warmup_portion=0.1,
                                                total=total), loss=ce)
    assert jnet.estimator.compute_dtype == (
        None if compute_dtype == "float32" else jnp.bfloat16)
    jnet.estimator.set_initial_weights(params)
    jh = jnet.fit([ids, seg], y, batch_size=16, nb_epoch=epochs,
                  verbose=False)
    reset_name_scope()
    tnet = BERTClassifier(2, bert_config=BERT_SMALL)
    load_jax_params(tnet, params)
    tnet.compile(topt.AdamWeightDecay(5e-4, warmup_portion=0.1, total=total),
                 ce, device="cpu", compute_dtype=compute_dtype)
    th = tnet.fit([ids, seg], y, batch_size=16, nb_epoch=epochs,
                  verbose=False)
    return ([h["loss"] for h in jh], [h["loss"] for h in th], jnet, tnet,
            (ids, seg, y))


def test_bf16_bert_fine_tune_matches_jax():
    """``compute_dtype="bfloat16"`` on BERTClassifier against the JAX
    ``Estimator`` at the same compute dtype: per-epoch losses rtol 1e-3,
    weights atol 2e-3 (see the module docstring); the masters and the
    optimizer state stay f32; predict answers in f32, within 2e-2 of the
    JAX bf16 predict (a few bf16 steps of logits near 1)."""
    jloss, tloss, jnet, tnet, (ids, seg, y) = _bert_fit_both("bfloat16")
    np.testing.assert_allclose(tloss, jloss, rtol=1e-3)
    assert tloss[1] < tloss[0]
    got = export_params(tnet)
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, w, rtol=0, atol=2e-3),
        got, jax.tree_util.tree_map(np.asarray, jnet.estimator.params))
    assert all(p.dtype == torch.float32 for p in tnet.parameters())
    assert all(t.dtype in (torch.float32, torch.int32)
               for t in tnet.estimator.opt_state)
    tp = tnet.predict([ids[:9], seg[:9]])
    assert tp.dtype == np.float32
    np.testing.assert_allclose(tp, np.asarray(jnet.predict([ids[:9],
                                                            seg[:9]])),
                               rtol=0, atol=2e-2)


def test_bf16_forward_runs_every_layer_in_bf16(monkeypatch):
    """Under ``compute_dtype="bfloat16"`` the flash router, LayerNorm and
    the task head see bf16 tensors (no layer casts back to f32), and the
    gradients reach the f32 masters."""
    from analytics_zoo_tpu_torch.nn.layers import attention as tatt
    from analytics_zoo_tpu_torch.nn.layers.normalization import LayerNorm
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier

    seen = []
    route = tatt.dot_product_attention

    def spy(q, k, v, **kw):
        seen.append(("attention", q.dtype, k.dtype, v.dtype))
        return route(q, k, v, **kw)

    monkeypatch.setattr(tatt, "dot_product_attention", spy)
    hooks = []
    reset_name_scope()
    net = BERTClassifier(2, bert_config=BERT_SMALL)
    for m in net.modules():
        if isinstance(m, LayerNorm):
            hooks.append(m.register_forward_hook(
                lambda mod, i, o: seen.append(("ln", i[0].dtype, o.dtype))))
    net.compile("adam", "sparse_categorical_crossentropy_with_logits",
                device="cpu", compute_dtype="bfloat16")
    ids = np.ones((4, 8), np.int32)
    before = export_params(net)
    net.fit([ids, 0 * ids], np.array([0, 1, 0, 1], np.int32), batch_size=4,
            epochs=1, verbose=False)
    assert seen and all(set(s[1:]) == {torch.bfloat16} for s in seen), seen
    after = export_params(net)
    assert not np.array_equal(after["head"]["kernel"],
                              before["head"]["kernel"])
    for h in hooks:
        h.remove()


def test_compute_dtype_is_checked():
    reset_name_scope()
    ncf = NeuralCF(5, 5, device="cpu")
    with pytest.raises(ValueError, match="compute_dtype"):
        ncf.compile("adam", "sparse_categorical_crossentropy",
                    compute_dtype="int8")
