"""The port's static-buffer training step (``train/estimator.py``'s step
programs, ``core/graphs.py``) on the CPU, where nothing is captured and
the same code runs eagerly.

- The program path — a batch copied into the program's static buffers,
  ``K`` steps per program, the device-resident path's permutation buffer
  and device offset — trains exactly as the plain step called on the
  batches themselves: weights and optimizer state bit for bit.
- NeuralCF at a small width, ``steps_per_execution`` K = 1, 3 and 4 (10
  steps an epoch, so K = 3 and 4 end on one and two single tail steps),
  against the JAX ``Estimator.fit`` with the same K (its ``lax.scan``
  over a superbatch), from the same seeded numpy weights: per-epoch
  losses within rtol 1e-5, every leaf within 1e-5 of its largest
  magnitude (f32 sums in other orders: the JAX step sums its gradient
  over an 8-device CPU mesh).
- No stale step state: a rollback, a resume, ``load_weights``,
  ``freeze``/``unfreeze``, new initial weights and a recompile with
  another ``compute_dtype`` between ``fit`` calls; after each, the next
  epoch moves the live parameters and optimizer state, and where the
  state was restored in place the tensors are the same objects.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.convert import export_params, load_jax_params
from analytics_zoo_tpu_torch.core import context
from analytics_zoo_tpu_torch.models import NeuralCF
from analytics_zoo_tpu_torch.nn import Dense, Sequential, reset_name_scope
from analytics_zoo_tpu_torch.nn.net import GraphNet
from analytics_zoo_tpu_torch.robust import FaultInjector, TrainingPreempted
from analytics_zoo_tpu_torch.train import optimizers as topt

USERS, ITEMS = 50, 40
WIDTH = dict(user_embed=8, item_embed=8, hidden_layers=(16, 8), mf_embed=8)


@pytest.fixture(autouse=True)
def fresh_context():
    context.set_zoo_context(None)
    yield
    context.set_zoo_context(None)


def _data(n=336, seed=0):
    rs = np.random.RandomState(seed)
    u = rs.randint(1, USERS + 1, (n, 1)).astype(np.int32)
    i = rs.randint(1, ITEMS + 1, (n, 1)).astype(np.int32)
    y = rs.randint(0, 5, n).astype(np.int32)
    return u, i, y


def _weights():
    reset_name_scope()
    ncf = NeuralCF(USERS, ITEMS, device="cpu", **WIDTH)
    rs = np.random.RandomState(3)
    return {layer: {leaf: (rs.randn(*v.shape) * 0.1).astype(np.float32)
                    for leaf, v in sub.items()}
            for layer, sub in export_params(ncf.model).items()}


def _ncf(params, dropout=0.0, **compile_kw):
    reset_name_scope()
    ncf = NeuralCF(USERS, ITEMS, device="cpu", dropout=dropout, **WIDTH)
    # the dropout layers hold no weights
    load_jax_params(ncf.model, {**export_params(ncf.model), **params})
    ncf.compile(topt.Adam(lr=1e-3), "sparse_categorical_crossentropy",
                **compile_kw)
    return ncf


def _state(est):
    return ({k: {j: v.copy() for j, v in sub.items()}
             for k, sub in export_params(est.model).items()},
            [t.detach().clone() for t in est.opt_state])


def _assert_same_state(a, b):
    for layer, leaves in a[0].items():
        for leaf, w in leaves.items():
            np.testing.assert_array_equal(w, b[0][layer][leaf],
                                          err_msg=f"{layer}.{leaf}")
    assert len(a[1]) == len(b[1])
    for x, y in zip(a[1], b[1]):
        assert torch.equal(x, y)


def _plain_fit(est, arrays, batch, epochs):
    """The host path's batches (the estimator's seeded shuffle) through
    ``_train_step`` called on the batches themselves: no static buffers,
    no programs."""
    est._ensure_built([torch.from_numpy(a) for a in arrays[:-1]])
    rng = np.random.RandomState(est.ctx.config.seed)
    n = len(arrays[0])
    params = est._trainable()
    one = torch.ones(())
    losses = []
    est.model.train(True)
    for _ in range(epochs):
        est._fresh_accumulators()
        perm = rng.permutation(n)
        for s in range(n // batch):
            rows = perm[s * batch:(s + 1) * batch]
            b = [torch.from_numpy(a[rows]) for a in arrays]
            est._train_step(params, b[:-1], b[-1], None, one)
        losses.append(est._read_epoch()[0])
    return losses


@pytest.mark.parametrize("k", [1, 3])
def test_program_step_equals_the_plain_step(k):
    """K = 1 and K = 3 host programs (the tail included) against the
    plain step on the same batches: bit for bit."""
    params = _weights()
    u, i, y = _data()
    context.init_zoo_context(steps_per_execution=k)
    a = _ncf(params)
    hist = a.fit([u, i], y, batch_size=32, nb_epoch=2, verbose=False)
    b = _ncf(params)
    losses = _plain_fit(b.estimator, [u, i, y], 32, 2)
    assert [h["loss"] for h in hist] == losses
    _assert_same_state(_state(a.estimator), _state(b.estimator))
    assert a.estimator.global_step == 2 * (336 // 32)


def test_resident_programs_keep_the_step_sequence():
    """The device-resident path (permutation buffer, offset counter) with
    K = 4 trains exactly as with K = 1."""
    params = _weights()
    u, i, y = (torch.from_numpy(a) for a in _data())

    def run(k):
        context.init_zoo_context(steps_per_execution=k)
        ncf = _ncf(params)
        hist = ncf.fit([u, i], y, batch_size=32, nb_epoch=2, verbose=False)
        assert ncf.estimator.last_data_path == "device_resident"
        assert int(ncf.estimator._feed.offset) == 32 * (336 // 32)
        return [h["loss"] for h in hist], _state(ncf.estimator)

    (l1, s1), (l4, s4) = run(1), run(4)
    assert l1 == l4
    _assert_same_state(s1, s4)


@pytest.mark.parametrize("k", [1, 3, 4])
def test_steps_per_execution_matches_jax(k):
    import jax

    from analytics_zoo_tpu import init_zoo_context as jax_init_context
    from analytics_zoo_tpu.models import NeuralCF as JaxNCF
    from analytics_zoo_tpu.nn import reset_name_scope as jax_reset_names
    from analytics_zoo_tpu.train import optimizers as jopt

    params = _weights()
    u, i, y = _data()
    jax_init_context(steps_per_execution=k)
    jax_reset_names()
    jncf = JaxNCF(USERS, ITEMS, table_placement="replicated", **WIDTH)
    jncf.compile(optimizer=jopt.Adam(lr=1e-3),
                 loss="sparse_categorical_crossentropy")
    jncf.estimator.set_initial_weights(params)
    jhist = jncf.fit([u, i], y, batch_size=32, nb_epoch=2, verbose=False)
    context.init_zoo_context(steps_per_execution=k)
    tncf = _ncf(params)
    thist = tncf.fit([u, i], y, batch_size=32, nb_epoch=2, verbose=False)
    assert tncf.estimator.global_step == jncf.estimator.global_step == 20
    np.testing.assert_allclose([h["loss"] for h in thist],
                               [h["loss"] for h in jhist], rtol=1e-5)
    got = export_params(tncf.model)
    want = jax.tree_util.tree_map(np.asarray, jncf.estimator.params)
    for layer, leaves in want.items():
        for leaf, w in leaves.items():
            err = np.max(np.abs(got[layer][leaf] - w))
            assert err <= 1e-5 * np.max(np.abs(w)), (layer, leaf, err)


def _moves(est, fit):
    """Run ``fit()``; assert it moved every live parameter tensor and the
    optimizer state (the Adam count included)."""
    before = _state(est)
    fit()
    after = _state(est)
    for layer, leaves in before[0].items():
        for leaf, w in leaves.items():
            assert not np.array_equal(w, after[0][layer][leaf]), (layer,
                                                                  leaf)
    for x, y in zip(before[1], after[1]):
        assert not torch.equal(x, y)


def _identity(est):
    return ([(id(p), p.data_ptr()) for p in est.model.parameters()],
            [(id(t), t.data_ptr()) for t in est.opt_state])


def test_rollback_restores_in_place_and_keeps_the_programs(tmp_path):
    """A NaN rollback fills the live parameters and optimizer state from
    the checkpoint: the same tensors, the same step programs; the next
    epochs move them."""
    params = _weights()
    u, i, y = _data()
    context.init_zoo_context(nan_policy="rollback", max_bad_steps=2,
                             steps_per_execution=3)
    ncf = _ncf(params)
    ncf.set_checkpoint(str(tmp_path))
    est = ncf.estimator
    ncf.fit([u, i], y, batch_size=32, nb_epoch=1, verbose=False)
    ids, progs = _identity(est), dict(est._programs)
    # epoch 2's second and third dispatches (3 chunks and a tail step an
    # epoch), 6 steps in a row
    with FaultInjector().plan("estimator.step", at=[1, 2], action="nan"):
        _moves(est, lambda: ncf.fit([u, i], y, batch_size=32, nb_epoch=3,
                                    verbose=False))
    assert est._lr_scale == 0.5
    assert _identity(est) == ids
    assert all(est._programs[key] is prog for key, prog in progs.items())


def test_resume_continues_the_uninterrupted_run(tmp_path):
    """A preemption between two K-step dispatches, then a fresh estimator
    resumed with ``fit(resume=True)``: the uninterrupted run's losses and
    state, bit for bit."""
    params = _weights()
    u, i, y = _data()
    context.init_zoo_context(steps_per_execution=3)
    whole = _ncf(params, dropout=0.2)
    want = whole.fit([u, i], y, batch_size=32, nb_epoch=2, verbose=False)
    cut = _ncf(params, dropout=0.2)
    cut.set_checkpoint(str(tmp_path))
    with FaultInjector().plan("estimator.preempt", at=6):
        with pytest.raises(TrainingPreempted):
            cut.fit([u, i], y, batch_size=32, nb_epoch=2, verbose=False)
    resumed = _ncf(params, dropout=0.2)
    resumed.set_checkpoint(str(tmp_path))
    got = resumed.fit([u, i], y, batch_size=32, nb_epoch=2, verbose=False,
                      resume=True)
    # the resumed fit's history holds the epoch it finished
    assert [h["loss"] for h in got] == [h["loss"] for h in want[1:]]
    _assert_same_state(_state(resumed.estimator), _state(whole.estimator))


def test_load_weights_between_fits_moves_the_live_tensors(tmp_path):
    params = _weights()
    u, i, y = _data()
    ncf = _ncf(params)
    ncf.fit([u, i], y, batch_size=32, nb_epoch=1, verbose=False)
    est = ncf.estimator
    ids = _identity(est)
    path = str(tmp_path / "w.npz")
    ncf.model.save_weights(path, params=params)
    ncf.model.load_weights(path)
    assert _identity(est) == ids          # copied in, not replaced
    assert export_params(ncf.model)["ncf_head"]["kernel"].tolist() == \
        params["ncf_head"]["kernel"].tolist()
    _moves(est, lambda: ncf.fit([u, i], y, batch_size=32, nb_epoch=2,
                                verbose=False))


def test_new_initial_weights_drop_the_programs():
    """``set_initial_weights`` on a built estimator starts a fresh
    optimizer state: the programs that held the old one go, and the next
    epoch trains the new state."""
    params = _weights()
    u, i, y = _data()
    ncf = _ncf(params)
    est = ncf.estimator
    ncf.fit([u, i], y, batch_size=32, nb_epoch=1, verbose=False)
    old = dict(est._programs)
    est.set_initial_weights(params)
    _moves(est, lambda: ncf.fit([u, i], y, batch_size=32, nb_epoch=2,
                                verbose=False))
    assert not any(prog is old.get(key)
                   for key, prog in est._programs.items())
    assert int(est.opt_state[0]) == 336 // 32


def test_freeze_and_unfreeze_between_fits():
    """A frozen layer holds still in the next epoch while the others and
    every optimizer moment move; unfrozen, it moves again."""
    reset_name_scope()
    net = GraphNet(Sequential([Dense(8, input_shape=(4,),
                                     activation="relu", name="d1"),
                               Dense(1, name="d2")]))
    net.compile(topt.Adam(lr=1e-2), "mse", device="cpu")
    rs = np.random.RandomState(0)
    x = rs.randn(64, 4).astype(np.float32)
    y = rs.randn(64, 1).astype(np.float32)
    net.fit(x, y, batch_size=16, nb_epoch=1, verbose=False)
    est = net.estimator
    net.freeze(["d1"])
    before = export_params(net.model)
    state = [t.clone() for t in est.opt_state]
    net.fit(x, y, batch_size=16, nb_epoch=2, verbose=False)
    after = export_params(net.model)
    np.testing.assert_array_equal(after["d1"]["kernel"],
                                  before["d1"]["kernel"])
    assert not np.array_equal(after["d2"]["kernel"], before["d2"]["kernel"])
    assert all(not torch.equal(a, b) for a, b in zip(state, est.opt_state))
    net.unfreeze()
    _moves(est, lambda: net.fit(x, y, batch_size=16, nb_epoch=3,
                                verbose=False))


def test_recompile_with_another_compute_dtype():
    """A recompile to ``compute_dtype="bfloat16"`` builds a new estimator
    whose programs run the bf16 step on the live weights."""
    params = _weights()
    u, i, y = _data()
    ncf = _ncf(params)
    ncf.fit([u, i], y, batch_size=32, nb_epoch=1, verbose=False)
    f32 = ncf.estimator
    ncf.compile(topt.Adam(lr=1e-3), "sparse_categorical_crossentropy",
                compute_dtype="bfloat16")
    est = ncf.estimator
    assert est is not f32 and est.compute_dtype == torch.bfloat16
    ncf.fit([u, i], y, batch_size=32, nb_epoch=1, verbose=False)
    _moves(est, lambda: ncf.fit([u, i], y, batch_size=32, nb_epoch=2,
                                verbose=False))
    assert all(p.dtype == torch.float32 for p in ncf.model.parameters())


def test_graphs_run_eagerly_off_the_card_and_inside_checks():
    """Graphs are captured only for a CUDA device outside
    ``graphs.disabled()`` and ``dispatch.forced``; elsewhere the function
    runs eagerly at every call, and an explicit capture raises."""
    from analytics_zoo_tpu_torch.core import graphs
    from analytics_zoo_tpu_torch.ops import dispatch

    assert graphs.enabled("cuda") and not graphs.enabled("cpu")
    with graphs.disabled():
        assert not graphs.enabled("cuda")
    with dispatch.forced(dispatch.PATH_REFERENCE):
        assert not graphs.enabled("cuda")
    calls = []
    g = graphs.StepGraph(lambda: calls.append(1) or len(calls), "cpu")
    assert [g() for _ in range(3)] == [1, 2, 3] and not g.captured
    with pytest.raises(graphs.GraphCaptureError, match="graphs are off"):
        g.capture()


def test_a_failed_capture_names_the_ops_frame():
    """The capture error names the port's innermost frame at fault."""
    from analytics_zoo_tpu_torch.core import graphs
    from analytics_zoo_tpu_torch.ops import embedding_bag

    with pytest.raises(ValueError) as info:
        embedding_bag.embedding_bag(torch.zeros(3, 2),
                                    torch.zeros(2, 1, dtype=torch.int64),
                                    "no such combiner")
    where = graphs._culprit(info.value)
    assert where.startswith("analytics_zoo_tpu_torch/ops/embedding_bag.py:")


def test_launch_records_count_at_every_replay():
    """A launch recorded at a capture counts once per replay, with its
    routing decision; outside a capture a launch counts at once."""
    from analytics_zoo_tpu_torch.observe.metrics import METRICS
    from analytics_zoo_tpu_torch.ops import dispatch

    counter = dispatch.LaunchCount("probe")
    counter.add()
    rec = dispatch.LaunchRecord()
    rec.launches[counter] += 3
    rec.selections[("probe", "cuda")] += 3
    window = METRICS.snapshot()
    for _ in range(4):
        rec.replay()
    assert counter.value == 1 + 3 * 4
    assert rec.per_replay() == {"probe": 3}
    assert METRICS.delta(window)["counters"][
        'ops_kernel_selected_total{kernel="probe",path="cuda"}'] == 12
