"""The PyTorch port's fault-tolerance slice: the retry policy, fault
injection, checkpoint durability, exact resume after a preemption, a real
SIGTERM, the NaN policies, the prefetch producer's failures, and model
persistence — the counterparts of ``tests/test_robustness.py``'s classes,
run on the port (``device="cpu"``), with the JAX package where a result
can be compared.

Inputs and weights come from ``np.random.RandomState``.  Tolerances, with
their reasons:

- resume against the port's own uninterrupted run: bit-equal (the same
  CPU arithmetic in the same order);
- the port's runs against the JAX package's: per-epoch losses within
  rtol 1e-4 and weights within atol 1e-4, the training slice's tolerance
  (the JAX step sums its gradients across an 8-device CPU mesh);
- a model saved by the JAX package and loaded by the port: predictions
  within atol 1e-6 (f32 sums in another order).
"""

import json
import os
import signal
import threading

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.convert import export_params, load_jax_params
from analytics_zoo_tpu_torch.core import context
from analytics_zoo_tpu_torch.core.profiling import TIMERS
from analytics_zoo_tpu_torch.nn import Dense, Sequential, reset_name_scope
from analytics_zoo_tpu_torch.robust import (FaultInjector,
                                            RetryDeadlineExceeded,
                                            RetryPolicy, TrainingPreempted,
                                            faults)
from analytics_zoo_tpu_torch.train import checkpoint as tckpt
from analytics_zoo_tpu_torch.train import optimizers as topt
from analytics_zoo_tpu_torch.train.estimator import Estimator
from analytics_zoo_tpu_torch.train.prefetch import PrefetchIterator


@pytest.fixture(autouse=True)
def fresh_context():
    context.set_zoo_context(None)
    yield
    context.set_zoo_context(None)


def _build_model():
    reset_name_scope()
    return Sequential([Dense(8, input_shape=(4,), activation="relu"),
                       Dense(1)])


def _toy_data(n=64, d=4, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, d).astype(np.float32),
            rs.randn(n, 1).astype(np.float32))


def _estimator(optimizer="sgd", **cfg):
    context.init_zoo_context(**cfg)
    return Estimator(_build_model(), optimizer=optimizer, loss="mse",
                     device="cpu")


def _toy_params(seed=5):
    """Weights of ``_build_model``'s net by layer name, from a seed."""
    rs = np.random.RandomState(seed)
    return {"dense_1": {"kernel": (0.5 * rs.randn(4, 8)).astype(np.float32),
                        "bias": (0.1 * rs.randn(8)).astype(np.float32)},
            "dense_2": {"kernel": (0.5 * rs.randn(8, 1)).astype(np.float32),
                        "bias": (0.1 * rs.randn(1)).astype(np.float32)}}


def _leaves(est):
    return [t.detach().clone() for t in est.model.parameters()]


def _finite(est):
    return all(bool(torch.isfinite(p).all()) for p in est.model.parameters())


# ---------------------------------------------------------------------------
# RetryPolicy


class TestRetryPolicy:
    def test_call_retries_then_succeeds(self):
        sleeps = []
        p = RetryPolicy(max_attempts=5, base_delay_s=0.1, jitter=0.0,
                        retry_on=(OSError,), sleep=sleeps.append, seed=0)
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise OSError("blip")
            return "ok"

        assert p.call(flaky) == "ok"
        assert calls["n"] == 3
        assert sleeps == pytest.approx([0.1, 0.2])

    def test_call_exhausts_attempts(self):
        p = RetryPolicy(max_attempts=3, base_delay_s=0.0, jitter=0.0,
                        retry_on=(ValueError,), sleep=lambda s: None)
        n0 = TIMERS.count("robust/retry_exhausted/retry")
        with pytest.raises(ValueError):
            p.call(lambda: (_ for _ in ()).throw(ValueError("always")))
        assert TIMERS.count("robust/retry_exhausted/retry") == n0 + 1

    def test_delay_caps_at_max(self):
        p = RetryPolicy(base_delay_s=1.0, max_delay_s=4.0, multiplier=2.0,
                        jitter=0.0)
        assert p.delay(10) == 4.0

    def test_deadline_expiry(self):
        t = {"now": 0.0}
        p = RetryPolicy(max_attempts=100, base_delay_s=1.0, jitter=0.0,
                        deadline_s=2.5, retry_on=(OSError,),
                        sleep=lambda s: t.__setitem__("now", t["now"] + s),
                        clock=lambda: t["now"], name="dl_test")

        def fail():
            raise OSError("down")

        n0 = TIMERS.count("robust/retry_deadline/dl_test")
        with pytest.raises(RetryDeadlineExceeded):
            p.call(fail)
        assert TIMERS.count("robust/retry_deadline/dl_test") == n0 + 1

    def test_state_window_ages_out_failures(self):
        t = {"now": 0.0}
        st = RetryPolicy(max_attempts=2, window_s=10.0,
                         sleep=lambda s: None,
                         clock=lambda: t["now"]).state()
        assert st.record_failure()
        assert st.record_failure()
        assert not st.record_failure()
        t["now"] += 100.0
        assert st.record_failure()
        assert st.failures == 1

    def test_from_config_reads_the_knobs(self):
        cfg = context.init_zoo_context(retry_max_attempts=7,
                                       retry_base_delay_s=0.5,
                                       retry_deadline_s=9.0).config
        p = RetryPolicy.from_config(cfg, name="x")
        assert (p.max_attempts, p.base_delay_s, p.deadline_s,
                p.multiplier) == (7, 0.5, 9.0, 2.0)


# ---------------------------------------------------------------------------
# FaultInjector


class TestFaultInjector:
    def test_fires_at_exact_index(self):
        fi = FaultInjector().plan("site.x", at=2, exc=RuntimeError("boom"))
        with fi:
            faults.inject("site.x")
            faults.inject("site.x")
            with pytest.raises(RuntimeError, match="boom"):
                faults.inject("site.x")
        assert fi.fired["site.x"] == 1
        assert fi.calls("site.x") == 3

    def test_inactive_is_noop(self):
        assert faults.fire("site.unused") is None

    def test_nested_injectors_rejected(self):
        with FaultInjector():
            with pytest.raises(RuntimeError):
                FaultInjector().__enter__()


# ---------------------------------------------------------------------------
# checkpoint durability


class TestCheckpointDurability:
    def _tree(self, v):
        return {"params": {"w": np.full((4, 4), float(v), np.float32)},
                "meta": {"global_step": np.asarray(v)}}

    def test_torn_write_falls_back_to_intact(self, tmp_path):
        mgr = tckpt.CheckpointManager(str(tmp_path), keep=5)
        mgr.save(1, self._tree(1))
        mgr.save(2, self._tree(2))
        with FaultInjector().plan("checkpoint.write", at=0, action="torn"):
            mgr.save(3, self._tree(3))
        n0 = TIMERS.count("robust/ckpt_quarantined")
        step, tree = mgr.restore()
        assert step == 2
        assert float(tree["params"]["w"][0, 0]) == 2.0
        assert TIMERS.count("robust/ckpt_quarantined") == n0 + 1
        assert any(f.endswith(".corrupt") for f in os.listdir(tmp_path))
        assert tckpt.CheckpointManager(str(tmp_path)).latest_step() == 2

    def test_explicit_step_load_of_corrupt_raises(self, tmp_path):
        mgr = tckpt.CheckpointManager(str(tmp_path))
        with FaultInjector().plan("checkpoint.write", at=0, action="torn"):
            mgr.save(7, self._tree(7))
        with pytest.raises(Exception):
            mgr.restore(step=7)
        assert mgr.all_steps() == [7]           # not quarantined

    def test_bitflip_detected_by_crc(self, tmp_path):
        mgr = tckpt.CheckpointManager(str(tmp_path))
        mgr.save(1, self._tree(1))
        path = mgr.save(2, self._tree(2))
        blob = bytearray(open(path, "rb").read())
        mid = len(blob) // 2
        blob[mid] ^= 0xFF
        blob[mid + 1] ^= 0xFF
        with open(path, "wb") as f:
            f.write(bytes(blob))
        with pytest.raises(Exception):
            tckpt.load_pytree(path)
        step, _ = mgr.restore()
        assert step == 1

    def test_no_intact_checkpoint_is_explicit_error(self, tmp_path):
        mgr = tckpt.CheckpointManager(str(tmp_path))
        with FaultInjector().plan("checkpoint.write", at=0, action="torn"):
            mgr.save(1, self._tree(1))
        with pytest.raises(FileNotFoundError, match="no intact"):
            mgr.restore()

    def test_legacy_unmanifested_npz_still_loads(self, tmp_path):
        """An archive without ``__manifest__`` (the JAX package's format
        v1) loads unverified; its pickled treedef is never unpickled."""
        legacy = tmp_path / "old.npz"
        np.savez(legacy, **{"000000|w": np.arange(4.0),
                            "000001|v/0": np.ones(2),
                            "__treedef__": np.frombuffer(b"\x80\x04junk",
                                                         np.uint8)})
        out = tckpt.load_pytree(str(legacy))
        assert np.array_equal(out["w"], np.arange(4.0))
        assert np.array_equal(out["v"]["0"], np.ones(2))

    def test_gc_keep_with_async_writes(self, tmp_path):
        mgr = tckpt.CheckpointManager(str(tmp_path), keep=2)
        for s in range(1, 7):
            mgr.save_async(s, self._tree(s))
        mgr.wait()
        assert mgr.all_steps() == [5, 6]
        step, _ = mgr.restore()
        assert step == 6

    def test_port_tree_round_trip(self, tmp_path):
        """Tensors, sequences, strings and scalars come back as they went
        in (sequences as lists, tensors as arrays)."""
        tree = {"params": {"a": torch.arange(6.0).reshape(2, 3)},
                "opt_state": [torch.zeros((), dtype=torch.int32),
                              torch.ones(3)],
                "meta": {"s": np.asarray("unset"), "n": np.asarray(3),
                         "g": torch.Generator().manual_seed(1).get_state()},
                "state": {}}
        tckpt.save_pytree(str(tmp_path / "t.npz"), tree)
        out = tckpt.load_pytree(str(tmp_path / "t.npz"))
        assert out["opt_state"][0].dtype == np.int32
        np.testing.assert_array_equal(out["opt_state"][1], np.ones(3))
        np.testing.assert_array_equal(out["params"]["a"],
                                      tree["params"]["a"].numpy())
        assert str(out["meta"]["s"]) == "unset" and int(out["meta"]["n"]) == 3
        np.testing.assert_array_equal(out["meta"]["g"],
                                      tree["meta"]["g"].numpy())
        assert "state" not in out                # no leaves, no entry

    def test_save_async_copies_off_live_tensors(self, tmp_path):
        """The Estimator updates parameters in place: a step trained right
        after ``save_async`` must not reach the snapshot."""
        est = _estimator()
        x, y = _toy_data()
        est.fit(x, y, batch_size=8, epochs=1, verbose=False)
        want = export_params(est.model)
        state = [t.clone() for t in est.opt_state]
        mgr = tckpt.CheckpointManager(str(tmp_path))
        mgr.save_async(est.global_step, est._snapshot())
        est.fit(x, y, batch_size=8, epochs=3, verbose=False)
        mgr.wait()
        _, tree = mgr.restore()
        for layer, leaves in want.items():
            for leaf, w in leaves.items():
                np.testing.assert_array_equal(tree["params"][layer][leaf], w)
                assert not np.array_equal(
                    export_params(est.model)[layer][leaf], w)
        for a, b in zip(tree["opt_state"], state):
            np.testing.assert_array_equal(a, b.numpy())


# ---------------------------------------------------------------------------
# exact resume after preemption


def _ncf_setup(dropout, n=512):
    from analytics_zoo_tpu_torch.models import NeuralCF

    rs = np.random.RandomState(0)
    u = rs.randint(1, 51, (n, 1)).astype(np.int32)
    i = rs.randint(1, 41, (n, 1)).astype(np.int32)
    y = rs.randint(0, 5, n).astype(np.int32)
    kw = dict(user_embed=8, item_embed=8, hidden_layers=(16, 8), mf_embed=8,
              dropout=dropout)

    def make():
        reset_name_scope()
        ncf = NeuralCF(50, 40, device="cpu", **kw)
        return ncf

    wrs = np.random.RandomState(3)
    params = {layer: {leaf: (wrs.randn(*v.shape) * 0.1).astype(np.float32)
                      for leaf, v in sub.items()}
              for layer, sub in make().model.params().items()}
    return make, params, (u, i, y), kw


def _compiled(make, params):
    ncf = make()
    load_jax_params(ncf.model, params)
    ncf.compile(topt.Adam(lr=1e-3), "sparse_categorical_crossentropy")
    return ncf


class TestExactResume:
    @pytest.mark.parametrize("dropout", [0.0, 0.3])
    def test_resume_after_preemption_is_bit_exact(self, dropout, tmp_path):
        """Preempted in epoch 2 (step 9 of 16) through
        ``estimator.preempt`` and resumed by a fresh model: every
        parameter, every optimizer-state tensor, the dropout generator and
        the per-epoch losses equal the uninterrupted run's bit for bit;
        without dropout they also agree with the JAX package's run within
        the training slice's tolerance."""
        make, params, (u, i, y), kw = _ncf_setup(dropout)
        ref = _compiled(make, params)
        ref_hist = ref.fit([u, i], y, batch_size=32, nb_epoch=3,
                           verbose=False)
        n0 = TIMERS.count("robust/preempt_flush")
        ncf = _compiled(make, params)
        ncf.set_checkpoint(str(tmp_path))
        with FaultInjector().plan("estimator.preempt", at=16 + 9):
            with pytest.raises(TrainingPreempted):
                ncf.fit([u, i], y, batch_size=32, nb_epoch=3, verbose=False)
        assert TIMERS.count("robust/preempt_flush") == n0 + 1
        first = [h["loss"] for h in ncf.estimator.history]
        assert len(first) == 1

        again = make()                           # fresh random weights
        again.compile(topt.Adam(lr=1e-3), "sparse_categorical_crossentropy")
        again.set_checkpoint(str(tmp_path))
        hist = again.fit([u, i], y, batch_size=32, nb_epoch=3,
                         verbose=False, resume=True)
        assert again.estimator.finished_epochs == 3
        assert again.estimator.global_step == ref.estimator.global_step
        assert first + [h["loss"] for h in hist] == [
            h["loss"] for h in ref_hist]
        got, want = export_params(again.model), export_params(ref.model)
        for layer in want:
            for leaf in want[layer]:
                np.testing.assert_array_equal(got[layer][leaf],
                                              want[layer][leaf])
        for a, b in zip(again.estimator.opt_state, ref.estimator.opt_state):
            assert torch.equal(a, b)
        assert torch.equal(again.estimator._dropout_gen.get_state(),
                           ref.estimator._dropout_gen.get_state())
        if dropout:
            return
        import jax

        from analytics_zoo_tpu import init_zoo_context as jax_init_context
        from analytics_zoo_tpu.models import NeuralCF as JaxNCF
        from analytics_zoo_tpu.nn import reset_name_scope as jax_reset_names
        from analytics_zoo_tpu.train import optimizers as jopt

        jax_init_context()
        jax_reset_names()
        jncf = JaxNCF(50, 40, table_placement="replicated", **kw)
        jncf.compile(optimizer=jopt.Adam(lr=1e-3),
                     loss="sparse_categorical_crossentropy")
        jncf.estimator.set_initial_weights(params)
        jhist = jncf.fit([u, i], y, batch_size=32, nb_epoch=3,
                         verbose=False)
        np.testing.assert_allclose(first + [h["loss"] for h in hist],
                                   [h["loss"] for h in jhist], rtol=1e-4)
        jw = jax.tree_util.tree_map(np.asarray, jncf.estimator.params)
        for layer, leaves in jw.items():
            for leaf, w in leaves.items():
                np.testing.assert_allclose(got[layer][leaf], w, rtol=0,
                                           atol=1e-4)

    def test_snapshot_restores_every_tensor_bit_for_bit(self, tmp_path):
        """A preemption flush holds the live state at the step boundary:
        parameters, the flat optimizer state, the dropout generator,
        counters and the host RandomState."""
        make, params, (u, i, y), _ = _ncf_setup(0.3)
        ncf = _compiled(make, params)
        est = ncf.estimator
        ncf.set_checkpoint(str(tmp_path))
        live = {}

        class Spy(tckpt.CheckpointManager):
            def save(self, step, tree):
                live.update(params=export_params(ncf.model),
                            opt=[t.clone() for t in est.opt_state],
                            gen=est._dropout_gen.get_state(),
                            host=est._host_rng.get_state(),
                            step=est.global_step,
                            epochs=est.finished_epochs)
                return super().save(step, tree)

        est._ckpt_mgr = Spy(str(tmp_path))
        with FaultInjector().plan("estimator.preempt", at=21):
            with pytest.raises(TrainingPreempted):
                ncf.fit([u, i], y, batch_size=32, nb_epoch=2, verbose=False)
        _, tree = tckpt.CheckpointManager(str(tmp_path)).restore()
        for layer, leaves in live["params"].items():
            for leaf, w in leaves.items():
                np.testing.assert_array_equal(tree["params"][layer][leaf], w)
        for a, b in zip(tree["opt_state"], live["opt"]):
            np.testing.assert_array_equal(a, b.numpy())
        meta = tree["meta"]
        np.testing.assert_array_equal(meta["torch_rng"], live["gen"].numpy())
        assert int(meta["global_step"]) == live["step"] == 21
        assert int(meta["finished_epochs"]) == live["epochs"] == 1
        assert int(meta["in_epoch_step"]) == 5
        assert "rng" not in meta                 # the JAX snapshot's key
        import pickle

        host = pickle.loads(np.asarray(meta["host_rng"]).tobytes())
        assert host[0] == live["host"][0]
        np.testing.assert_array_equal(host[1], live["host"][1])
        assert host[2:] == live["host"][2:]

    def test_real_sigterm_flushes_and_raises(self, tmp_path):
        """The signal handler: a SIGTERM mid-fit flushes a final
        synchronous checkpoint and surfaces TrainingPreempted; the
        previous handler is back after fit."""
        before = signal.getsignal(signal.SIGTERM)
        x, y = _toy_data(n=256)
        est = _estimator()
        est.set_checkpoint(str(tmp_path))
        killer = threading.Timer(0.3, os.kill, (os.getpid(), signal.SIGTERM))
        killer.start()
        try:
            with pytest.raises(TrainingPreempted):
                est.fit(x, y, batch_size=8, epochs=2000, verbose=False)
        finally:
            killer.cancel()
        assert signal.getsignal(signal.SIGTERM) == before
        assert est._ckpt_mgr.latest_step() == est.global_step
        est2 = _estimator()
        est2.set_checkpoint(str(tmp_path))
        est2.fit(x, y, batch_size=8, epochs=est.finished_epochs + 1,
                 verbose=False, resume=True)
        assert est2.finished_epochs == est.finished_epochs + 1

    def test_sigterm_from_a_fault_site_hook(self, tmp_path):
        """The ``sigterm`` action sends the real signal at a fixed step,
        through the handler: the flush lands at that step."""
        x, y = _toy_data()
        est = _estimator()
        est.set_checkpoint(str(tmp_path))
        with FaultInjector().plan("estimator.preempt", at=11,
                                  action="sigterm"):
            with pytest.raises(TrainingPreempted) as info:
                est.fit(x, y, batch_size=8, epochs=3, verbose=False)
        assert info.value.step == 11 == est._ckpt_mgr.latest_step()

    def test_resume_without_checkpoint_starts_fresh(self, tmp_path):
        x, y = _toy_data()
        est = _estimator()
        est.set_checkpoint(str(tmp_path))
        est.fit(x, y, batch_size=8, epochs=1, verbose=False, resume=True)
        assert est.finished_epochs == 1
        # the checkpoint_dir knob serves fit(resume=True) without
        # set_checkpoint
        est2 = _estimator(checkpoint_dir=str(tmp_path))
        est2.fit(x, y, batch_size=8, epochs=2, verbose=False, resume=True)
        assert est2.finished_epochs == 2 and est2.global_step == 16

    def test_device_resident_resume_drops_a_mid_epoch_marker(self, tmp_path,
                                                             caplog):
        x, y = _toy_data()
        est = _estimator()
        est.set_checkpoint(str(tmp_path))
        with FaultInjector().plan("estimator.preempt", at=11):
            with pytest.raises(TrainingPreempted):
                est.fit(x, y, batch_size=8, epochs=3, verbose=False)
        est2 = _estimator()
        est2.set_checkpoint(str(tmp_path))
        with caplog.at_level("WARNING", "analytics_zoo_tpu_torch.train"):
            est2.fit(torch.from_numpy(x), torch.from_numpy(y), batch_size=8,
                     epochs=3, verbose=False, resume=True)
        assert "epoch boundaries" in caplog.text
        assert est2.finished_epochs == 3
        # epoch 2 restarts from the weights at the flush: 8 + 8 more steps
        assert est2.global_step == 11 + 8 + 8


# ---------------------------------------------------------------------------
# NaN guard policies


class TestNaNGuard:
    def test_happy_path_checks_once_per_epoch(self):
        est = _estimator()
        x, y = _toy_data()
        n0 = TIMERS.count("robust/guard_check")
        est.fit(x, y, batch_size=8, epochs=3, verbose=False)
        assert TIMERS.count("robust/guard_check") - n0 == 3

    def test_skip_policy_discards_bad_update(self):
        est = _estimator(nan_policy="skip")
        x, y = _toy_data()
        n0 = TIMERS.count("robust/nan_steps")
        s0 = TIMERS.count("robust/nan_skipped")
        with FaultInjector().plan("estimator.step", at=3, action="nan"):
            est.fit(x, y, batch_size=8, epochs=1, verbose=False)
        assert TIMERS.count("robust/nan_steps") - n0 == 1
        assert TIMERS.count("robust/nan_skipped") - s0 == 1
        assert _finite(est) and np.isfinite(est.history[-1]["loss"])

    def test_raise_policy_surfaces(self):
        est = _estimator(nan_policy="raise")
        x, y = _toy_data()
        n0 = TIMERS.count("robust/nan_raised")
        with FaultInjector().plan("estimator.step", at=2, action="nan"):
            with pytest.raises(FloatingPointError):
                est.fit(x, y, batch_size=8, epochs=1, verbose=False)
        assert TIMERS.count("robust/nan_raised") == n0 + 1
        assert _finite(est)

    def test_rollback_restores_and_backs_off_lr_like_jax(self, tmp_path):
        """Three NaN steps in epoch 2 roll back to epoch 1's checkpoint
        and halve ``lr_scale``; training goes on with a finite, falling
        loss, and lands within atol 1e-5 (losses rtol 1e-4) of the JAX
        package's run of the same scenario from the same weights."""
        import jax

        from analytics_zoo_tpu import init_zoo_context as jax_init_context
        from analytics_zoo_tpu.nn import Sequential as JaxSequential
        from analytics_zoo_tpu.nn import reset_name_scope as jax_reset_names
        from analytics_zoo_tpu.nn.layers.core import Dense as JaxDense
        from analytics_zoo_tpu.robust import FaultInjector as JaxInjector
        from analytics_zoo_tpu.train.estimator import Estimator as JaxEst

        x, y = _toy_data()
        init = _toy_params()
        est = _estimator(nan_policy="rollback", max_bad_steps=2,
                         nan_backoff_factor=0.5)
        est.set_initial_weights(init)
        est.set_checkpoint(str(tmp_path / "port"))
        n0 = TIMERS.count("robust/nan_rollbacks")
        with FaultInjector().plan("estimator.step", at=[8, 9, 10],
                                  action="nan"):
            hist = est.fit(x, y, batch_size=8, epochs=3, verbose=False)
        assert TIMERS.count("robust/nan_rollbacks") == n0 + 1
        assert est._lr_scale == pytest.approx(0.5)
        assert est.finished_epochs == 3 and _finite(est)
        assert all(np.isfinite(h["loss"]) for h in hist)
        assert hist[-1]["loss"] < hist[0]["loss"]

        jax_init_context(nan_policy="rollback", max_bad_steps=2,
                         nan_backoff_factor=0.5)
        jax_reset_names()
        jest = JaxEst(JaxSequential([JaxDense(8, input_shape=(4,),
                                              activation="relu"),
                                     JaxDense(1)]), optimizer="sgd",
                      loss="mse")
        jest.set_initial_weights(init)
        jest.set_checkpoint(str(tmp_path / "jax"))
        with JaxInjector().plan("estimator.step", at=[8, 9, 10],
                                action="nan"):
            jhist = jest.fit(x, y, batch_size=8, epochs=3, verbose=False)
        assert jest._lr_scale == pytest.approx(0.5)
        np.testing.assert_allclose([h["loss"] for h in hist],
                                   [h["loss"] for h in jhist], rtol=1e-4)
        jw = jax.tree_util.tree_map(np.asarray, jest.params)
        got = export_params(est.model)
        for layer, leaves in jw.items():
            for leaf, w in leaves.items():
                np.testing.assert_allclose(got[layer][leaf], w, rtol=0,
                                           atol=1e-5)

    def test_nan_fault_on_an_id_batch_poisons_its_loss(self, tmp_path):
        """NeuralCF's batches hold ids and integer labels only: the
        ``estimator.step`` NaN fault makes their loss NaN, and
        ``max_bad_steps`` of them in a row roll back."""
        make, params, (u, i, y), _ = _ncf_setup(0.0)
        context.init_zoo_context(nan_policy="rollback", max_bad_steps=2)
        ncf = _compiled(make, params)
        ncf.set_checkpoint(str(tmp_path))
        n0 = TIMERS.count("robust/nan_rollbacks")
        with FaultInjector().plan("estimator.step", at=[17, 18],
                                  action="nan"):
            hist = ncf.fit([u, i], y, batch_size=32, nb_epoch=3,
                           verbose=False)
        assert TIMERS.count("robust/nan_rollbacks") == n0 + 1
        assert ncf.estimator._lr_scale == 0.5
        # the rolled-back epoch 2 ran twice; the step count restarts from
        # the checkpoint with it
        assert ncf.estimator.global_step == 16 * 3
        assert [np.isfinite(h["loss"]) for h in hist] == [True] * 3

    def test_lr_scale_scales_every_update(self):
        """``lr_scale`` 0.5 with SGD(lr) moves the weights as SGD(lr/2)."""
        x, y = _toy_data()
        a = _estimator(optimizer=topt.SGD(lr=0.02))
        a._lr_scale = 0.5
        a.fit(x, y, batch_size=8, epochs=2, verbose=False)
        b = _estimator(optimizer=topt.SGD(lr=0.01))
        b.fit(x, y, batch_size=8, epochs=2, verbose=False)
        for p, q in zip(_leaves(a), _leaves(b)):
            torch.testing.assert_close(p, q, rtol=1e-6, atol=0)

    def test_device_resident_path_counts_bad_steps(self):
        from analytics_zoo_tpu_torch.data import FeatureSet

        est = _estimator(nan_policy="skip", data_cache_level="DEVICE")
        x, y = _toy_data()
        fs = FeatureSet.from_ndarrays(x, y).cache("DEVICE")
        n0 = TIMERS.count("robust/nan_steps")
        with FaultInjector().plan("estimator.resident_nan_rows", at=0,
                                  action="nan", payload=list(range(8))):
            est.fit(fs, batch_size=8, epochs=2, shuffle=False, verbose=False)
        assert est.last_data_path == "device_resident"
        assert TIMERS.count("robust/nan_steps") - n0 == 1
        assert _finite(est)


# ---------------------------------------------------------------------------
# prefetch producer


class TestPrefetchRobustness:
    def test_producer_crash_mid_epoch_recovers(self, tmp_path):
        est = _estimator(failure_retry_times=3, retry_base_delay_s=0.01)
        est.set_checkpoint(str(tmp_path))
        x, y = _toy_data()
        n0 = TIMERS.count("robust/retry_attempts/estimator_fit")
        with FaultInjector().plan("prefetch.producer", at=11,
                                  exc=RuntimeError("disk died")) as fi:
            est.fit(x, y, batch_size=8, epochs=2, verbose=False)
        assert fi.fired["prefetch.producer"] == 1
        assert est.finished_epochs == 2 and est.global_step == 16
        assert TIMERS.count(
            "robust/retry_attempts/estimator_fit") == n0 + 1

    def test_producer_crash_without_checkpoint_raises(self):
        est = _estimator()
        x, y = _toy_data()
        with FaultInjector().plan("prefetch.producer", at=2,
                                  exc=RuntimeError("disk died")):
            with pytest.raises(RuntimeError, match="disk died"):
                est.fit(x, y, batch_size=8, epochs=1, verbose=False)

    def test_close_is_idempotent(self):
        it = PrefetchIterator(iter(range(100)), depth=2)
        assert next(it) == 0
        it.close()
        it.close()

    def test_stuck_producer_is_abandoned_with_warning(self, caplog):
        release = threading.Event()

        def slow_items():
            yield 1
            release.wait(10.0)
            yield 2

        it = PrefetchIterator(slow_items(), depth=1)
        assert next(it) == 1
        with caplog.at_level("WARNING", logger="analytics_zoo_tpu_torch.train"):
            it.close(timeout=0.2)
        assert any("did not stop" in r.message for r in caplog.records)
        release.set()

    def test_prefetch_depth_keeps_the_step_sequence(self):
        """``data_prefetch`` 0 (in line) and 3 train the same weights."""
        x, y = _toy_data()
        out = []
        for depth in (0, 3):
            est = _estimator(data_prefetch=depth)
            est.fit(x, y, batch_size=8, epochs=2, verbose=False)
            out.append(_leaves(est))
        for a, b in zip(*out):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# persistence, against the JAX package


def _jax_ncf(params, users=50, items=40, **kw):
    from analytics_zoo_tpu import init_zoo_context as jax_init_context
    from analytics_zoo_tpu.models import NeuralCF as JaxNCF
    from analytics_zoo_tpu.nn import reset_name_scope as jax_reset_names

    jax_init_context()
    jax_reset_names()
    jncf = JaxNCF(users, items, table_placement="replicated", **kw)
    jncf.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    jncf.estimator.set_initial_weights(params)
    return jncf


def test_jax_saved_model_loads_and_predicts(tmp_path):
    """A directory written by the JAX package's ``NeuralCF.save_model``
    loads through the port's ``ZooModel.load_model`` and predicts within
    1e-6 of the JAX model, through ``predict`` and ``InferenceModel``."""
    from analytics_zoo_tpu_torch.deploy import InferenceModel
    from analytics_zoo_tpu_torch.models import NeuralCF
    from analytics_zoo_tpu_torch.models.common import ZooModel

    make, params, (u, i, _), kw = _ncf_setup(0.0)
    kw.pop("dropout")
    jncf = _jax_ncf(params, **kw)
    want = np.asarray(jncf.predict([u, i], batch_size=64))
    jncf.save_model(str(tmp_path))
    reset_name_scope()
    got = ZooModel.load_model(str(tmp_path), device="cpu")
    assert isinstance(got, NeuralCF) and got.config() == json.load(
        open(tmp_path / "config.json"))["config"]
    got.compile("adam", "sparse_categorical_crossentropy")
    np.testing.assert_allclose(got.predict([u, i], batch_size=64), want,
                               rtol=0, atol=1e-6)
    im = InferenceModel.from_keras_net(got.model, device="cpu")
    np.testing.assert_allclose(im.predict([u, i]), want, rtol=0, atol=1e-6)


def test_port_saved_model_round_trips(tmp_path):
    """``save_model`` → ``load_model`` of a trained port model answers
    bit-equal, and its archive is the JAX layout."""
    from analytics_zoo_tpu_torch.deploy import InferenceModel
    from analytics_zoo_tpu_torch.models.common import ZooModel

    make, params, (u, i, y), _ = _ncf_setup(0.0)
    ncf = _compiled(make, params)
    ncf.fit([u, i], y, batch_size=32, nb_epoch=1, verbose=False)
    ncf.save_model(str(tmp_path))
    back = ZooModel.load_model(str(tmp_path), device="cpu")
    a = InferenceModel.from_keras_net(ncf.model, device="cpu").predict([u, i])
    b = InferenceModel.from_keras_net(back.model, device="cpu").predict([u, i])
    np.testing.assert_array_equal(a, b)
    with np.load(tmp_path / "weights.npz") as z:
        keys = [k.split("|", 1)[1] for k in z.files if "|" in k]
    assert "params/ncf_head/kernel" in keys and len(keys) == len(
        [1 for sub in params.values() for _ in sub])


def test_archive_keys_and_crcs_match_jax(tmp_path):
    """The port's ``save_pytree`` and the JAX package's on the same
    parameter tree write the same leaf keys, dtypes, shapes and CRC32s
    (every manifest entry but ``__treedef__``); each loads the other's
    leaves."""
    from analytics_zoo_tpu.train import checkpoint as jckpt

    _, params, _, _ = _ncf_setup(0.0)
    tree = {"params": params, "state": {}}
    jckpt.save_pytree(str(tmp_path / "j.npz"), tree)
    tckpt.save_pytree(str(tmp_path / "t.npz"), tree)
    manifests = []
    for name in ("j.npz", "t.npz"):
        with np.load(tmp_path / name) as z:
            m = json.loads(z["__manifest__"].tobytes())
            assert sorted(z.files) == sorted(list(m["leaves"])
                                             + ["__manifest__"])
        m["leaves"].pop("__treedef__")
        manifests.append(m)
    assert manifests[0] == manifests[1]
    back = tckpt.load_pytree(str(tmp_path / "j.npz"))
    for layer, leaves in params.items():
        for leaf, w in leaves.items():
            np.testing.assert_array_equal(back["params"][layer][leaf], w)


def test_save_and_load_weights(tmp_path):
    """``save_weights`` → ``load_weights`` on a fine-tuned net gives
    identical predictions; an archive from the JAX ``save_weights``
    loads too."""
    from analytics_zoo_tpu.nn import Sequential as JaxSequential

    est = _estimator()
    x, y = _toy_data()
    net = est.model
    est.fit(x, y, batch_size=8, epochs=2, verbose=False)
    want = est.predict(x)
    net.save_weights(str(tmp_path / "w.npz"))
    fresh = _estimator()
    p, s = fresh.model.load_weights(str(tmp_path / "w.npz"))
    assert s == {} and set(p) == set(export_params(net))
    np.testing.assert_array_equal(fresh.predict(x), want)
    JaxSequential().save_weights(str(tmp_path / "j.npz"),
                                 export_params(net), {})
    third = _estimator()
    third.model.load_weights(str(tmp_path / "j.npz"))
    np.testing.assert_array_equal(third.predict(x), want)
