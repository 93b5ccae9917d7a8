"""The port's TensorBoard writer, summaries, reports and profiling helpers
against the JAX package.

The event files are compared byte for byte in meaning: a file written by
either package reads in the other (``read_scalars``), with the same
(step, value) pairs; f32 scalars round-trip exactly.  The training
scalars are the history's values, exactly.
"""

import json
import os

import numpy as np
import pytest
import torch

from analytics_zoo_tpu.core import profiling as jprof
from analytics_zoo_tpu.core import summary as jsummary
from analytics_zoo_tpu.observe.metrics import MetricsRegistry as JaxRegistry
from analytics_zoo_tpu.observe.export import \
    publish_to_summary as jax_publish

from analytics_zoo_tpu_torch.core import context, profiling, summary
from analytics_zoo_tpu_torch.models import NeuralCF
from analytics_zoo_tpu_torch.nn import Dense, Sequential, reset_name_scope
from analytics_zoo_tpu_torch.observe import (TRACER, MetricsRegistry,
                                             publish_to_summary, span)
from analytics_zoo_tpu_torch.observe import metrics as obs
from analytics_zoo_tpu_torch.train import LocalEstimator


@pytest.fixture(autouse=True)
def fresh_context():
    context.set_zoo_context(None)
    yield
    context.set_zoo_context(None)


# ---------------------------------------------------------------------------
# the event files


def test_crc32c_matches_jax_and_the_check_value():
    assert summary.crc32c(b"123456789") == 0xE3069283
    rs = np.random.RandomState(0)
    for n in (0, 1, 7, 64, 1000):
        data = rs.bytes(n)
        assert summary.crc32c(data) == jsummary.crc32c(data)
        assert summary._masked_crc(data) == jsummary._masked_crc(data)


@pytest.mark.parametrize("writer_pkg", ["port", "jax"])
def test_event_files_read_in_either_package(tmp_path, writer_pkg):
    mod = summary if writer_pkg == "port" else jsummary
    w = mod.SummaryWriter(str(tmp_path))
    vals = [(0, 1.5), (3, -2.25), (2 ** 40, 3.0e-8)]
    for step, v in vals:
        w.add_scalar("loss", v, step)
    w.add_scalar("other", 7.0, 1)
    w.close()
    want = [(s, float(np.float32(v))) for s, v in vals]
    assert summary.read_scalars(str(tmp_path), "loss") == want
    assert jsummary.read_scalars(str(tmp_path), "loss") == want
    assert summary.read_scalars(str(tmp_path), "other") == [(1, 7.0)]
    # the same records, byte for byte but the wall times
    assert summary.encode_scalar_event("t", 0.5, 9, 1.0) == \
        jsummary.encode_scalar_event("t", 0.5, 9, 1.0)


def test_read_scalars_keeps_records_before_a_torn_tail(tmp_path):
    w = summary.SummaryWriter(str(tmp_path))
    w.add_scalar("loss", 1.0, 1)
    w.add_scalar("loss", 2.0, 2)
    w.close()
    with open(w.path, "rb+") as f:
        f.truncate(os.path.getsize(w.path) - 5)
    assert summary.read_scalars(str(tmp_path), "loss") == [(1, 1.0)]
    assert jsummary.read_scalars(str(tmp_path), "loss") == [(1, 1.0)]


def test_publish_to_summary_matches_jax(tmp_path):
    """The same registry contents publish the same scalars: counters and
    gauges under their series names, histograms as p50 and p99."""
    regs = (MetricsRegistry(), JaxRegistry())
    for reg in regs:
        reg.inc("train_steps_total", 5, kind="1")
        reg.set("train_loss", 0.25)
        for v in (0.1, 0.2, 0.3, 0.4):
            reg.observe("train_step_seconds", v, kind="K")
    out = {}
    for name, reg, pub, mod in (("port", regs[0], publish_to_summary,
                                 summary),
                                ("jax", regs[1], jax_publish, jsummary)):
        d = str(tmp_path / name)
        w = mod.SummaryWriter(d)
        out[name] = pub(w, 11, registry=reg)
        w.close()
        for tag in ('train_steps_total{kind="1"}', "train_loss",
                    'train_step_seconds{kind="K"}/p99'):
            out[(name, tag)] = summary.read_scalars(d, tag)
    assert out["port"] == out["jax"] == 4
    for tag in ('train_steps_total{kind="1"}', "train_loss",
                'train_step_seconds{kind="K"}/p99'):
        assert out[("port", tag)] == out[("jax", tag)] != []
    w = summary.SummaryWriter(str(tmp_path / "prefix"))
    assert publish_to_summary(w, 1, registry=regs[0], prefix="train_loss") \
        == 1


# ---------------------------------------------------------------------------
# profiling and spans


def test_timers_scope_report_gauge_reset_match_jax():
    got, want = profiling.Timers(), jprof.Timers()
    for t in (got, want):
        t.observe("a", 0.002)
        t.observe("a", 0.004)
        t.observe("b", 0.010)
        t.incr("events", 3)
        t.set_gauge("level", 2.5)
    assert got.report() == want.report()
    assert got.gauge("level") == 2.5 and got.gauge("none", -1.0) == -1.0
    with got.scope("c"):
        pass
    assert got.stats()["c"]["count"] == 1
    got.reset()
    assert got.stats() == {} and got.counts() == {} and got.gauges() == {}
    before = profiling.TIMERS.count("port_test/event")
    profiling.count_event("port_test/event", 2)
    with profiling.timeit("port_test/scope"):
        pass
    assert profiling.TIMERS.count("port_test/event") == before + 2
    assert profiling.TIMERS.stats()["port_test/scope"]["count"] >= 1


def test_trace_writes_a_profile_and_refuses_nesting(tmp_path):
    with profiling.trace(str(tmp_path / "t"), annotation="region"):
        with profiling.annotate("inner"):
            torch.ones(4).sum()
        with pytest.raises(RuntimeError, match="active"):
            with profiling.trace(str(tmp_path / "u")):
                pass
    with open(tmp_path / "t" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"region", "inner"} <= names
    assert not (tmp_path / "u").exists()


def test_trace_never_stops_a_profiler_that_failed_to_start(tmp_path,
                                                           monkeypatch):
    calls = []

    class Broken:
        def __init__(self, **kw):
            pass

        def __enter__(self):
            raise RuntimeError("no profiler here")

        def __exit__(self, *a):
            calls.append("exit")

    monkeypatch.setattr(torch.profiler, "profile", Broken)
    with pytest.raises(RuntimeError, match="no profiler"):
        with profiling.trace(str(tmp_path)):
            pass
    assert calls == []
    monkeypatch.undo()
    with profiling.trace(str(tmp_path / "again")):      # not left active
        pass


def test_span_context_manager_ends_ok_or_error():
    before = TRACER.completed_count()
    with span("port_test/ok", epoch=3) as sp:
        trace = sp.trace
    with pytest.raises(ValueError):
        with span("port_test/bad", trace=trace, parent=sp.sid):
            raise ValueError("boom")
    assert TRACER.completed_count() == before + 2
    done = {s["name"]: s for s in TRACER.spans(trace=trace)}
    assert done["port_test/ok"]["status"] == "ok"
    assert done["port_test/bad"]["status"] == "error"
    assert done["port_test/bad"]["parent"] == sp.sid


# ---------------------------------------------------------------------------
# training summaries and reports


def _net():
    reset_name_scope()
    net = Sequential([Dense(8, activation="relu", input_shape=(4,)),
                      Dense(1)])
    return net


def _data(n=64):
    rs = np.random.RandomState(1)
    x = rs.randn(n, 4).astype(np.float32)
    return x, (x @ rs.randn(4, 1)).astype(np.float32)


def test_set_tensorboard_writes_each_epoch_and_validation(tmp_path):
    """``KerasNet.set_tensorboard`` before ``compile`` carries into the
    estimator under ``log_dir/app_name``; one ``loss`` point per epoch at
    the global step, equal to the history, and the validation's."""
    x, y = _data()
    net = _net()
    net.set_tensorboard(str(tmp_path), app_name="run")
    net.compile("adam", "mse", metrics=["mae"], device="cpu")
    hist = net.fit(x, y, batch_size=16, epochs=3, verbose=False,
                   validation_data=(x[:20], y[:20]))
    d = str(tmp_path / "run")
    loss = summary.read_scalars(d, "loss")
    assert loss == [(4 * (e + 1), float(np.float32(h["loss"])))
                    for e, h in enumerate(hist)]
    assert [v for _, v in summary.read_scalars(d, "val_mae")] == \
        [float(np.float32(h["val_mae"])) for h in hist]
    assert len(summary.read_scalars(d, "throughput")) == 3
    # the JAX reader reads the port's files
    assert jsummary.read_scalars(d, "loss") == loss
    wrote = net.estimator.publish_metrics()
    assert wrote > 0
    assert summary.read_scalars(d, "train_loss")[-1][0] == 12


def test_zoo_model_set_tensorboard_and_training_report(tmp_path):
    rs = np.random.RandomState(2)
    u = rs.randint(1, 31, (64, 1)).astype(np.int32)
    i = rs.randint(1, 21, (64, 1)).astype(np.int32)
    y = rs.randint(0, 5, 64).astype(np.int32)
    reset_name_scope()
    m = NeuralCF(30, 20, user_embed=4, item_embed=4, hidden_layers=(8,),
                 mf_embed=4, device="cpu")
    m.compile("adam", "sparse_categorical_crossentropy")
    m.set_tensorboard(str(tmp_path))
    hist = m.fit([u, i], y, batch_size=16, nb_epoch=2, verbose=False)
    assert len(summary.read_scalars(str(tmp_path / "zoo"), "loss")) == 2
    est = m.estimator
    rep = est.training_report()
    assert rep["global_step"] == 8 and rep["finished_epochs"] == 2
    assert rep["last_data_path"] == "host_prefetch"
    assert rep["history"] == hist
    delta = rep["metrics_delta"]
    assert json.dumps(delta)        # serialisable, as health() is
    spans = TRACER.spans(trace=rep["fit_trace"])
    names = [s["name"] for s in spans]
    assert names.count("train/epoch") == 2 and "train/fit" in names
    assert names.count("train/step") == 8
    fit = next(s for s in spans if s["name"] == "train/fit")
    assert all(s["parent"] == fit["sid"] for s in spans
               if s["name"] == "train/epoch")
    text = est.metrics_text()
    assert "train_loss" in text and "train_steps_total" in text
    assert est.publish_metrics() > 0
    assert summary.read_scalars(str(tmp_path / "zoo"), "train_loss")


def test_publish_metrics_without_a_writer_is_zero():
    x, y = _data()
    net = _net()
    net.compile("adam", "mse", device="cpu")
    net.fit(x, y, batch_size=16, epochs=1, verbose=False)
    assert net.estimator.publish_metrics() == 0
    assert obs.METRICS.snapshot().gauges[("train_loss", ())] == \
        net.estimator.history[-1]["loss"]


def test_keras_net_summary_lists_the_layers(capsys):
    x, y = _data()
    net = _net()
    net.compile("adam", "mse", device="cpu")
    net.fit(x, y, batch_size=16, epochs=1, verbose=False)
    out = net.summary()
    assert out in capsys.readouterr().out
    lines = out.splitlines()
    assert lines[0] == f"Model: {net.name}"
    assert lines[-1] == "Total params: 49"      # 4*8 + 8 + 8*1 + 1
    assert [ln.split()[-1] for ln in lines[2:4]] == ["40", "9"]


def test_local_estimator_is_the_estimator_on_one_device():
    x, y = _data()
    net = _net()
    est = LocalEstimator(net, optimizer="adam", loss="mse", device="cpu")
    hist = est.fit(x, y, batch_size=16, epochs=2, verbose=False)
    assert len(hist) == 2 and est.device.type == "cpu"
    assert est.predict(x, batch_size=16).shape == (64, 1)
