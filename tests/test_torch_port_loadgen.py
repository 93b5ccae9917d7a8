"""The port's load harness (``analytics_zoo_tpu_torch.loadgen``) against the
JAX package's, on the CPU.

The numpy layer is copied, so it must give the same bytes: schedules
from ``arrival_times`` for every shape over three seeds, the payload
draws of every class (``ZipfianIdPayload`` against both packages'
``zipfian_ids``), the shifting mix, ``saturated_images``, and every SLO
fold on the same records.  ``_outcome_of`` classifies the JAX package's
own error payloads as the JAX function does, and the catalog declares
the JAX ``loadgen_*`` metrics.

The legs then run on the port's ``ClusterServing`` with models on
``device="cpu"``: the adversarial floods come back typed, as in the JAX
package; a stalled executor cannot slow the schedule (judged by the
offered rate over the scheduled rate, which a loaded host does not
move, not by absolute lag); one short kill leg SIGKILLs a real
``server_main --device cpu`` process mid-storm and its successor serves
from the compile cache with zero live captures; one ``client_main``
process drives a ``server_main`` over a FileQueue spool.  The
full-length soaks are marked ``slow``, as the JAX package marks its own.

Every wait takes a deadline and every worker is stopped in ``finally``.
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

from analytics_zoo_tpu.data import zipf as jzipf
from analytics_zoo_tpu.loadgen import arrivals as jarr
from analytics_zoo_tpu.loadgen import client as jclient
from analytics_zoo_tpu.loadgen import payloads as jpay
from analytics_zoo_tpu.loadgen import slo as jslo
from analytics_zoo_tpu_torch.data import zipf as tzipf
from analytics_zoo_tpu_torch.loadgen import arrivals as tarr
from analytics_zoo_tpu_torch.loadgen import client as tclient
from analytics_zoo_tpu_torch.loadgen import payloads as tpay
from analytics_zoo_tpu_torch.loadgen import slo as tslo

SEEDS = (0, 7, 123)


def _shape(mod, kind):
    """One traffic shape of each kind, built from ``mod``'s classes."""
    if kind == "steady":
        return mod.Steady(60.0)
    if kind == "ramp":
        return mod.DiurnalRamp(10.0, 90.0, period_s=4.0)
    if kind == "burst":
        return mod.FlashCrowd(20.0, 180.0, at_s=1.5, dur_s=1.0)
    return mod.ShapeSum([mod.Steady(5.0),
                         mod.FlashCrowd(10.0, 70.0, at_s=2.0, dur_s=0.5)])


# -- arrivals ----------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", ["steady", "ramp", "burst", "sum"])
def test_arrival_times_are_the_jax_bytes(kind, seed):
    want = jarr.arrival_times(_shape(jarr, kind), 5.0, seed)
    got = tarr.arrival_times(_shape(tarr, kind), 5.0, seed)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    assert (tarr.interarrivals(got).tobytes()
            == jarr.interarrivals(want).tobytes())
    ts = np.linspace(-1.0, 6.0, 57)
    j, t = _shape(jarr, kind), _shape(tarr, kind)
    assert [t.rate(x) for x in ts] == [j.rate(x) for x in ts]
    assert t.peak_rate() == j.peak_rate() and repr(t) == repr(j)


def test_degenerate_shapes_raise_as_in_jax():
    for mod in (jarr, tarr):
        for bad in (lambda: mod.Steady(0.0),
                    lambda: mod.arrival_times(mod.Steady(10.0), 0.0, 0),
                    lambda: mod.FlashCrowd(10.0, 5.0, 1.0, 1.0),
                    lambda: mod.DiurnalRamp(0.0, 10.0, 60.0),
                    lambda: mod.ShapeSum([])):
            with pytest.raises(ValueError):
                bad()
    assert tarr.interarrivals(np.zeros(1)).size == 0


# -- payloads ----------------------------------------------------------------

@pytest.mark.parametrize("s", [0.0, 0.8, 1.0, 1.3])
def test_zipf_ids_are_the_jax_bytes(s):
    assert (tzipf.zipf_weights(3707, s).tobytes()
            == jzipf.zipf_weights(3707, s).tobytes())
    for seed in SEEDS:
        assert (tzipf.zipfian_ids(3707, 500, s, seed=seed).tobytes()
                == jzipf.zipfian_ids(3707, 500, s, seed=seed).tobytes())
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        a = [tzipf.zipfian_ids(64, 9, s, rng=r1) for _ in range(3)]
        b = [jzipf.zipfian_ids(64, 9, s, rng=r2) for _ in range(3)]
        assert [x.tobytes() for x in a] == [x.tobytes() for x in b]
    with pytest.raises(ValueError, match="vocab"):
        tzipf.zipf_weights(0)


def test_payload_classes_draw_the_jax_bytes():
    specs = [dict(model="m", shape=(8, 8, 3), dtype="uint8", high=256),
             dict(model="m", shape=(5,), dtype="int32", low=3, high=40),
             dict(model="m", shape=(4,), dtype="float32"),
             dict(model="m", shape=(2, 3), dtype="float16", low=-1.0)]
    for seed in SEEDS:
        rj = np.random.Generator(np.random.PCG64(seed))
        rt = np.random.Generator(np.random.PCG64(seed))
        for spec in specs:
            a = tpay.PayloadClass(**spec).draw(rt)
            b = jpay.PayloadClass(**spec).draw(rj)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        zt = tpay.ZipfianIdPayload("ncf", (2,), vocab=3707, s=1.0)
        zj = jpay.ZipfianIdPayload("ncf", (2,), vocab=3707, s=1.0)
        a, b = zt.draw(rt), zj.draw(rj)
        assert a.dtype == b.dtype == np.int32 and a.tobytes() == b.tobytes()
        assert repr(zt) == repr(zj)
        # the class draws exactly what zipfian_ids draws from that state
        got = zt.draw(np.random.default_rng(seed))
        want = jzipf.zipfian_ids(3707, 2, 1.0, seed=seed)
        assert got.tobytes() == want.tobytes()
    with pytest.raises(ValueError, match="vocab"):
        tpay.ZipfianIdPayload("m", shape=(4,), vocab=0)


def _mix(mod):
    return mod.PayloadMix(
        [mod.ZipfianIdPayload("ncf", (2,), vocab=3707, s=1.0, weight=64.0,
                              field="x"),
         mod.PayloadClass("bert", (128,), dtype="int32", weight=1.0,
                          field="ids", high=30522),
         mod.PayloadClass("echo", (4,), dtype="float32", weight=3.0,
                          ttl_ms=50.0)],
        shift_at_s=2.0, shift_weights=[1.0, 1.0, 6.0])


def test_payload_mix_draws_and_shift_are_the_jax_bytes():
    tm, jm = _mix(tpay), _mix(jpay)
    assert tm.models() == jm.models() == ["ncf", "bert", "echo"]
    for t in (0.0, 1.99, 2.0, 5.0):
        assert tm.weights(t).tobytes() == jm.weights(t).tobytes()
        assert tm.model_weights(t) == jm.model_weights(t)
    for seed in SEEDS:
        rt = np.random.Generator(np.random.PCG64(seed))
        rj = np.random.Generator(np.random.PCG64(seed))
        times = tarr.arrival_times(tarr.Steady(100.0), 4.0, seed)
        for t in times:
            (ct, pt), (cj, pj) = tm.draw(rt, t=t), jm.draw(rj, t=t)
            assert (ct.model, ct.field, ct.ttl_ms) == (cj.model, cj.field,
                                                       cj.ttl_ms)
            assert pt.dtype == pj.dtype and pt.tobytes() == pj.tobytes()
    with pytest.raises(ValueError):
        tpay.PayloadMix([tpay.PayloadClass("a", (1,))], shift_at_s=1.0)


def test_saturated_images_are_the_jax_bytes():
    a = tpay.saturated_images(3, rs=np.random.RandomState(7),
                              shape=(16, 16, 3))
    b = jpay.saturated_images(3, rs=np.random.RandomState(7),
                              shape=(16, 16, 3))
    assert [x.tobytes() for x in a] == [x.tobytes() for x in b]
    assert (tpay.saturated_images(2, seed=7)[1].tobytes()
            == jpay.saturated_images(2, seed=7)[1].tobytes())


# -- the SLO fold -------------------------------------------------------------

OUTCOMES = ("ok", "ok", "ok", "ok", "overloaded", "expired", "lost",
            "dropped", "model_error", "malformed")


def _records(seed, n=400, duration=8.0):
    """The same records for both packages: models a/b, every outcome, a
    latency spike in [3, 5) s."""
    rs = np.random.RandomState(seed)
    t = np.sort(rs.uniform(0.0, duration, n))
    rows = []
    for i, ts in enumerate(t):
        outcome = OUTCOMES[rs.randint(len(OUTCOMES))]
        lat = rs.exponential(0.02) + (0.4 if 3.0 <= ts < 5.0 else 0.0)
        sent = ts + rs.exponential(0.001)
        done = (None if outcome in ("lost", "dropped")
                else ts + lat)
        rows.append((f"u{i:04d}", "ab"[rs.randint(2)], float(ts),
                     None if outcome == "dropped" else float(sent),
                     done, outcome))
    return ([jclient.RequestRecord(*r) for r in rows],
            [tclient.RequestRecord(*r) for r in rows])


@pytest.mark.parametrize("seed", SEEDS)
def test_slo_folds_equal_the_jax_folds(seed, tmp_path):
    jrec, trec = _records(seed)
    assert [r.as_dict() for r in trec] == [r.as_dict() for r in jrec]
    assert ([(r.latency_s, r.lag_s) for r in trec]
            == [(r.latency_s, r.lag_s) for r in jrec])
    lats = [r.latency_s for r in trec if r.latency_s is not None]
    for q in (0, 50, 90, 99, 100):
        assert tslo.percentile(lats, q) == jslo.percentile(lats, q)
    assert tslo.percentile([], 99) is None
    assert tslo.outcome_counts(trec) == jslo.outcome_counts(jrec)
    assert (tslo.shed_fraction_by_model(trec)
            == jslo.shed_fraction_by_model(jrec))
    for window_s, duration in ((1.0, 8.0), (0.5, None)):
        tw = tslo.fold_windows(trec, window_s, duration)
        jw = jslo.fold_windows(jrec, window_s, duration)
        assert tw == jw
        for slo_ms in ({"a": 100.0}, {"a": 100.0, "b": 30.0},
                       {"a": 0.0, "b": 1e4}):
            for k in (1, 2, 3):
                assert (tslo.sustained_qps_at_slo(tw, slo_ms, k)
                        == jslo.sustained_qps_at_slo(jw, slo_ms, k))
            for event in (0.0, 2.5, 5.0, 7.9):
                assert (tslo.recovery_time_to_slo(tw, event, slo_ms)
                        == jslo.recovery_time_to_slo(jw, event, slo_ms))
    report = {"windows": tslo.fold_windows(trec, 1.0, 8.0), "n": len(trec)}
    tslo.write_artifact(str(tmp_path / "t.json"), report)
    jslo.write_artifact(str(tmp_path / "j.json"), report)
    assert (tmp_path / "t.json").read_bytes() == (tmp_path
                                                  / "j.json").read_bytes()
    with pytest.raises(ValueError):
        tslo.write_artifact(str(tmp_path / "t.json"), {"x": float("nan")})
    assert json.loads((tmp_path / "t.json").read_text()) == report
    with pytest.raises(ValueError):
        tslo.fold_windows(trec, 0.0)


def test_outcome_of_reads_the_jax_error_payloads():
    from analytics_zoo_tpu.deploy.serving import error_payload
    from analytics_zoo_tpu_torch.deploy.serving import (
        error_payload as port_error_payload)

    vals = [error_payload(code, "boom", uri="u")
            for code in ("expired", "overloaded", "malformed",
                         "decode_error", "model_error", "internal")]
    vals += [port_error_payload("expired", "late", uri="u"),
             {"error": "x"}, {"error": "x", "code": ""}, {"no_error": 1},
             np.zeros(4), [[1, 0.5]], None]
    got = [tclient._outcome_of(v) for v in vals]
    assert got == [jclient._outcome_of(v) for v in vals]
    assert got[:7] == ["expired", "overloaded", "malformed", "decode_error",
                       "model_error", "internal", "expired"]


def test_catalog_declares_the_jax_loadgen_metrics():
    from analytics_zoo_tpu.observe.metrics import CATALOG as JAX_CATALOG
    from analytics_zoo_tpu_torch.observe.metrics import CATALOG

    names = [n for n in JAX_CATALOG if n.startswith("loadgen_")]
    assert len(names) == 4
    for n in names:
        assert CATALOG[n][0] == JAX_CATALOG[n][0]
        assert CATALOG[n][2] == JAX_CATALOG[n][2]


# -- legs on the port's ClusterServing, models on the CPU --------------------

def _serve_echo(**cfg):
    import torch  # noqa: F401

    from analytics_zoo_tpu_torch.deploy import (ClusterServing,
                                                InferenceModel, MemoryQueue,
                                                ServingConfig)

    m = InferenceModel.from_function(lambda x: x * 2.0, device="cpu",
                                     batch_buckets=(1, 8))
    q = MemoryQueue()
    srv = ClusterServing({"echo": m}, q, ServingConfig(
        batch_size=8, poll_timeout_s=0.02, max_batch_delay_ms=3,
        decode_workers=2, **cfg)).start()
    return srv, q


def test_adversarial_floods_come_back_typed_as_in_jax():
    """Malformed and expired-TTL floods on both packages' workers give
    the same typed codes record by record, and a slow client's held
    answers are served while a neighbour is answered."""
    from analytics_zoo_tpu.deploy import ClusterServing as JaxCS
    from analytics_zoo_tpu.deploy import InferenceModel as JaxIM
    from analytics_zoo_tpu.deploy import MemoryQueue as JaxMQ
    from analytics_zoo_tpu.deploy import ServingConfig as JaxCfg
    from analytics_zoo_tpu.loadgen import adversarial as jadv
    from analytics_zoo_tpu_torch.deploy import InputQueue, OutputQueue
    from analytics_zoo_tpu_torch.loadgen import adversarial as tadv

    def codes(srv, q, adv, inq, outq):
        try:
            mal = adv.malformed_flood(q, n=9)
            ttl = adv.expired_ttl_flood(inq, model="echo", n=6, ttl_ms=0.01)
            return ([outq.query(r, timeout=30.0).get("code") for r in mal],
                    [outq.query(u, timeout=30.0).get("code") for u in ttl])
        finally:
            srv.stop()

    srv, q = _serve_echo()
    got = codes(srv, q, tadv, InputQueue(q), OutputQueue(q))
    from analytics_zoo_tpu.deploy import InputQueue as JaxIn
    from analytics_zoo_tpu.deploy import OutputQueue as JaxOut

    jq = JaxMQ()
    jsrv = JaxCS({"echo": JaxIM(lambda xs: xs[0] * 2.0,
                                batch_buckets=(1, 8))}, jq, JaxCfg(
        batch_size=8, poll_timeout_s=0.02, max_batch_delay_ms=3,
        decode_workers=2)).start()
    want = codes(jsrv, jq, jadv, JaxIn(jq), JaxOut(jq))
    assert got[0] == want[0]
    assert all(c in ("malformed", "decode_error") for c in got[0]), got
    assert all(c in ("expired", "overloaded") for c in got[1]), got
    assert all(c in ("expired", "overloaded") for c in want[1]), want


def test_slow_client_holds_results_without_starving_neighbour():
    from analytics_zoo_tpu_torch.deploy import InputQueue, OutputQueue
    from analytics_zoo_tpu_torch.loadgen.adversarial import SlowClient

    srv, q = _serve_echo()
    try:
        inp, outp = InputQueue(q), OutputQueue(q)
        slow = SlowClient(inp, outp, model="echo", n=4, hold_s=0.5)
        slow.send()
        inp.enqueue(uri="nb", model="echo", x=np.ones((4,), np.float32))
        np.testing.assert_allclose(np.asarray(outp.query("nb", timeout=30.0)),
                                   np.full((4,), 2.0), rtol=1e-6)
        held = slow.collect(timeout_s=30.0)
        assert len(held) == 4
        rng = np.random.Generator(np.random.PCG64(0))
        for i in range(4):
            x = rng.uniform(0, 1, (4,)).astype(np.float32)
            np.testing.assert_allclose(np.asarray(held[f"slow-{i:04d}"]),
                                       2.0 * x, rtol=1e-6)
    finally:
        srv.stop()


def test_stalled_executor_cannot_slow_the_schedule():
    """The open-loop guarantee: each forward sleeps 0.3 s, far past the
    25 ms mean gap, yet every slot fires and the offered rate stays the
    scheduled rate (a closed-loop client would offer about 3 of the 40
    requests/s).  Judged by the rate ratio, which a loaded host moves by
    its sleep overshoot alone, not by the p99 lag."""
    from analytics_zoo_tpu_torch.loadgen.harness import run_open_loop_check

    sec = run_open_loop_check(qps=40.0, duration_s=1.0, stall_s=0.3, seed=2)
    assert sec["scheduled"] == len(jarr.arrival_times(jarr.Steady(40.0),
                                                      1.0, 2))
    assert sec["sent"] == sec["scheduled"]
    assert sec["offered_to_scheduled_rate"] > 0.8, sec
    assert sec["service_p99_ms"] > sec["mean_interarrival_ms"], sec


def test_add_scenario_check_rides_the_supervisor():
    import threading

    fired = threading.Event()
    srv, _ = _serve_echo(supervisor_interval_s=0.01)
    try:
        assert srv.add_scenario_check("probe", fired.set, every=2)
        assert fired.wait(10.0)
    finally:
        srv.stop()
    srv, _ = _serve_echo(supervise=False)
    try:
        assert srv.add_scenario_check("probe", fired.set) is False
    finally:
        srv.stop()


def test_steady_and_burst_legs_on_the_port():
    from analytics_zoo_tpu_torch.loadgen import harness

    steady = harness.run_steady_leg(qps=60.0, duration_s=1.5, seed=11,
                                    backend="memory")
    sched = jarr.arrival_times(jarr.Steady(60.0), 1.5, 11)
    assert steady["wire"] == "memory" and steady["offered"] == len(sched)
    assert steady["outcomes"] == {"ok": len(sched)}, steady
    assert steady["open_loop_drops"] == 0
    burst = harness.run_burst_leg(base_qps=20.0, burst_qps=120.0, at_s=0.5,
                                  dur_s=0.5, duration_s=2.0, seed=13,
                                  backend="memory")
    assert burst["offered"] == len(jarr.arrival_times(
        jarr.FlashCrowd(20.0, 120.0, 0.5, 0.5), 2.0, 13))
    assert burst["outcomes"].get("lost", 0) == 0, burst
    assert "recovery_after_burst_s" in burst
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        harness.run_pod_kill_leg("unused")


# -- real processes ----------------------------------------------------------

def test_kill_leg_warm_restarts_from_the_cache(tmp_path):
    """A ``server_main --device cpu`` worker is SIGKILLed mid-storm and
    its supervisor forks the successor over the same spool and compile
    cache: the successor has the predecessor's fingerprint (it warms
    every signature) and captures nothing live, and so does a fresh
    interpreter started on the same caches after the storm; loss is
    bounded by what the killed process held (a 2 s drain: answers come
    within milliseconds of the restart, and a lost record would hold
    the default 60 s one to its end)."""
    from analytics_zoo_tpu_torch.loadgen.harness import run_kill_leg

    sec = run_kill_leg(str(tmp_path / "kill"), qps=20.0, duration_s=6.0,
                       kill_at_s=2.0, slo_ms=2000.0, seed=29, device="cpu",
                       drain_timeout_s=2.0)
    assert sec["offered"] == len(jarr.arrival_times(jarr.Steady(20.0),
                                                    6.0, 29))
    assert sec["cold_compile_count"] >= 3, sec
    assert sec["warm_compile_count"] == 0, sec
    assert sec["warm_count"] >= 3 and (sec["warm_cache_hits"] or 0) >= 3
    assert sec["lost"] <= 32, sec
    assert sec["answered_ok"] > 0.5 * sec["offered"], sec
    assert sec["server2_exit_rc"] == 0
    assert sec["server1_exit_rc"] == -signal.SIGKILL, sec
    assert 0.0 < sec["restart_ready_s"] < 60.0, sec
    assert sec["fresh_compile_count"] == 0, sec
    assert sec["fresh_start_ready_s"] > 0.0, sec


def test_server_main_worker_restarts_and_stops_with_its_supervisor(
        tmp_path):
    """``server_main``'s supervisor forks a successor for a worker that
    dies by a signal (the successor's status names the death), and a
    SIGTERM to the supervisor stops the worker and exits 0."""
    from analytics_zoo_tpu_torch.loadgen.harness import (
        start_server_process, wait_for_status)

    spool, cache = tmp_path / "spool", tmp_path / "cache"
    spool.mkdir()
    cache.mkdir()
    status = str(tmp_path / "server.status.json")
    server = start_server_process(str(spool), str(cache), status,
                                  str(tmp_path / "server.log"),
                                  device="cpu")
    try:
        st1 = wait_for_status(status, timeout_s=60.0, require="ready",
                              proc=server)
        assert st1["supervisor_pid"] == server.pid != st1["pid"]
        assert st1["restarts"] == 0 and st1["previous_exit"] is None
        os.kill(st1["pid"], signal.SIGSEGV)
        st2 = wait_for_status(status, timeout_s=60.0, require="ready",
                              proc=server, not_pid=st1["pid"])
        assert st2["restarts"] == 1, st2
        assert st2["previous_exit"] == -signal.SIGSEGV, st2
        assert st2["compile_count"] == 0 and st2["warm_count"] == 3, st2
    finally:
        server.send_signal(signal.SIGTERM)
        rc = server.wait(timeout=30)
    assert rc == 0
    with pytest.raises(ProcessLookupError):
        os.kill(st2["pid"], 0)


def test_server_caches_bytecode_only_where_torch_ships_none(
        tmp_path, monkeypatch):
    import importlib.util

    from analytics_zoo_tpu_torch.loadgen import server_main

    shipped = tmp_path / "shipped.pyc"
    monkeypatch.setattr(importlib.util, "cache_from_source",
                        lambda path: str(shipped))
    monkeypatch.setattr(sys, "pycache_prefix", None)
    monkeypatch.setattr(sys, "dont_write_bytecode", True)
    assert server_main.cache_bytecode(str(tmp_path)) == str(
        tmp_path / "bytecode")
    assert sys.pycache_prefix == str(tmp_path / "bytecode")
    assert sys.dont_write_bytecode is False
    monkeypatch.setattr(sys, "pycache_prefix", None)
    monkeypatch.setattr(sys, "dont_write_bytecode", True)
    shipped.touch()
    assert server_main.cache_bytecode(str(tmp_path)) is None
    assert sys.pycache_prefix is None and sys.dont_write_bytecode is True


def test_client_main_process_drives_server_main(tmp_path):
    from analytics_zoo_tpu_torch.loadgen.harness import (
        SERVER_QUEUE_NAME, _loadgen_env, start_server_process,
        wait_for_status)

    spool, cache = tmp_path / "spool", tmp_path / "cache"
    spool.mkdir()
    cache.mkdir()
    status = tmp_path / "server.status.json"
    server = start_server_process(str(spool), str(cache), str(status),
                                  str(tmp_path / "server.log"),
                                  slo_ms=5000.0, device="cpu")
    try:
        st = wait_for_status(str(status), timeout_s=60.0, require="ready",
                             proc=server)
        assert st["device"] == "cpu" and st["compile_count"] == 3
        out = tmp_path / "c0.json"
        res = subprocess.run(
            [sys.executable, "-m", "analytics_zoo_tpu_torch.loadgen."
             "client_main", "--queue-root", str(spool), "--queue-name",
             SERVER_QUEUE_NAME, "--outfile", str(out), "--leg", "fanin0",
             "--uri-prefix", "fanin0", "--qps", "15", "--duration-s", "2",
             "--seed", "100"], env=_loadgen_env(), capture_output=True,
            text=True, timeout=90)
        assert res.returncode == 0, res.stderr[-3000:]
    finally:
        server.terminate()
        server.wait(timeout=30)
    assert server.returncode == 0
    summary = json.loads(out.read_text())
    assert summary["scheduled"] == len(jarr.arrival_times(
        jarr.Steady(15.0), 2.0, 100))
    assert summary["sent"] == summary["scheduled"]
    assert summary["open_loop_drops"] == 0
    assert summary["outcomes"] == {"ok": summary["offered"]}, summary


# -- the full-length soaks (slow, as the JAX package's) ----------------------

@pytest.mark.slow
def test_kill_mid_storm_soak_recovers_to_slo(tmp_path):
    from analytics_zoo_tpu_torch.loadgen.harness import run_kill_leg

    sec = run_kill_leg(str(tmp_path / "kill"), qps=30.0, duration_s=16.0,
                       kill_at_s=6.0, slo_ms=2000.0, seed=29, device="cpu")
    assert sec["warm_compile_count"] == 0, sec
    assert sec["cold_compile_count"] >= 3, sec
    assert sec["recovery_after_kill_s"] is not None, sec
    assert sec["recovery_after_kill_s"] < 10.0, sec
    assert sec["lost"] <= 32, sec
    assert sec["answered_ok"] > 0.5 * sec["offered"], sec
    assert sec["server2_exit_rc"] == 0


@pytest.mark.slow
def test_mix_shift_soak_sheds_selectively_without_flaps():
    from analytics_zoo_tpu_torch.loadgen.harness import run_mix_shift_leg

    sec = run_mix_shift_leg(duration_s=14.0, qps=60.0, shift_at_s=5.0,
                            seed=17, backend="memory")
    assert sec["lost"] == 0, sec["outcomes"]
    assert sec["shed_fraction_laggy"] > 0.0, sec
    assert sec["shed_fraction_echo"] == 0.0, sec
    assert sec["autoscale_actions"] >= 1, sec
    assert sec["autoscale_flaps"] == 0, sec
