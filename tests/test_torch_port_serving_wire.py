"""The port's serving wire and its self-healing pieces, on the CPU.

- The binary codec (``deploy/codec.py``) against the JAX package's: a
  frame packed by either package unpacks in the other to the same
  values, and packs back to the same bytes, for f32, int32, uint8 and
  bf16 tensors (the port spells bf16 without ``ml_dtypes``).
- The queue contract of the JAX package's ``test_queue_contract.py`` for
  the port's memory, file and shared-memory queues, the shared-memory
  specifics (typed backpressure, client-side size check, leases, dead
  result leases reclaimed, unlink on stop) and a client in another
  process attached to the worker's segment by name.
- The circuit breaker, the supervisor, the DynamicBatcher's
  ``dispatch_fn`` mode and the DeviceExecutor's self-healing (retry on a
  healthy peer, the sync fallback, the harvest watchdog, thread respawn,
  slot rebuild), as the JAX package's ``test_serving_chaos.py`` and
  ``test_serving_pipeline.py`` hold them.

Every wait has a deadline and every thread a join timeout.
"""

import gc
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import ml_dtypes
import numpy as np
import pytest

from analytics_zoo_tpu.deploy import codec as jcodec

from analytics_zoo_tpu_torch.core.profiling import TIMERS
from analytics_zoo_tpu_torch.deploy import (ClusterServing, DeviceExecutor,
                                            DynamicBatcher, FileQueue,
                                            MemoryQueue, ServingConfig,
                                            ShmQueue, decode_tensor,
                                            encode_tensor, make_queue,
                                            make_queue_from_zoo,
                                            shm_available)
from analytics_zoo_tpu_torch.deploy import codec as tcodec
from analytics_zoo_tpu_torch.deploy.inference import (ModelReplica,
                                                      bucket_class,
                                                      plan_buckets)
from analytics_zoo_tpu_torch.deploy.serving import _decode_record
from analytics_zoo_tpu_torch.deploy.shmqueue import live_segments
from analytics_zoo_tpu_torch.robust import (CircuitBreaker, FaultInjector,
                                            Heartbeat, MalformedRecordError,
                                            ServingOverloaded, Supervisor)

ROOT = Path(__file__).resolve().parents[1]
needs_shm = pytest.mark.skipif(
    not shm_available(), reason="POSIX shared memory unavailable here")


# ---------------------------------------------------------------------------
# the codec, both ways


def _tensor(dtype, seed):
    rs = np.random.RandomState(seed)
    if dtype == "bfloat16":
        return rs.randn(3, 5).astype(ml_dtypes.bfloat16)
    if dtype == "uint8":
        return rs.randint(0, 256, (4, 6)).astype(np.uint8)
    if dtype == "int32":
        return rs.randint(-2**31, 2**31 - 1, (7,)).astype(np.int32)
    return rs.randn(2, 3, 4).astype(np.float32)


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8).reshape(-1)


@pytest.mark.parametrize("dtype", ["float32", "int32", "uint8", "bfloat16"])
def test_codec_frames_cross_both_ways(dtype):
    a = _tensor(dtype, 0)
    rec = {"uri": "r1", "ts": 12.5, "fmt": "tensor", "ttl_ms": 30.0,
           "legacy": {"b64": "AAAA", "shape": [1], "dtype": "float32"},
           "x": a, "y": np.arange(3, dtype=np.int32)}
    jbytes = bytes(jcodec.pack_record(rec))
    got = tcodec.unpack_record(jbytes)
    assert got["uri"] == "r1" and got["ttl_ms"] == 30.0
    assert got["legacy"] == rec["legacy"]
    assert got["x"].shape == a.shape
    assert tcodec.wire_name(got["x"].dtype) == dtype
    np.testing.assert_array_equal(_bits(got["x"]), _bits(a))
    # the port packs it back to the JAX frame, byte for byte
    assert bytes(tcodec.pack_record(got)) == jbytes
    assert tcodec.packed_nbytes(got) == len(jbytes)
    # and a frame the port packs unpacks in the JAX package
    back = jcodec.unpack_record(bytes(tcodec.pack_record(got)))
    assert back["x"].dtype == a.dtype
    np.testing.assert_array_equal(_bits(back["x"]), _bits(a))
    # results too: tensor envelopes, error payloads and top-N pairs
    for value in ({"tensor": a}, {"error": "e", "code": "expired"},
                  [[1, 0.5], [0, 0.25]]):
        jres = jcodec.pack_result(value)
        assert tcodec.pack_result(tcodec.unpack_result(jres)) == jres


def test_bf16_crosses_to_torch_bits():
    import torch

    a = _tensor("bfloat16", 1)
    t = tcodec.bf16_to_torch(tcodec.unpack_record(
        bytes(jcodec.pack_record({"x": a})))["x"])
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
    np.testing.assert_array_equal(_bits(tcodec.torch_to_bf16(t)), _bits(a))


# ---------------------------------------------------------------------------
# queue contract (memory, file, shm)


@pytest.fixture(params=["memory", "file",
                        pytest.param("shm", marks=needs_shm)])
def queue(request, tmp_path):
    if request.param == "file":
        yield FileQueue(str(tmp_path / "spool"))
    elif request.param == "shm":
        q = ShmQueue(name="contract", slots=8, slot_bytes=1 << 16,
                     push_timeout_s=0.25)
        yield q
        q.stop()
    else:
        yield MemoryQueue()


def _payload(a, q):
    return a if getattr(q, "wire", "json") == "binary" else encode_tensor(a)


class TestQueueContract:
    def test_push_pop_fifo_ordering(self, queue):
        for i in range(5):
            queue.push({"uri": f"r{i}", "fmt": "tensor",
                        "x": _payload(np.full((4,), i, np.float32), queue)})
        assert len(queue) == 5
        got = queue.pop_batch(5, timeout=1.0)
        assert [rid for rid, _ in got] == [f"r{i}" for i in range(5)]
        for i, (_, rec) in enumerate(got):
            np.testing.assert_array_equal(
                decode_tensor(rec["x"]), np.full((4,), i, np.float32))
        assert len(queue) == 0
        assert queue.pop_batch(1, timeout=0.05) == []

    def test_trim_drops_oldest(self, queue):
        for i in range(5):
            queue.push({"uri": f"r{i}",
                        "x": _payload(np.zeros(2, np.float32), queue)})
        assert queue.trim(2) == 3
        assert [rid for rid, _ in queue.pop_batch(5, timeout=1.0)] == [
            "r3", "r4"]

    def test_legacy_b64_records_decode_everywhere(self, queue):
        a = np.arange(12, dtype=np.float32).reshape(3, 4)
        queue.push({"uri": "legacy", "fmt": "tensor", "x": encode_tensor(a)})
        [(rid, rec)] = queue.pop_batch(1, timeout=1.0)
        assert rid == "legacy"
        np.testing.assert_array_equal(_decode_record(rec)["x"], a)

    def test_results_and_uniform_timeout(self, queue):
        queue.set_result("rid-1", [1, 2, 3])
        assert queue.get_result("rid-1", timeout=2.0) == [1, 2, 3]
        assert "rid-1" not in queue.pending_results()
        with pytest.raises(TimeoutError) as ei:
            queue.get_result("missing-rid", timeout=0.05)
        assert type(queue).__name__ in str(ei.value)
        assert "no result for 'missing-rid'" in str(ei.value)
        queue.push({"uri": "h0",
                    "x": _payload(np.zeros(2, np.float32), queue)})
        h = queue.health()
        assert h["ok"] is True and h["depth"] == 1


def test_make_queue_lowers_the_ported_backends(tmp_path, monkeypatch):
    assert isinstance(make_queue("memory"), MemoryQueue)
    assert isinstance(make_queue("file", root=str(tmp_path)), FileQueue)
    # without the redis package the Redis backend raises ImportError, and
    # no other queue stands in for it
    monkeypatch.setitem(sys.modules, "redis", None)
    with pytest.raises(ImportError):
        make_queue("redis")
    with pytest.raises(ValueError, match="unknown queue backend"):
        make_queue("kafka")
    from analytics_zoo_tpu_torch.core.config import ZooConfig

    cfg = ZooConfig(serving_queue_backend="shm", serving_shm_slots=4,
                    serving_shm_slot_bytes=1 << 12)
    if shm_available():
        q = make_queue_from_zoo(cfg)
        try:
            assert isinstance(q, ShmQueue)
            assert (q.slots, q.slot_bytes) == (4, 1 << 12)
        finally:
            q.stop()
    sc = ServingConfig.from_zoo(ZooConfig(serving_batch_size=7,
                                          serving_breaker_threshold=1))
    assert (sc.batch_size, sc.breaker_threshold) == (7, 1)
    # tensorboard_dir: the JAX package's serving scalars, as TensorBoard
    # events that read_scalars reads back
    from analytics_zoo_tpu_torch.core.summary import read_scalars

    cs = ClusterServing({"m": SimpleNamespace()}, MemoryQueue(),
                        ServingConfig(tensorboard_dir=str(tmp_path / "tb")))
    cs.records_served = 40
    cs._maybe_tb_flush()
    cs.stop()
    assert read_scalars(str(tmp_path / "tb"), "total_records") == [(40, 40.0)]
    assert len(read_scalars(str(tmp_path / "tb"), "serving_throughput")) == 1
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        ServingConfig(mesh_replicas=1)


def test_plan_buckets_and_bucket_class():
    assert plan_buckets(300, (1, 8, 64, 256)) == [(256, 256), (44, 64)]
    assert plan_buckets(3, (1, 8)) == [(3, 8)]
    assert bucket_class(None) == "short" and bucket_class(32768) == "long_doc"
    assert plan_buckets(3, (2, 8), tokens=40000) == [(2, 2), (1, 2)]


@needs_shm
class TestShmSpecific:
    def _q(self, **kw):
        kw.setdefault("slots", 4)
        kw.setdefault("slot_bytes", 1 << 14)
        kw.setdefault("push_timeout_s", 0.2)
        return ShmQueue(name="shmspec", **kw)

    def test_slot_exhaustion_is_typed_backpressure(self):
        q = self._q(slots=2, push_timeout_s=0.15)
        try:
            w0 = TIMERS.count("serving/shm_backpressure_waits")
            q.push({"uri": "a", "x": np.zeros(4, np.float32)})
            q.push({"uri": "b", "x": np.zeros(4, np.float32)})
            with pytest.raises(ServingOverloaded,
                               match="slot-exhaustion backpressure"):
                q.push({"uri": "c", "x": np.zeros(4, np.float32)})
            assert TIMERS.count("serving/shm_backpressure_waits") > w0
        finally:
            q.stop()
        assert q.segment not in live_segments()

    def test_oversized_record_rejected_client_side(self):
        q = self._q(slot_bytes=1 << 10)
        try:
            with pytest.raises(MalformedRecordError, match="slot_bytes"):
                q.push({"uri": "big", "x": np.zeros((1 << 12,), np.uint8)})
            assert len(q) == 0
        finally:
            q.stop()

    def test_lease_recycles_slot_after_views_die(self):
        q = self._q(slots=2)
        try:
            q.push({"uri": "l0", "x": np.arange(8, dtype=np.float32)})
            [(_, rec)] = q.pop_batch(1, timeout=1.0)
            view = rec["x"]
            assert not view.flags.writeable
            assert q.leased_slots() == 1
            del rec, view
            gc.collect()
            assert q.leased_slots() == 0
            assert q.health()["slots_free"] == 2
        finally:
            q.stop()

    def test_dead_lease_holder_result_slot_reclaimed(self):
        q = self._q(slots=4)
        try:
            # a client process pushes one record and dies without ever
            # reading its result
            child = (
                "import sys, numpy as np\n"
                "from analytics_zoo_tpu_torch.deploy.shmqueue import "
                "ShmQueue\n"
                "ShmQueue.attach(sys.argv[1]).push({'uri': 'dead1', "
                "'x': np.ones((2, 2), np.float32)})\n")
            subprocess.run([sys.executable, "-c", child, q.segment],
                           env=dict(os.environ, PYTHONPATH=str(ROOT)),
                           check=True, timeout=120)
            got = q.pop_batch(4, timeout=1.0)
            assert [rid for rid, _ in got] == ["dead1"]
            del got
            gc.collect()
            q.set_result_many([("dead1", {"ok": True})])
            q.set_result("live1", {"ok": True})
            assert q.reclaim_dead_result_leases() == 1
            assert q.pending_results() == ["live1"]
            assert q.reclaim_dead_result_leases() == 0
        finally:
            q.stop()

    def test_unlink_on_stop_leaves_no_segment(self):
        q = self._q()
        seg = q.segment
        assert seg in live_segments()
        q.stop()
        assert seg not in live_segments()
        assert not os.path.exists(os.path.join("/dev/shm", seg))
        q.stop()
        assert q.health()["closed"] is True
        with pytest.raises(RuntimeError):
            q.push({"uri": "late", "x": np.zeros(2, np.float32)})

    def test_client_in_another_process_attaches_by_name(self):
        """The worker makes the segment; a client process attaches by
        name, pushes 40 records from one thread while it reads their
        answers from another, and the worker answers each (the sum of
        its tensor).  The client's stop leaves the segment to the owner;
        the owner's unlinks it."""
        q = self._q(slots=8)
        client = (
            "import sys, threading, numpy as np\n"
            "from analytics_zoo_tpu_torch.deploy.shmqueue import ShmQueue\n"
            "q = ShmQueue.attach(sys.argv[1])\n"
            "rids = [f'c{i}' for i in range(40)]\n"
            "t = threading.Thread(target=lambda: [q.push({'uri': r, 'x': "
            "np.full(3, int(r[1:]), np.int32)}) for r in rids])\n"
            "t.start()\n"
            "ok = all(q.get_result(r, timeout=20) == 3 * int(r[1:]) "
            "for r in rids)\n"
            "t.join(20)\n"
            "q.stop()\n"
            "sys.exit(0 if ok else 3)\n")
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        try:
            proc = subprocess.Popen([sys.executable, "-c", client,
                                     q.segment], env=env)
            served, deadline = 0, time.monotonic() + 60
            while served < 40 and time.monotonic() < deadline:
                for rid, rec in q.pop_batch(8, timeout=0.1):
                    q.set_result(rid, int(rec["x"].sum()))
                    served += 1
            assert proc.wait(timeout=60) == 0
            assert served == 40
            assert q.segment in live_segments()   # the client left it
        finally:
            q.stop()
        assert not os.path.exists(os.path.join("/dev/shm", q.segment))


# ---------------------------------------------------------------------------
# breaker and supervisor


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class TestCircuitBreaker:
    def test_opens_at_consecutive_threshold_only(self):
        br = CircuitBreaker(failure_threshold=3, cooldown_s=1.0,
                            name="pt1", clock=_FakeClock())
        assert br.health == "healthy" and br.allow()
        assert not br.record_failure()
        assert not br.record_failure()
        br.record_success()
        assert not br.record_failure()
        assert not br.record_failure()
        assert br.record_failure()
        assert br.health == "quarantined" and not br.allow()

    def test_half_open_single_probe_then_close(self):
        clk = _FakeClock()
        br = CircuitBreaker(failure_threshold=1, cooldown_s=2.0,
                            name="pt2", clock=clk)
        br.record_failure()
        clk.t = 1.0
        assert not br.allow()
        clk.t = 2.5
        assert br.allow()
        assert not br.allow()
        assert br.record_success()
        assert br.health == "healthy" and br.allow()

    def test_failed_probe_reopens_and_force_open(self):
        clk = _FakeClock()
        br = CircuitBreaker(failure_threshold=1, cooldown_s=1.0,
                            name="pt3", clock=clk)
        br.record_failure()
        clk.t = 1.5
        assert br.allow()
        assert br.record_failure()
        assert br.snapshot()["opens"] == 2
        br2 = CircuitBreaker(failure_threshold=5, name="pt4")
        assert br2.force_open() and not br2.force_open()
        assert br2.snapshot()["state"] == "open"


class TestSupervisor:
    def test_checks_run_and_throwing_check_survives(self):
        hits = []
        sup = Supervisor(interval_s=0.01, name="psup")

        def bad():
            raise RuntimeError("check exploded")

        sup.add_check("bad", bad)
        sup.add_check("good", lambda: hits.append(1))
        sup.start()
        try:
            deadline = time.monotonic() + 5.0
            while len(hits) < 3 and time.monotonic() < deadline:
                time.sleep(0.01)
        finally:
            sup.stop()
        assert len(hits) >= 3
        assert TIMERS.count("robust/supervisor_check_error/bad") >= 3
        assert not sup.is_alive()
        sup.stop()

    def test_heartbeat_ages(self):
        clk = _FakeClock()
        hb = Heartbeat(clock=clk)
        assert hb.age("poller") == 0.0
        hb.beat("poller")
        clk.t = 3.0
        assert hb.ages() == {"poller": pytest.approx(3.0)}


# ---------------------------------------------------------------------------
# the batcher's dispatch_fn mode


def _wait_for(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.005)
    return pred()


class TestDynamicBatcher:
    def test_deadline_flush_under_trickle(self):
        flushes = []
        b = DynamicBatcher(max_batch=64, max_latency_ms=50,
                           dispatch_fn=lambda k, fused, reqs: flushes.append(
                               (time.monotonic(), fused[0].shape[0])))
        try:
            t0 = time.monotonic()
            b.submit(np.ones((1, 4), np.float32), lambda out, err: None)
            assert _wait_for(lambda: flushes)
            assert 0.03 <= flushes[0][0] - t0 <= 0.5
        finally:
            b.close()

    def test_full_batch_preempts_deadline_and_models_never_fuse(self):
        flushes = []
        b = DynamicBatcher(max_batch=4, max_latency_ms=2000,
                           dispatch_fn=lambda k, fused, reqs: flushes.append(
                               (k, fused[0].shape[0],
                                {r.model for r in reqs})))
        try:
            for i in range(8):
                b.submit(np.ones((1, 3), np.float32), lambda out, err: None,
                         model="a" if i % 2 else "b")
            assert _wait_for(lambda: len(flushes) == 2, 1.0)
        finally:
            b.close()
        assert sorted(f[1] for f in flushes) == [4, 4]
        assert all(len(f[2]) == 1 and f[0][0] in f[2] for f in flushes)

    def test_expired_requests_shed_with_typed_error(self):
        got = []
        b = DynamicBatcher(max_batch=8, max_latency_ms=5,
                           dispatch_fn=lambda k, fused, reqs: None)
        try:
            b.submit(np.ones((1, 2), np.float32),
                     lambda out, err: got.append(err),
                     deadline=time.monotonic() - 1.0)
            assert _wait_for(lambda: got)
        finally:
            b.close()
        assert got[0].code == "expired"


# ---------------------------------------------------------------------------
# the executor's self-healing (fake replicas)


def _sync_replica(fn):
    return ModelReplica(lambda xs, _f=fn: _f(xs),
                        lambda h: h if isinstance(h, list) else [h],
                        device=None, pads_input=False)


class _Req:
    def __init__(self, sink, value=3.0, model=None):
        self.xs = [np.full((1, 4), value, np.float32)]
        self.n = 1
        self.model = model
        self.sink = sink

    def callback(self, out, err):
        self.sink.append((out, err))


def _submit(ex, sink, n=1, value=3.0, model=None):
    for _ in range(n):
        r = _Req(sink, value, model)
        ex.submit("k", list(r.xs), [r])


class TestExecutorSelfHealing:
    def test_crashing_replica_quarantined_and_batch_retried(self):
        calls = {"bad": 0}

        def bad(xs):
            calls["bad"] += 1
            raise RuntimeError("card fell over")

        ex = DeviceExecutor([_sync_replica(bad),
                             _sync_replica(lambda xs: xs[0] * 2.0)],
                            buckets=(1, 8), name="pchaos_crash",
                            breaker_threshold=1, breaker_cooldown_s=30.0)
        got = []
        try:
            for k in range(3):
                _submit(ex, got)
                assert _wait_for(lambda: len(got) == k + 1)
        finally:
            ex.stop()
        assert all(err is None for _, err in got)
        for out, _ in got:
            np.testing.assert_allclose(np.asarray(out), np.full((1, 4), 6.0))
        assert calls["bad"] == 1
        assert TIMERS.count("pchaos_crash/replica_quarantined") == 1
        assert TIMERS.count("pchaos_crash/batch_retries") >= 1

    def test_all_quarantined_degrades_to_sync_fallback(self):
        def bad(xs):
            raise RuntimeError("no cards left")

        ex = DeviceExecutor([_sync_replica(bad), _sync_replica(bad)],
                            buckets=(1, 8), name="pchaos_fb",
                            breaker_threshold=1, breaker_cooldown_s=30.0,
                            fallback=lambda fused: fused[0] * 2.0,
                            max_retries=3)
        got = []
        try:
            _submit(ex, got, n=2, value=5.0)
            assert _wait_for(lambda: len(got) == 2)
        finally:
            ex.stop()
        for out, err in got:
            assert err is None
            np.testing.assert_allclose(np.asarray(out),
                                       np.full((1, 4), 10.0))
        assert TIMERS.count("pchaos_fb/sync_fallback_batches") >= 1
        assert ex.healthy_replicas() == 0

    def test_injected_replica_crash_and_unknown_model(self):
        """The ``<name>.replica_crash`` site (the one the card's smoke
        fires) fails one dispatch; the batch is retried and answered.  A
        batch for a model the executor does not host is answered with a
        typed ``malformed`` error."""
        fi = FaultInjector()
        fi.plan("pchaos_site.replica_crash", at=0,
                exc=RuntimeError("injected"))
        ex = DeviceExecutor({"m": [_sync_replica(lambda xs: xs[0] + 1.0)]},
                            buckets={"m": (1, 8)}, name="pchaos_site",
                            breaker_threshold=1, breaker_cooldown_s=0.01)
        got = []
        try:
            with fi:
                _submit(ex, got, model="m")
                assert _wait_for(lambda: got)
            _submit(ex, got, model="nope")
            assert _wait_for(lambda: len(got) == 2)
        finally:
            ex.stop()
        assert got[0][1] is None
        np.testing.assert_allclose(np.asarray(got[0][0]),
                                   np.full((1, 4), 4.0))
        assert got[1][1].code == "malformed"
        assert fi.fired["pchaos_site.replica_crash"] == 1

    def test_harvest_hang_watchdog_abandons_and_recovers(self):
        fi = FaultInjector()
        fi.plan("pchaos_hang.replica_hang", at=0, payload=1.0)
        ex = DeviceExecutor([_sync_replica(lambda xs: xs[0] + 1.0),
                             _sync_replica(lambda xs: xs[0] + 1.0)],
                            buckets=(1, 8), name="pchaos_hang",
                            breaker_threshold=3, breaker_cooldown_s=30.0)
        got = []
        try:
            with fi:
                _submit(ex, got, value=1.0)
                abandoned = []
                assert _wait_for(lambda: abandoned or abandoned.extend(
                    [True] if ex.check_harvest(0.2) else []), 5.0)
                assert _wait_for(lambda: got)
            time.sleep(1.2)         # the stuck thread wakes and discards
            alive = ex.is_alive()
        finally:
            ex.stop()
        assert alive and len(got) == 1 and got[0][1] is None
        np.testing.assert_allclose(np.asarray(got[0][0]),
                                   np.full((1, 4), 2.0))
        assert TIMERS.count("pchaos_hang/harvest_abandoned") == 1
        assert TIMERS.count("pchaos_hang/replica_quarantined") == 1

    def test_ensure_threads_and_rebuild_slot(self):
        def bad(xs):
            raise RuntimeError("boom")

        ex = DeviceExecutor([_sync_replica(bad)], buckets=(1, 8),
                            name="pchaos_rebuild", breaker_threshold=1,
                            breaker_cooldown_s=0.05)
        try:
            dead = threading.Thread(target=lambda: None)
            dead.start()
            dead.join(timeout=5)
            ex._dispatch_thread = dead
            ex.ensure_threads()
            assert ex._dispatch_thread.is_alive()
            ex._slots[0].breaker.record_failure()
            time.sleep(0.1)
            assert len(ex.quarantined_slots(min_open_s=0.05)) == 1
            ex.rebuild_slot(0, _sync_replica(lambda xs: xs[0]))
            assert ex.healthy_replicas() == 1 and ex._slots[0].rebuilt
            assert TIMERS.count("pchaos_rebuild/replica_rebuilt") == 1
        finally:
            ex.stop()


def test_slo_admission_sheds_a_fraction_over_its_slo():
    """A model whose observed e2e p99 exceeds its SLO is admitted at the
    ``slo / p99`` fraction (a deterministic accumulator); a model without
    an SLO, or with fewer than ``MIN_SAMPLES``, is always admitted."""
    from analytics_zoo_tpu_torch.deploy.serving import _SloAdmission

    adm = _SloAdmission({"ncf": 50.0, "bert": 0.0})
    assert adm.active and adm.admit("bert") and adm.admit("ncf")
    for _ in range(adm.MIN_SAMPLES):
        adm.note("ncf", 0.200)                  # p99 200 ms > 50 ms
    assert adm.p99("ncf") == pytest.approx(200.0)
    admitted = sum(adm.admit("ncf") for _ in range(400))
    assert admitted == 100                      # 50 / 200 of 400
    assert all(adm.admit("bert") for _ in range(10))
