"""The port's ``RedisQueue`` against the JAX package's, on the CPU.

No Redis server or ``redis`` package is needed: ``tests/fake_redis.py``
is installed as ``redis`` (the JAX ``test_serving_redis.py`` idiom), so
the real queue code runs — consumer groups, XTRIM, result hashes — and
both packages' queues on one (host, port) share one store.

Checked: two port workers claim disjoint records; trim drops the oldest
past the bound; results land where the reference client reads them
(hash ``result:{uri}``, field ``value``); the port writes the JAX wire
byte for byte; a record one package's ``InputQueue`` pushes is answered
by the other package's worker and read back by the first package's
``OutputQueue``; ``make_queue("redis")`` lowers to a working
``RedisQueue``, and raises ``ImportError`` where ``redis`` is absent.
"""

import json
import sys

import numpy as np
import pytest


@pytest.fixture(autouse=True)
def fake_redis(monkeypatch):
    """Install the fake ``redis`` module and reset its store per test."""
    from tests import fake_redis as fr

    fr._Server.reset()
    monkeypatch.setitem(sys.modules, "redis", fr)
    yield fr
    fr._Server.reset()


def test_consumer_group_disjoint_claims():
    from analytics_zoo_tpu_torch.deploy import RedisQueue

    q1 = RedisQueue(name="s")
    q2 = RedisQueue(name="s")
    for i in range(10):
        q1.push({"uri": f"r{i}", "v": i})
    got1 = q1.pop_batch(6, timeout=0.01)
    got2 = q2.pop_batch(6, timeout=0.01)
    ids1 = {rid for rid, _ in got1}
    ids2 = {rid for rid, _ in got2}
    assert ids1.isdisjoint(ids2)
    assert ids1 | ids2 == {f"r{i}" for i in range(10)}
    assert {rid: rec["v"] for rid, rec in got1 + got2} == {
        f"r{i}": i for i in range(10)}


def test_trim_backpressure():
    from analytics_zoo_tpu_torch.deploy import RedisQueue

    q = RedisQueue(name="s")
    for i in range(20):
        q.push({"uri": f"r{i}"})
    assert len(q) == 20
    assert q.trim(5) == 15
    assert len(q) == 5
    # the oldest went: the survivors are the last five pushed
    assert [rid for rid, _ in q.pop_batch(10, timeout=0.01)] == [
        f"r{i}" for i in range(15, 20)]
    assert q.health() == {"ok": True, "backend": "redis", "depth": 5}


def test_result_hash_wire_shape(fake_redis):
    from analytics_zoo_tpu_torch.deploy import RedisQueue

    q = RedisQueue(name="s")
    q.set_result("abc", {"top1": 3})
    db = fake_redis.Redis(decode_responses=False)
    raw = db.hgetall("result:abc")
    assert b"value" in raw
    assert json.loads(raw[b"value"].decode()) == {"top1": 3}
    assert q.pending_results() == ["abc"]
    assert q.get_result("abc", timeout=1.0) == {"top1": 3}
    assert q.pending_results() == []
    with pytest.raises(TimeoutError, match="no result for 'abc'"):
        q.get_result("abc", timeout=0.05)


def test_port_writes_the_jax_wire(fake_redis):
    """The same record pushed by both packages' queues lands as the same
    stream fields, and each package pops the other's."""
    from analytics_zoo_tpu.deploy.serving import RedisQueue as JaxRQ
    from analytics_zoo_tpu_torch.deploy import RedisQueue

    rec = {"uri": "r1", "x": {"b64": "AAAAAA==", "dtype": "float32",
                              "shape": [1]}, "model": "m", "ts": 1.5}
    tq, jq = RedisQueue(name="w"), JaxRQ(name="w")
    assert tq.push(dict(rec)) == jq.push(dict(rec)) == "r1"
    (_, a), (_, b) = fake_redis._Server.get("localhost", 6379).streams["w"]
    assert a == b
    # the reference client's flat fields (no blob) are lifted alike
    db = fake_redis.Redis(decode_responses=True)
    db.xadd("w", {"uri": "img", "image": "aGVsbG8="})
    got = tq.pop_batch(10, timeout=0.01)
    assert [rid for rid, _ in got] == ["r1", "r1", "img"]
    assert got[0][1] == rec and got[2][1] == {
        "uri": "img", "codec": "file", "image": "aGVsbG8="}


@pytest.mark.parametrize("client", ["jax", "port"])
def test_a_record_crosses_packages_over_redis(client):
    """One package's InputQueue pushes over its RedisQueue, the other
    package's worker answers over its own, and the first package's
    OutputQueue reads the answer."""
    from analytics_zoo_tpu import deploy as jd
    from analytics_zoo_tpu_torch import deploy as td

    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    if client == "jax":
        q = jd.RedisQueue(name="t")
        inq, outq = jd.InputQueue(q), jd.OutputQueue(q)
        model = td.InferenceModel.from_function(lambda a: a * 2.0,
                                                device="cpu")
        worker = td.ClusterServing(model, td.RedisQueue(name="t"),
                                   td.ServingConfig(batch_size=4))
    else:
        q = td.RedisQueue(name="t")
        inq, outq = td.InputQueue(q), td.OutputQueue(q)
        model = jd.InferenceModel(lambda xs: xs[0] * 2.0)
        worker = jd.ClusterServing(model, jd.RedisQueue(name="t"),
                                   jd.ServingConfig(batch_size=4))
    uri = inq.enqueue("rec1", x=x[0])
    assert uri == "rec1"
    assert worker.serve_once() == 1
    np.testing.assert_allclose(np.asarray(outq.query("rec1", timeout=5.0)),
                               2.0 * x[0], rtol=1e-6)


def test_make_queue_redis_lowers_or_raises(monkeypatch):
    from analytics_zoo_tpu_torch.deploy import RedisQueue, make_queue

    q = make_queue("redis", name="mq")
    assert isinstance(q, RedisQueue) and q.name == "mq"
    q.push({"uri": "a"})
    assert [rid for rid, _ in q.pop_batch(2, timeout=0.01)] == ["a"]
    monkeypatch.setitem(sys.modules, "redis", None)
    with pytest.raises(ImportError):
        make_queue("redis")
    with pytest.raises(ImportError):
        RedisQueue()
