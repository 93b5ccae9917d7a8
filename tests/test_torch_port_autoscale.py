"""The port's autoscaler and device-memory budget against the JAX
package's, on the CPU.

Each decision of the JAX autoscaler's unit suite (hysteresis, cooldown,
decode pool, replicas, batch deadline, budget refusals, the audit) is
driven through both packages' ``Autoscaler.check(signals=...)`` with the
same fabricated signals and a fake clock: the port must make the JAX
suite's decision and the same actuator calls and audit entries as the
JAX package.  ``ClusterServing._plan_replicas`` must give the JAX plan
under ``hbm_budget_bytes``.  Then the actuators run on a live port
worker: two function models with two replicas each, a grow the budget
refuses, a decode pool resize and a deadline change driven by the
autoscaler from fabricated signals, and every record answered right.

Every wait takes a deadline and every worker is stopped in ``finally``.
"""

import time

import numpy as np
import pytest

from analytics_zoo_tpu.deploy import autoscale as jax_autoscale
from analytics_zoo_tpu.deploy import serving as jax_serving
from analytics_zoo_tpu.deploy.inference import InferenceModel as JaxIM

from analytics_zoo_tpu_torch.deploy import autoscale as torch_autoscale
from analytics_zoo_tpu_torch.deploy import serving as torch_serving
from analytics_zoo_tpu_torch.deploy.inference import InferenceModel as TorchIM

PACKAGES = {"jax": (jax_autoscale, jax_serving, JaxIM),
            "torch": (torch_autoscale, torch_serving, TorchIM)}


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class _FakeBatcher:
    def __init__(self, max_latency_ms=8.0):
        self.max_latency = max_latency_ms / 1e3


class _FakeCfg:
    autoscale_cooldown_s = 5.0
    max_inflight = 2


class _FakeServing:
    """The actuator surface the Autoscaler calls, recording each call."""

    def __init__(self):
        self.cfg = _FakeCfg()
        self._batcher = _FakeBatcher()
        self.decode_workers = 2
        self.replicas = {"resnet": 2, "bert": 1}
        self.refuse_grow = set()    # models whose grow the budget refuses
        self.calls = []

    def resize_decode_pool(self, n):
        self.calls.append(("decode", n))
        self.decode_workers = n
        return n

    def resize_model_replicas(self, model, n):
        self.calls.append(("replicas", model, n))
        if n > self.replicas[model] and model in self.refuse_grow:
            return self.replicas[model]
        self.replicas[model] = n
        return n

    def set_batch_deadline_ms(self, ms):
        self.calls.append(("deadline", ms))
        self._batcher.max_latency = max(0.1, ms) / 1e3
        return self._batcher.max_latency * 1e3


def _sig(queue=0, inflight=0, decode=2, models=None):
    return {"queue_depth": queue, "inflight": inflight, "max_inflight": 2,
            "decode_workers": decode,
            "models": models if models is not None else {
                "resnet": {"replicas": 2, "healthy": 2,
                           "slo_ms": 50.0, "p99_ms": 10.0}}}


def _models(**p99):
    slo = {"resnet": 50.0, "bert": 100.0}
    reps = {"resnet": 2, "bert": 1}
    return {m: {"replicas": p99.get(f"{m}_replicas", reps[m]),
                "healthy": p99.get(f"{m}_replicas", reps[m]),
                "slo_ms": p99.get(f"{m}_slo", slo[m]), "p99_ms": v}
            for m, v in p99.items() if not m.endswith(("_replicas", "_slo"))}


def _decode_ticks(sc, srv, clock, queue, ticks, advance=0.0):
    for _ in range(ticks):
        sc.check(signals=_sig(queue=queue, decode=srv.decode_workers))
    clock.advance(advance)


# Each scenario: (policy keywords, a function of (scaler, fake server,
# clock) that ticks, and the check of the JAX suite's decision).
SCENARIOS = {
    "single_breach_tick_does_nothing": (
        {}, lambda sc, srv, c: _decode_ticks(sc, srv, c, 1000, 1),
        lambda srv: srv.calls == []),
    "consecutive_breaches_fire_once": (
        {}, lambda sc, srv, c: _decode_ticks(sc, srv, c, 1000, 2),
        lambda srv: ("decode", 4) in srv.calls and srv.decode_workers == 4),
    "interrupted_streak_resets": (
        {}, lambda sc, srv, c: [sc.check(signals=_sig(queue=q, decode=2))
                                for q in (1000, 0, 1000)],
        lambda srv: all(k[0] != "decode" for k in srv.calls)),
    "quiet_period_after_action": (
        {}, lambda sc, srv, c: (_decode_ticks(sc, srv, c, 1000, 6, 6.0),
                                _decode_ticks(sc, srv, c, 1000, 1)),
        lambda srv: [k for k in srv.calls if k[0] == "decode"]
        == [("decode", 4), ("decode", 8)]),
    "cooldown_is_per_model_and_resource": (
        {}, lambda sc, srv, c: [sc.check(signals=_sig(models=_models(
            resnet=80.0, bert=150.0))) for _ in range(2)],
        lambda srv: ("replicas", "resnet", 3) in srv.calls
        and ("replicas", "bert", 2) in srv.calls),
    "decode_pool_shrinks_when_drained": (
        {}, lambda sc, srv, c: _decode_ticks(sc, srv, c, 0, 2),
        lambda srv: srv.decode_workers == 1),
    "decode_respects_bounds": (
        {"max_decode_workers": 4},
        lambda sc, srv, c: (setattr(srv, "decode_workers", 4),
                            _decode_ticks(sc, srv, c, 1000, 4)),
        lambda srv: all(k[0] != "decode" for k in srv.calls)),
    "replicas_grow_on_slo_pressure": (
        {}, lambda sc, srv, c: [sc.check(signals=_sig(models=_models(
            resnet=60.0))) for _ in range(2)],
        lambda srv: srv.replicas["resnet"] == 3),
    "replicas_shrink_far_under_slo": (
        {}, lambda sc, srv, c: [sc.check(signals=_sig(models=_models(
            resnet=5.0))) for _ in range(2)],
        lambda srv: srv.replicas["resnet"] == 1),
    "no_slo_model_scales_on_saturation": (
        {}, lambda sc, srv, c: [sc.check(signals=_sig(
            queue=1000, inflight=2, models=_models(resnet=0.0,
                                                   resnet_slo=0.0)))
            for _ in range(2)],
        lambda srv: srv.replicas["resnet"] == 3),
    "deadline_raises_under_queue_pressure_when_slos_met": (
        {}, lambda sc, srv, c: [sc.check(signals=_sig(
            queue=1000, models=_models(resnet=10.0, resnet_replicas=8)))
            for _ in range(2)],
        lambda srv: srv._batcher.max_latency == pytest.approx(16.0 / 1e3)),
    "deadline_halves_when_over_slo": (
        {}, lambda sc, srv, c: [sc.check(signals=_sig(models=_models(
            resnet=90.0, resnet_replicas=8))) for _ in range(2)],
        lambda srv: srv._batcher.max_latency == pytest.approx(4.0 / 1e3)),
    "budget_refused_grow_is_still_counted": (
        {}, lambda sc, srv, c: (srv.refuse_grow.add("resnet"), [
            sc.check(signals=_sig(models=_models(resnet=60.0)))
            for _ in range(2)]),
        lambda srv: srv.replicas["resnet"] == 2),
    "hysteresis_one_fires_immediately": (
        {"hysteresis": 1},
        lambda sc, srv, c: _decode_ticks(sc, srv, c, 1000, 1),
        lambda srv: srv.decode_workers == 4),
}


def _run(pkg, name):
    autoscale = PACKAGES[pkg][0]
    kw, drive, _ = SCENARIOS[name]
    srv, clock = _FakeServing(), _FakeClock()
    pol = autoscale.AutoscalePolicy(**dict(dict(hysteresis=2, cooldown_s=5.0),
                                           **kw))
    sc = autoscale.Autoscaler(srv, policy=pol, clock=clock)
    clock.advance(1.0)
    drive(sc, srv, clock)
    actions = [{k: a[k] for k in ("t", "model", "resource", "direction",
                                  "value", "detail")} for a in sc.actions]
    return srv, sc, {"calls": srv.calls, "actions": actions,
                     "decode": srv.decode_workers,
                     "replicas": dict(srv.replicas),
                     "deadline_ms": srv._batcher.max_latency * 1e3,
                     "stats": sc.stats()}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_autoscaler_decides_as_the_jax_one(name):
    srv, _, got = _run("torch", name)
    assert SCENARIOS[name][2](srv), got
    _, _, want = _run("jax", name)
    assert got == want


def test_budget_refusal_is_audited_once_as_in_jax():
    """A grow the budget refuses lands in the audit once with the size
    that stayed, and cooldown stops it from hammering the budget."""
    for pkg in ("torch", "jax"):
        _, sc, _ = _run(pkg, "budget_refused_grow_is_still_counted")
        acts = [a for a in sc.actions if a["resource"] == "replicas"]
        assert len(acts) == 1 and acts[0]["value"] == 2, (pkg, acts)


def test_actions_are_counted_and_labeled_as_in_jax():
    from analytics_zoo_tpu_torch.core.profiling import TIMERS
    from analytics_zoo_tpu_torch.observe import metrics as obs

    before = TIMERS.count("serving/autoscale_decode_workers_up")
    _, sc, _ = _run("torch", "consecutive_breaches_fire_once")
    assert TIMERS.count("serving/autoscale_decode_workers_up") == before + 1
    key = ("serving_autoscale_actions_total",
           (("direction", "up"), ("model", torch_autoscale.PIPELINE),
            ("resource", "decode_workers")))
    assert obs.METRICS.snapshot().counters.get(key, 0) >= 1
    a = next(a for a in sc.actions if a["resource"] == "decode_workers")
    assert a["model"] == torch_autoscale.PIPELINE == jax_autoscale.PIPELINE
    assert "queue depth" in a["detail"] and sc.stats()["actions"] >= 1
    _, sc, _ = _run("torch", "deadline_halves_when_over_slo")
    a = next(a for a in sc.actions if a["resource"] == "batch_deadline")
    assert a["model"] == torch_autoscale.ALL_MODELS == jax_autoscale.ALL_MODELS
    assert sc.audit() == _run("jax", "deadline_halves_when_over_slo")[
        1].audit()


def test_policy_bounds_match_jax():
    kw = dict(min_decode_workers=0, max_decode_workers=-3, min_replicas=0,
              max_replicas=0, hysteresis=0)
    got = torch_autoscale.AutoscalePolicy(**kw)
    want = jax_autoscale.AutoscalePolicy(**kw)
    assert vars(got) == vars(want)
    assert got.min_decode_workers == 1 and got.min_replicas == 1
    assert got.hysteresis == 1 and got.max_replicas >= got.min_replicas


# ---------------------------------------------------------------------------
# the device-memory budget


class _Weighted:
    def __init__(self, name, nbytes):
        self.name = name
        self._n = nbytes

    def weight_nbytes(self):
        return self._n


@pytest.mark.parametrize("sizes,replicas,budget", [
    ({"heavy": 100, "light": 60}, 3, 300),      # heaviest sheds first
    ({"a": 1000, "b": 1000}, 2, 100),           # never below one each
    ({"a": 10, "b": 20, "c": 30}, 4, 150),
    ({"a": 10, "b": 20}, 3, 0),                 # no budget
])
def test_replica_plan_under_the_budget_matches_jax(sizes, replicas, budget):
    plans = {}
    for pkg, (_, serving, _) in PACKAGES.items():
        srv = serving.ClusterServing(
            {m: _Weighted(m, n) for m, n in sizes.items()},
            serving.MemoryQueue(),
            serving.ServingConfig(replicas=replicas,
                                  hbm_budget_bytes=budget))
        plans[pkg] = srv._plan_replicas()
    assert plans["torch"] == plans["jax"]
    assert min(plans["torch"].values()) >= 1
    if budget and any(v > 1 for v in plans["torch"].values()):
        assert sum(sizes[m] * v for m, v in plans["torch"].items()) <= budget


# ---------------------------------------------------------------------------
# the actuators on a live worker


def _drain(outq, uris, timeout=30.0):
    got, deadline = {}, time.monotonic() + timeout
    while len(got) < len(uris) and time.monotonic() < deadline:
        for u in uris:
            if u not in got:
                r = outq.query(u, timeout=0.05)
                if r is not None:
                    got[u] = r
    return got


def _group_size(srv, model, want, timeout=10.0):
    """The executor's group size once a swap has taken over (at the next
    dispatch), or as it stands at the deadline."""
    deadline = time.monotonic() + timeout
    while (srv._executor.group_size(model) != want
           and time.monotonic() < deadline):
        time.sleep(0.01)
    return srv._executor.group_size(model)


def _live(pkg):
    """Two weighted function models, two replicas each, budget for five
    copies: the autoscaler's grow of one model is taken, the next one
    refused, the decode pool grows and the deadline halves; then 24
    records of each model are answered."""
    autoscale, serving, im_cls = PACKAGES[pkg]

    class Weighted(im_cls):
        def weight_nbytes(self):
            return 100

    double = Weighted(lambda xs: xs[0] * 2.0, batch_buckets=(1, 8))
    plus = Weighted(lambda xs: xs[0] + 5.0, batch_buckets=(1, 8))
    q = serving.MemoryQueue()
    cfg = serving.ServingConfig(
        batch_size=8, poll_timeout_s=0.02, max_batch_delay_ms=3,
        decode_workers=2, replicas=2, hbm_budget_bytes=500,
        supervisor_interval_s=0.05, autoscale=True,
        autoscale_interval_s=3600.0,
        autoscale_policy=autoscale.AutoscalePolicy(
            hysteresis=1, cooldown_s=0.0, max_replicas=4,
            max_decode_workers=4))
    srv = serving.ClusterServing({"double": double, "plus": plus}, q,
                                 cfg).start()
    inp, outp = serving.InputQueue(q), serving.OutputQueue(q)
    try:
        sc = srv._autoscaler
        sizes = [dict(srv._replica_plan)]

        def over(n):
            return {"double": {"replicas": n, "healthy": n, "slo_ms": 10.0,
                               "p99_ms": 50.0}}

        sc.check(signals=_sig(queue=10, models=over(2)))    # 2 -> 3
        first = _drain(outp, [inp.enqueue(uri="first", model="double",
                                          x=np.ones(4, np.float32))])
        sizes.append(_group_size(srv, "double", 3))
        sc.check(signals=_sig(queue=10, models=over(3)))    # 4: refused
        sizes.append(_group_size(srv, "double", 3, timeout=0.2))
        sc.check(signals=_sig(queue=1000, models={}))       # decode 2 -> 4
        live = sc.signals()
        uris = []
        for i in range(24):
            for m in ("double", "plus"):
                uris.append(inp.enqueue(uri=f"{m}{i}", model=m,
                                        x=np.full((4,), i, np.float32)))
        got = dict(_drain(outp, uris), **first)
        actions = [(a["model"], a["resource"], a["direction"], a["value"])
                   for a in srv.autoscale_actions()]
        deadline_ms = srv._batcher.max_latency * 1e3
        health = srv.health()["models"]
    finally:
        srv.stop()
    return {"sizes": sizes, "actions": actions,
            "decode": live["decode_workers"],
            "replicas": {m: s["replicas"] for m, s in live["models"].items()},
            "deadline_ms": deadline_ms, "got": got,
            "health_replicas": {m: h["replicas"] for m, h in health.items()}}


def test_actuators_on_a_live_worker_match_jax():
    got = _live("torch")
    assert got["sizes"] == [{"double": 2, "plus": 2}, 3, 3]
    assert got["decode"] == 4
    assert got["replicas"] == {"double": 3, "plus": 2}
    # the grow to 3 is taken; the grow to 4 is refused and stays at 3
    assert [a for a in got["actions"] if a[1] == "replicas"] == [
        ("double", "replicas", "up", 3)] * 2
    assert len(got["got"]) == 49, sorted(got["got"])
    for i in range(24):
        np.testing.assert_allclose(np.asarray(got["got"][f"double{i}"]),
                                   np.full((4,), 2.0 * i), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(got["got"][f"plus{i}"]),
                                   np.full((4,), i + 5.0), rtol=1e-6)
    want = _live("jax")
    for k in ("sizes", "actions", "decode", "replicas", "deadline_ms",
              "health_replicas"):
        assert got[k] == want[k], k
