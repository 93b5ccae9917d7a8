"""Scenario orchestration: wire shapes + mixes + clients to a live
``ClusterServing`` and fold the result into SLO report sections.

Each ``run_*_leg`` function is self-contained — it builds its queue,
server, schedule and client(s), runs to completion, and returns the
JSON-ready section the artifact writer
(``python -m analytics_zoo_tpu_torch.loadgen``) assembles into one
report, in the JAX package's schema.  The slow soak tests drive the
same functions and assert over the sections, so the report and the
tests are the same code path.

The in-process legs serve host functions (``two_model_pair``): they
measure the pipeline, not a device.  The kill leg is the only one that
crosses a process boundary: the server runs as a real OS process
(``loadgen/server_main.py``, on the card unless ``device="cpu"``) over
a ``FileQueue`` spool with a persistent compile cache, its serving
worker gets SIGKILLed mid-storm, and the server's supervisor relaunches
it against the same cache — the client's schedule never blinks (open
loop), and the restarted worker's status file must show ZERO live
captures (warm start through the cache); then a fresh interpreter
starts on the same caches, and its time to ready is reported beside.  The
pod kill leg waits for pod-scale serving (ROADMAP A9).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np

from analytics_zoo_tpu_torch.loadgen import slo as slo_mod
from analytics_zoo_tpu_torch.loadgen.adversarial import (SlowClient,
                                                         expired_ttl_flood,
                                                         malformed_flood)
from analytics_zoo_tpu_torch.loadgen.arrivals import (FlashCrowd, Steady,
                                                      arrival_times)
from analytics_zoo_tpu_torch.loadgen.client import OpenLoopClient
from analytics_zoo_tpu_torch.loadgen.payloads import PayloadClass, PayloadMix

__all__ = ["two_model_pair", "make_queue", "run_steady_leg",
           "run_burst_leg", "run_mix_shift_leg", "run_adversarial_leg",
           "run_open_loop_check", "run_kill_leg", "run_pod_kill_leg",
           "start_server_process", "wait_for_status", "default_report",
           "SERVER_IN_DIM", "SERVER_QUEUE_NAME", "POD_IN_DIM",
           "POD_VOCAB"]

# the deterministic cross-process server contract (server_main.py /
# client_main.py / the kill leg all agree on these)
SERVER_IN_DIM = 12
SERVER_QUEUE_NAME = "loadgen_stream"
# the JAX package's pod-mode bag model contract (ROADMAP A9)
POD_IN_DIM = 4
POD_VOCAB = 64


def two_model_pair(laggy_sleep_s: float = 0.03, dim: int = 4):
    """The soak's model cast: ``echo`` (can always meet a loose SLO)
    and ``laggy`` (a forward that can never meet a tight one) — same
    cast as ``tests/test_serving_chaos.py``'s autoscale soak."""
    from analytics_zoo_tpu_torch.deploy import InferenceModel

    def fast_fwd(xs):
        return xs[0] * 2.0

    def laggy_fwd(xs):
        time.sleep(laggy_sleep_s)
        return xs[0] * 2.0

    echo = InferenceModel(fast_fwd, batch_buckets=(1, 8))
    laggy = InferenceModel(laggy_fwd, batch_buckets=(1, 8))
    return {"echo": echo, "laggy": laggy}


def make_queue(backend: str = "memory", **kw):
    """Queue for an in-process leg, and the wire that runs: ``memory``,
    or ``shm`` when POSIX shared memory is usable (falls back to memory
    otherwise — the leg's section records which wire actually ran, and a
    caller that needs shared memory checks it)."""
    if backend == "shm":
        from analytics_zoo_tpu_torch.deploy.shmqueue import (ShmQueue,
                                                             shm_available)
        if shm_available():
            kw.setdefault("slots", 256)
            kw.setdefault("slot_bytes", 1 << 16)
            kw.setdefault("push_timeout_s", 5.0)
            return ShmQueue(name=kw.pop("name", "loadgen"), **kw), "shm"
    from analytics_zoo_tpu_torch.deploy.serving import MemoryQueue
    return MemoryQueue(), "memory"


def _lat_stats(records) -> Dict[str, Optional[float]]:
    oks = [r.latency_s * 1e3 for r in records
           if r.outcome == "ok" and r.latency_s is not None]
    lags = [r.lag_s * 1e3 for r in records if r.lag_s is not None]
    return {"latency_p50_ms": slo_mod.percentile(oks, 50),
            "latency_p99_ms": slo_mod.percentile(oks, 99),
            "send_lag_p99_ms": slo_mod.percentile(lags, 99)}


def _section(records, windows, slo_ms_by_model) -> Dict[str, Any]:
    outcomes = slo_mod.outcome_counts(records)
    sec: Dict[str, Any] = {
        "offered": len(records),
        "answered_ok": outcomes.get("ok", 0),
        "outcomes": outcomes,
        "shed_fraction": slo_mod.shed_fraction_by_model(records),
        "sustained_qps_at_slo": slo_mod.sustained_qps_at_slo(
            windows, slo_ms_by_model),
    }
    sec.update(_lat_stats(records))
    return sec


def run_steady_leg(qps: float = 80.0, duration_s: float = 8.0,
                   seed: int = 11, slo_ms: float = 250.0,
                   backend: str = "shm",
                   window_s: float = 1.0) -> Dict[str, Any]:
    """Sustained Poisson load on one model through the full pipeline:
    the sustained-QPS-at-SLO headline row."""
    from analytics_zoo_tpu_torch.deploy import (ClusterServing, InputQueue,
                                                OutputQueue, ServingConfig)

    models = two_model_pair(laggy_sleep_s=0.0)
    model = {"echo": models["echo"]}
    q, wire = make_queue(backend, name="loadgen_steady")
    cfg = ServingConfig(batch_size=8, poll_timeout_s=0.02,
                        max_batch_delay_ms=3, decode_workers=2,
                        slo_p99_ms={"echo": slo_ms})
    srv = ClusterServing(model, q, cfg).start()
    try:
        schedule = arrival_times(Steady(qps), duration_s, seed)
        mix = PayloadMix([PayloadClass("echo", shape=(4,),
                                      dtype="float32")])
        client = OpenLoopClient(InputQueue(q), OutputQueue(q), schedule,
                                mix, leg="steady", seed=seed)
        records = client.run(drain_timeout_s=30.0)
    finally:
        srv.stop()
        if hasattr(q, "stop"):
            q.stop()
    windows = slo_mod.fold_windows(records, window_s, duration_s)
    sec = _section(records, windows, {"echo": slo_ms})
    sec.update({"qps_target": qps, "duration_s": duration_s,
                "slo_p99_ms": slo_ms, "wire": wire,
                "open_loop_drops": client.open_loop_drops})
    return sec


def run_burst_leg(base_qps: float = 40.0, burst_qps: float = 400.0,
                  at_s: float = 3.0, dur_s: float = 2.0,
                  duration_s: float = 14.0, seed: int = 13,
                  slo_ms: float = 400.0, backend: str = "shm",
                  window_s: float = 1.0) -> Dict[str, Any]:
    """Flash crowd: a 10x rectangular burst over a steady floor.  The
    pinned row is recovery-time-to-SLO measured from the burst END."""
    from analytics_zoo_tpu_torch.deploy import (ClusterServing, InputQueue,
                                                OutputQueue, ServingConfig)

    models = {"echo": two_model_pair(laggy_sleep_s=0.002)["laggy"]}
    models["echo"].name = "echo"
    q, wire = make_queue(backend, name="loadgen_burst")
    cfg = ServingConfig(batch_size=8, poll_timeout_s=0.02,
                        max_batch_delay_ms=3, decode_workers=2,
                        slo_p99_ms={"echo": slo_ms})
    srv = ClusterServing(models, q, cfg).start()
    try:
        shape = FlashCrowd(base_qps, burst_qps, at_s, dur_s)
        schedule = arrival_times(shape, duration_s, seed)
        mix = PayloadMix([PayloadClass("echo", shape=(4,),
                                      dtype="float32")])
        client = OpenLoopClient(InputQueue(q), OutputQueue(q), schedule,
                                mix, leg="burst", seed=seed)
        records = client.run(drain_timeout_s=60.0)
    finally:
        srv.stop()
        if hasattr(q, "stop"):
            q.stop()
    windows = slo_mod.fold_windows(records, window_s, duration_s)
    burst_end = at_s + dur_s
    sec = _section(records, windows, {"echo": slo_ms})
    sec.update({
        "base_qps": base_qps, "burst_qps": burst_qps,
        "burst_at_s": at_s, "burst_dur_s": dur_s, "wire": wire,
        "slo_p99_ms": slo_ms,
        "recovery_after_burst_s": slo_mod.recovery_time_to_slo(
            windows, burst_end, {"echo": slo_ms}),
    })
    return sec


def run_mix_shift_leg(duration_s: float = 16.0, qps: float = 60.0,
                      shift_at_s: float = 6.0, seed: int = 17,
                      laggy_sleep_s: float = 0.03,
                      backend: str = "shm",
                      window_s: float = 1.0) -> Dict[str, Any]:
    """The two-model shifting mix under the live autoscaler: balanced
    load, then 85% of traffic shifts onto the model that cannot meet
    its SLO.  Pins selective shed (only the over-SLO model loses
    traffic) and autoscale convergence (actions, zero flaps)."""
    from analytics_zoo_tpu_torch.deploy import (AutoscalePolicy,
                                                ClusterServing, InputQueue,
                                                OutputQueue, ServingConfig)

    models = two_model_pair(laggy_sleep_s=laggy_sleep_s)
    q, wire = make_queue(backend, name="loadgen_mix")
    cfg = ServingConfig(
        batch_size=8, poll_timeout_s=0.02, max_batch_delay_ms=3,
        decode_workers=2, replicas=2, supervisor_interval_s=0.05,
        slo_p99_ms={"echo": 10_000.0, "laggy": 15.0},
        hbm_budget_bytes=1 << 30,
        autoscale=True, autoscale_interval_s=0.05,
        autoscale_cooldown_s=0.25,
        autoscale_policy=AutoscalePolicy(
            hysteresis=2, cooldown_s=0.25, queue_high=8,
            max_decode_workers=4, max_replicas=4,
            min_batch_delay_ms=1.0, max_batch_delay_ms=20.0))
    srv = ClusterServing(models, q, cfg).start()
    try:
        schedule = arrival_times(Steady(qps), duration_s, seed)
        mix = PayloadMix(
            [PayloadClass("echo", shape=(4,), dtype="float32",
                          weight=0.5),
             PayloadClass("laggy", shape=(4,), dtype="float32",
                          weight=0.5)],
            shift_at_s=shift_at_s, shift_weights=[0.15, 0.85])
        client = OpenLoopClient(InputQueue(q), OutputQueue(q), schedule,
                                mix, leg="mix_shift", seed=seed)
        records = client.run(drain_timeout_s=90.0)
        audit = srv.autoscale_audit() or {}
        actions = srv.autoscale_actions()
        health = srv.health()
    finally:
        srv.stop()
        if hasattr(q, "stop"):
            q.stop()
    windows = slo_mod.fold_windows(records, window_s, duration_s)
    shed = slo_mod.shed_fraction_by_model(records)
    outcomes = slo_mod.outcome_counts(records)
    lost = outcomes.get("lost", 0) + outcomes.get("dropped", 0)
    sec = _section(records, windows, {"echo": 10_000.0})
    sec.update({
        "wire": wire, "qps_target": qps, "shift_at_s": shift_at_s,
        "lost": lost,
        "shed_fraction_echo": shed.get("echo", 0.0),
        "shed_fraction_laggy": shed.get("laggy", 0.0),
        # 1.0 iff every shed record belonged to the over-SLO model
        "only_over_slo_shed": float(shed.get("echo", 0.0) == 0.0
                                    and shed.get("laggy", 0.0) > 0.0),
        "autoscale_actions": len(actions),
        "autoscale_flaps": audit.get("flaps"),
        "autoscale_by_label": audit.get("by_label"),
        "observed_p99_laggy_ms":
            health["models"]["laggy"]["observed_p99_ms"],
    })
    return sec


def run_adversarial_leg(backend: str = "shm") -> Dict[str, Any]:
    """Malformed flood + expired-TTL flood + a slow client holding its
    results while a well-behaved neighbour keeps its latency."""
    from analytics_zoo_tpu_torch.deploy import (ClusterServing, InputQueue,
                                                OutputQueue, ServingConfig)

    models = {"echo": two_model_pair(laggy_sleep_s=0.0)["echo"]}
    q, wire = make_queue(backend, name="loadgen_adv")
    cfg = ServingConfig(batch_size=8, poll_timeout_s=0.02,
                        max_batch_delay_ms=3, decode_workers=2)
    srv = ClusterServing(models, q, cfg).start()
    try:
        inp, outp = InputQueue(q), OutputQueue(q)
        # 1. malformed records pushed past client-side validation
        mal_rids = malformed_flood(q, n=12)
        mal_answers = {r: outp.query(r, timeout=30.0) for r in mal_rids}
        mal_typed = sum(
            1 for v in mal_answers.values()
            if isinstance(v, dict) and "error" in v
            and v.get("code") in ("malformed", "decode_error"))
        # 2. expired-TTL flood: shed typed, never served stale
        ttl_uris = expired_ttl_flood(inp, model="echo", n=12,
                                     ttl_ms=0.01)
        ttl_answers = {u: outp.query(u, timeout=30.0) for u in ttl_uris}
        ttl_shed = sum(
            1 for v in ttl_answers.values()
            if isinstance(v, dict)
            and v.get("code") in ("expired", "overloaded"))
        # 3. slow client holds result leases while a neighbour runs
        slow = SlowClient(inp, outp, model="echo", n=8, hold_s=1.0,
                          uri_prefix="slow")
        slow.send()
        lats = []
        rng = np.random.Generator(np.random.PCG64(3))
        for i in range(16):
            x = rng.uniform(0, 1, (4,)).astype(np.float32)
            t0 = time.monotonic()
            inp.enqueue(uri=f"fast-{i:04d}", model="echo", x=x)
            outp.query(f"fast-{i:04d}", timeout=30.0)
            lats.append((time.monotonic() - t0) * 1e3)
        held = slow.collect(timeout_s=30.0)
        slow_ok = sum(1 for v in held.values()
                      if not (isinstance(v, dict) and "error" in v))
    finally:
        srv.stop()
        if hasattr(q, "stop"):
            q.stop()
    return {
        "wire": wire,
        "malformed_offered": len(mal_rids),
        "malformed_typed": mal_typed,
        "malformed_all_typed": float(mal_typed == len(mal_rids)),
        "expired_offered": len(ttl_uris),
        "expired_shed": ttl_shed,
        "expired_all_shed": float(ttl_shed == len(ttl_uris)),
        "slow_client_held": len(held),
        "slow_client_ok": slow_ok,
        "neighbour_p99_ms_while_held": slo_mod.percentile(lats, 99),
    }


def run_open_loop_check(qps: float = 50.0, duration_s: float = 2.0,
                        stall_s: float = 0.5,
                        seed: int = 23) -> Dict[str, Any]:
    """The open-loop property, pinned: a deliberately-stalled executor
    (every forward sleeps ``stall_s`` >> the mean inter-arrival gap)
    must not slow the offered schedule.  Every scheduled send fires,
    and send lag stays bounded by client-side cost alone."""
    from analytics_zoo_tpu_torch.deploy import (ClusterServing, InferenceModel,
                                                InputQueue, MemoryQueue,
                                                OutputQueue, ServingConfig)

    def stalled_fwd(xs):
        time.sleep(stall_s)
        return xs[0] * 2.0

    m = InferenceModel(stalled_fwd, batch_buckets=(1, 8))
    q = MemoryQueue()
    srv = ClusterServing({"stall": m}, q, ServingConfig(
        batch_size=8, poll_timeout_s=0.02, max_batch_delay_ms=3,
        decode_workers=2)).start()
    try:
        schedule = arrival_times(Steady(qps), duration_s, seed)
        mix = PayloadMix([PayloadClass("stall", shape=(4,),
                                      dtype="float32")])
        client = OpenLoopClient(InputQueue(q), OutputQueue(q), schedule,
                                mix, leg="open_loop", seed=seed)
        records = client.finish(drain_timeout_s=90.0) \
            if client.start() else []
    finally:
        srv.stop()
    lags = [r.lag_s for r in records if r.lag_s is not None]
    sent = sum(1 for r in records if r.t_sent is not None)
    lag_p99 = slo_mod.percentile([v * 1e3 for v in lags], 99)
    mean_gap_ms = 1e3 / qps
    # offered rate independent of service time: every slot fired, and
    # p99 send lag stayed under the mean inter-arrival gap even though
    # service time was stall_s >> the gap
    independent = float(sent == len(schedule)
                        and lag_p99 is not None
                        and lag_p99 < mean_gap_ms)
    # the offered rate over the scheduled one, each over its own span
    # (last send, last slot): near 1 open loop, service rate over the
    # offered rate closed loop; unlike the p99 lag, it holds on a loaded
    # host
    last_sent = max((r.t_sent for r in records if r.t_sent is not None),
                    default=None)
    ratio = (None if not last_sent or not len(schedule) else
             (sent / last_sent) / (len(schedule) / float(schedule[-1])))
    return {
        "scheduled": len(schedule), "sent": sent,
        "stall_s": stall_s, "qps_target": qps,
        "send_lag_p99_ms": lag_p99,
        "mean_interarrival_ms": mean_gap_ms,
        "service_p99_ms": _lat_stats(records)["latency_p99_ms"],
        "offered_rate_independent": independent,
        "offered_to_scheduled_rate": ratio,
    }


# -- the kill leg: a real server process dies mid-storm ---------------------

def _loadgen_env() -> Dict[str, str]:
    """The server child's environment: this one, with the checkout that
    holds this package first on ``PYTHONPATH``."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    return env


def start_server_process(spool: str, cache_dir: str, status_file: str,
                         log_path: str, slo_ms: float = 1000.0,
                         extra_args: Optional[List[str]] = None,
                         device: str = "cuda") -> subprocess.Popen:
    """One ``server_main`` OS process over the FileQueue spool, serving
    on ``device``.  The caller owns the Popen (the kill leg SIGKILLs it
    mid-storm)."""
    argv = [sys.executable, "-m",
            "analytics_zoo_tpu_torch.loadgen.server_main",
            "--queue-root", spool, "--cache-dir", cache_dir,
            "--status-file", status_file,
            "--slo-p99-ms", str(slo_ms), "--device", device]
    argv += list(extra_args or [])
    logf = open(log_path, "w")
    try:
        return subprocess.Popen(argv, env=_loadgen_env(), stdout=logf,
                                stderr=subprocess.STDOUT)
    finally:
        logf.close()     # the child holds its own fd


def wait_for_status(status_file: str, timeout_s: float = 120.0,
                    require: Optional[str] = None,
                    proc: Optional[subprocess.Popen] = None,
                    not_pid: Optional[int] = None) -> Dict[str, Any]:
    """Block until the server's status JSON exists (and, optionally,
    carries ``require`` as a truthy key, and comes from another worker
    than ``not_pid``) — the 'server is up' barrier.  With ``proc``, a
    server that exits first raises at once."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if proc is not None and proc.poll() is not None:
            raise RuntimeError(
                f"server process exited (rc {proc.returncode}) before "
                f"{status_file} was ready; see its log")
        if os.path.exists(status_file):
            try:
                with open(status_file) as f:
                    st = json.load(f)
            except (OSError, ValueError):
                st = None
            if (st is not None and (require is None or st.get(require))
                    and (not_pid is None or st.get("pid") != not_pid)):
                return st
        time.sleep(0.1)
    raise TimeoutError(f"server status never appeared at {status_file}")


def _stop(proc: subprocess.Popen) -> int:
    """SIGTERM a server (a clean stop dumps its final status), SIGKILL
    it if it outlives 30 s; its exit code."""
    proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        return proc.wait(timeout=10)


def run_kill_leg(workdir: str, qps: float = 50.0, duration_s: float = 22.0,
                 kill_at_s: float = 7.0, restart_delay_s: float = 0.5,
                 slo_ms: float = 2000.0, seed: int = 29,
                 window_s: float = 1.0, device: str = "cuda",
                 drain_timeout_s: float = 60.0) -> Dict[str, Any]:
    """SIGKILL the serving process (on ``device``) mid-storm; relaunch
    it against the same compile-cache dir; prove the client returns to
    SLO and the restarted server did ZERO live captures (pure warm
    start).

    The serving process is ``server_main``'s worker; its supervisor
    forks the successor ``restart_delay_s`` after the kill, without
    importing torch again (``restart_ready_s``: from the SIGKILL to the
    successor's readiness; ``server1_start_ready_s``: the first, cold
    server's launch to readiness).  After the storm the leg stops the server
    and starts a fresh interpreter on the same caches, as a restart of
    the whole server (a lost host, a redeploy) would:
    ``fresh_start_ready_s`` is its launch to its readiness, with its
    captures in ``fresh_compile_count``.

    The FileQueue spool survives the kill, so queued-but-unclaimed
    records are served by the successor; records in flight inside the
    killed process are bounded by the pipeline depth and terminate as
    ``lost`` at the client (counted, not hidden) once
    ``drain_timeout_s`` has passed after the last send.
    """
    from analytics_zoo_tpu_torch.deploy.serving import (FileQueue, InputQueue,
                                                        OutputQueue)

    os.makedirs(workdir, exist_ok=True)
    spool = os.path.join(workdir, "spool")
    cache = os.path.join(workdir, "cache")
    os.makedirs(spool, exist_ok=True)
    os.makedirs(cache, exist_ok=True)
    status = os.path.join(workdir, "server.status.json")
    status3 = os.path.join(workdir, "server_fresh.status.json")
    restart = ["--restart-delay-s", str(restart_delay_s)]

    t_launch1 = time.time()
    proc = start_server_process(
        spool, cache, status, os.path.join(workdir, "server.log"),
        slo_ms=slo_ms, extra_args=restart, device=device)
    try:
        st1 = wait_for_status(status, require="ready", proc=proc)
        q = FileQueue(spool, name=SERVER_QUEUE_NAME)
        schedule = arrival_times(Steady(qps), duration_s, seed)
        mix = PayloadMix([PayloadClass("default", shape=(SERVER_IN_DIM,),
                                       dtype="float32")])
        client = OpenLoopClient(InputQueue(q), OutputQueue(q), schedule,
                                mix, leg="kill", seed=seed,
                                query_timeout_s=5.0).start()
        t0 = time.monotonic()
        time.sleep(kill_at_s)
        os.kill(st1["pid"], signal.SIGKILL)       # the worker, mid-storm
        kill_wall = time.time()
        kill_t = time.monotonic() - t0
        records = client.finish(drain_timeout_s=drain_timeout_s)
        st2 = wait_for_status(status, require="ready", proc=proc,
                              not_pid=st1["pid"])
    finally:
        rc2 = _stop(proc)
    # final status the worker dumped on SIGTERM (post-traffic truth)
    try:
        with open(status) as f:
            st2 = json.load(f)
    except (OSError, ValueError):
        pass
    t_launch = time.time()
    proc3 = start_server_process(
        spool, cache, status3, os.path.join(workdir, "server_fresh.log"),
        slo_ms=slo_ms, device=device)
    try:
        st3 = wait_for_status(status3, require="ready", proc=proc3)
    finally:
        _stop(proc3)
    windows = slo_mod.fold_windows(records, window_s, duration_s)
    outcomes = slo_mod.outcome_counts(records)
    sec: Dict[str, Any] = {
        "qps_target": qps, "duration_s": duration_s,
        "kill_at_s": round(kill_t, 3), "slo_p99_ms": slo_ms,
        "offered": len(records),
        "answered_ok": outcomes.get("ok", 0),
        "lost": outcomes.get("lost", 0) + outcomes.get("dropped", 0),
        "outcomes": outcomes,
        "recovery_after_kill_s": slo_mod.recovery_time_to_slo(
            windows, kill_t, {"default": slo_ms}),
        "cold_compile_count": st1.get("compile_count"),
        "server1_start_ready_s": st1["ready_t"] - t_launch1,
        "server1_startup_s": st1.get("startup_s"),
        "warm_compile_count": st2.get("compile_count"),
        "warm_cache_hits": ((st2.get("cache") or {}).get("events")
                            or {}).get("hit"),
        "warm_count": st2.get("warm_count"),
        "server1_exit_rc": st2.get("previous_exit"),   # -9: SIGKILLed
        "server2_exit_rc": rc2,
        "restart_ready_s": st2["ready_t"] - kill_wall,
        "server2_startup_s": st2.get("startup_s"),
        "fresh_start_ready_s": st3["ready_t"] - t_launch,
        "fresh_startup_s": st3.get("startup_s"),
        "fresh_compile_count": st3.get("compile_count"),
    }
    sec.update(_lat_stats(records))
    return sec


# -- the pod kill leg: waits for pod-scale serving --------------------------

POD_KILL_NOT_PORTED = (
    "the pod kill leg needs PodCoordinator, mesh replicas and a "
    "sharded-table model across processes: pod-scale serving is not "
    "ported yet (ROADMAP A9)")


def start_pod(*args, **kw):
    """A 2-process pod of ``server_main``: waits for ROADMAP A9."""
    raise NotImplementedError(POD_KILL_NOT_PORTED)


def run_pod_kill_leg(*args, **kw) -> Dict[str, Any]:
    """SIGKILL a pod member host mid-storm: waits for ROADMAP A9."""
    raise NotImplementedError(POD_KILL_NOT_PORTED)


def default_report(workdir: str, quick: bool = False,
                   device: str = "cuda") -> Dict[str, Any]:
    """The full artifact: every leg, assembled; the kill leg's server
    processes serve on ``device``.  ``quick`` shrinks durations for
    smoke runs.  The pod kill leg is listed under ``not_ported``."""
    import platform

    import torch

    scale = 0.5 if quick else 1.0
    report: Dict[str, Any] = {
        "schema": "slo-artifact-v1",
        "run_metadata": {
            "python": platform.python_version(),
            "platform": platform.platform(),
            "torch": torch.__version__,
            "server_device": device,
            "quick": bool(quick),
        },
        "not_ported": {"pod_kill": POD_KILL_NOT_PORTED},
    }
    legs = [
        ("steady", lambda: run_steady_leg(duration_s=8.0 * scale)),
        ("burst", lambda: run_burst_leg(duration_s=14.0 * scale,
                                        at_s=3.0 * scale,
                                        dur_s=2.0 * scale)),
        ("mix_shift", lambda: run_mix_shift_leg(duration_s=16.0 * scale,
                                                shift_at_s=6.0 * scale)),
        ("adversarial", run_adversarial_leg),
        ("open_loop", run_open_loop_check),
        ("kill", lambda: run_kill_leg(os.path.join(workdir, "kill"),
                                      duration_s=22.0 * scale,
                                      kill_at_s=7.0 * scale,
                                      device=device)),
    ]
    # each leg's wall seconds, set-up and drain included
    wall = report["run_metadata"]["leg_wall_s"] = {}
    for name, leg in legs:
        t0 = time.perf_counter()
        report[name] = leg()
        wall[name] = time.perf_counter() - t0
    return report
