"""The open-loop client: fire on the schedule, collect on the side.

Two threads per client:

- **sender** walks the pre-drawn arrival schedule on a monotonic
  clock.  It never waits for a result — if the server stalls, sends
  keep their schedule (the open-loop property the stalled-executor
  test pins) and only ``schedule lag`` (how far behind its slot each
  send actually fired) grows with *client-side* cost, not service
  time.  A transport that refuses a push (full shm ring, closed queue)
  counts an ``open_loop_drop`` and the schedule moves on — offered
  load is never modulated by the server.
- **collector** polls the result store for this client's uri prefix
  and timestamps each terminal answer as it lands (result or typed
  error payload), so per-request latency is measured at arrival of the
  answer, not at whenever a sequential reader got around to it.

Every request terminates in exactly one of: a result (``ok``), a typed
error code (``overloaded`` / ``expired`` / ``malformed`` / ...), or
``lost`` if the drain deadline passes with no answer (e.g. in-flight
work killed with a server process).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from analytics_zoo_tpu_torch.observe import metrics as obs

from analytics_zoo_tpu_torch.loadgen.payloads import PayloadMix

__all__ = ["RequestRecord", "OpenLoopClient"]


class RequestRecord:
    """One request's timeline, in run-relative seconds."""

    __slots__ = ("uri", "model", "t_sched", "t_sent", "t_done", "outcome")

    def __init__(self, uri: str, model: str, t_sched: float,
                 t_sent: Optional[float] = None,
                 t_done: Optional[float] = None,
                 outcome: str = "pending"):
        self.uri = uri
        self.model = model
        self.t_sched = t_sched
        self.t_sent = t_sent
        self.t_done = t_done
        self.outcome = outcome

    @property
    def latency_s(self) -> Optional[float]:
        """Schedule-to-answer: includes any lag the client itself added
        (coordinated-omission-free, per Gil Tene's correction)."""
        if self.t_done is None:
            return None
        return self.t_done - self.t_sched

    @property
    def lag_s(self) -> Optional[float]:
        if self.t_sent is None:
            return None
        return self.t_sent - self.t_sched

    def as_dict(self) -> Dict[str, Any]:
        return {"uri": self.uri, "model": self.model,
                "t_sched": self.t_sched, "t_sent": self.t_sent,
                "t_done": self.t_done, "outcome": self.outcome}


def _outcome_of(val: Any) -> str:
    if isinstance(val, dict) and "error" in val:
        return str(val.get("code") or "internal")
    return "ok"


class OpenLoopClient:
    """Drive one ``InputQueue``/``OutputQueue`` pair on a schedule.

    ``schedule`` is the arrival-offset array from
    :func:`~analytics_zoo_tpu_torch.loadgen.arrivals.arrival_times`;
    ``mix`` supplies each arrival's (model, payload, ttl).  ``uri_prefix``
    namespaces this client's records so N clients can share one result
    store without stealing each other's answers.
    """

    def __init__(self, input_queue, output_queue, schedule, mix: PayloadMix,
                 *, leg: str = "steady", seed: int = 0,
                 uri_prefix: Optional[str] = None,
                 query_timeout_s: float = 2.0):
        self.inp = input_queue
        self.outp = output_queue
        self.schedule = np.asarray(schedule, dtype=np.float64)
        self.mix = mix
        self.leg = str(leg)
        self.uri_prefix = uri_prefix if uri_prefix is not None else leg
        self._rng = np.random.Generator(np.random.PCG64(int(seed)))
        self._query_timeout_s = float(query_timeout_s)
        self._lock = threading.Lock()
        self._records: Dict[str, RequestRecord] = {}
        self._drops = 0
        self._stop = threading.Event()
        self._sender: Optional[threading.Thread] = None
        self._collector: Optional[threading.Thread] = None
        self._t0: Optional[float] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "OpenLoopClient":
        if self._sender is not None:
            raise RuntimeError("OpenLoopClient already started")
        self._t0 = time.monotonic()
        self._sender = threading.Thread(target=self._send_loop, daemon=True,
                                        name=f"loadgen-send-{self.leg}")
        self._collector = threading.Thread(
            target=self._collect_loop, daemon=True,
            name=f"loadgen-collect-{self.leg}")
        self._sender.start()
        self._collector.start()
        return self

    def run(self, drain_timeout_s: float = 30.0) -> List[RequestRecord]:
        """Start, wait for the schedule to finish, drain, return records."""
        self.start()
        return self.finish(drain_timeout_s=drain_timeout_s)

    def finish(self, drain_timeout_s: float = 30.0) -> List[RequestRecord]:
        """Join the sender, give the collector ``drain_timeout_s`` past
        the last send to pull remaining answers, then mark stragglers
        ``lost`` and return every record in schedule order."""
        assert self._sender is not None, "finish() before start()"
        self._sender.join()
        deadline = time.monotonic() + drain_timeout_s
        while time.monotonic() < deadline:
            if not self._pending_uris():
                break
            time.sleep(0.02)
        self._stop.set()
        self._collector.join(timeout=5.0)
        with self._lock:
            records = list(self._records.values())
        for r in records:
            if r.outcome == "pending":
                r.outcome = "lost"
                obs.count("loadgen_outcomes_total", model=r.model,
                          outcome="lost", flat="loadgen/lost")
        records.sort(key=lambda r: r.t_sched)
        return records

    # -- introspection -----------------------------------------------------

    def _pending_uris(self) -> List[str]:
        with self._lock:
            return [u for u, r in self._records.items()
                    if r.outcome == "pending"]

    @property
    def open_loop_drops(self) -> int:
        with self._lock:
            return self._drops

    def sent_count(self) -> int:
        with self._lock:
            return sum(1 for r in self._records.values()
                       if r.t_sent is not None)

    # -- threads -----------------------------------------------------------

    def _send_loop(self) -> None:
        t0 = self._t0
        for i, off in enumerate(self.schedule):
            if self._stop.is_set():
                return
            # sleep UNTIL the slot, never because of the server
            while True:
                ahead = (t0 + off) - time.monotonic()
                if ahead <= 0:
                    break
                time.sleep(min(ahead, 0.05))
            cls, payload = self.mix.draw(self._rng, t=float(off))
            uri = f"{self.uri_prefix}-{i:06d}"
            rec = RequestRecord(uri, cls.model, t_sched=float(off))
            with self._lock:
                self._records[uri] = rec
            obs.count("loadgen_requests_total", leg=self.leg,
                      model=cls.model, flat="loadgen/requests")
            try:
                self.inp.enqueue(uri=uri, model=cls.model,
                                 ttl_ms=cls.ttl_ms,
                                 **{cls.field: payload})
            except Exception:
                # transport refused (ring full, queue closed, malformed):
                # the schedule does NOT block or retry — count and move on
                with self._lock:
                    self._drops += 1
                    rec.outcome = "dropped"
                obs.count("loadgen_open_loop_drops_total", leg=self.leg,
                          flat="loadgen/open_loop_drops")
                continue
            sent = time.monotonic() - t0
            with self._lock:
                rec.t_sent = sent
            obs.observe("loadgen_schedule_lag_seconds",
                        max(0.0, sent - float(off)), leg=self.leg,
                        flat="loadgen/schedule_lag")

    def _collect_loop(self) -> None:
        prefix = f"{self.uri_prefix}-"
        while not self._stop.is_set():
            try:
                pend = [u for u in self.outp.queue.pending_results()
                        if u.startswith(prefix)]
            except Exception:
                pend = []
            if not pend:
                time.sleep(0.005)
                continue
            for uri in pend:
                try:
                    val = self.outp.query(uri,
                                          timeout=self._query_timeout_s)
                except Exception:
                    continue        # raced another reader / not ours yet
                done = time.monotonic() - self._t0
                outcome = _outcome_of(val)
                with self._lock:
                    rec = self._records.get(uri)
                    if rec is not None:
                        rec.t_done = done
                        rec.outcome = outcome
                        model = rec.model
                    else:
                        model = "unknown"
                obs.count("loadgen_outcomes_total", model=model,
                          outcome=outcome, flat="loadgen/outcomes")
