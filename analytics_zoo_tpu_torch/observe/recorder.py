"""The flight recorder: an SLO watcher that captures evidence *at the
moment things go wrong* instead of asking the operator to reproduce.

``FlightRecorder.check`` is designed to run as a ``Supervisor`` check.
It reads the labeled-metrics registry in **windows** (snapshot/delta):
every ``window_s`` it closes the current window and evaluates

- each ``SLO`` — a p99 bound on one histogram series (e.g.
  ``serving_stage_seconds{stage=e2e}`` p99 ≤ 50 ms, with a minimum
  sample count so idle windows can't trip);
- each *watched counter* — any positive window delta trips (e.g.
  ``breaker_transitions_total{to=open}``: a breaker trip is itself an
  incident worth a recording).

A trip produces a **flight record**: the window's metrics delta, the
current gauges, and the offending spans (slowest-first plus every
non-ok terminal) pulled from the tracer ring — written as JSON to
``out_dir`` (if set) and kept in a small in-memory deque either way.
Optionally it also arms a short ``torch.profiler`` trace (the card's
kernels and the host's ops) on a background thread, written as a Chrome
trace to ``profile_dir``, so a breach leaves a real profile behind.  A cooldown stops a sustained breach from
producing a snapshot storm.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from analytics_zoo_tpu_torch.observe import metrics as _m
from analytics_zoo_tpu_torch.observe.metrics import (METRICS,
                                                     MetricsRegistry,
                                                     render_series)
from analytics_zoo_tpu_torch.observe.trace import TRACER, Tracer

__all__ = ["SLO", "FlightRecorder"]


class SLO:
    """A p99 bound on one histogram series over the watch window."""

    def __init__(self, name: str, metric: str,
                 labels: Optional[Dict[str, str]] = None,
                 p99_ms: float = 0.0, min_count: int = 10):
        self.name = name
        self.metric = metric
        self.labels = dict(labels or {})
        self.p99_ms = float(p99_ms)
        self.min_count = int(min_count)
        self.series = render_series(
            metric, tuple(sorted((k, str(v))
                                 for k, v in self.labels.items())))

    def breached(self, delta: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        hist = delta["histograms"].get(self.series)
        if not hist or hist["count"] < self.min_count:
            return None
        p99 = hist.get("p99")
        if p99 is None or p99 * 1000.0 <= self.p99_ms:
            return None
        return {"slo": self.name, "series": self.series,
                "p99_ms": p99 * 1000.0, "limit_ms": self.p99_ms,
                "count": hist["count"]}


class FlightRecorder:
    def __init__(self, slos: Sequence[SLO] = (),
                 watch_counters: Sequence[Tuple[str,
                                                Dict[str, str]]] = (),
                 window_s: float = 5.0,
                 out_dir: Optional[str] = None,
                 tracer: Optional[Tracer] = None,
                 registry: Optional[MetricsRegistry] = None,
                 profile_dir: Optional[str] = None,
                 profile_ms: float = 200.0,
                 cooldown_s: float = 30.0,
                 max_spans: int = 200,
                 clock: Callable[[], float] = time.monotonic):
        self.slos = list(slos)
        self.watch_counters = [
            (name, dict(labels or {})) for name, labels in watch_counters]
        self.window_s = float(window_s)
        self.out_dir = out_dir
        self.profile_dir = profile_dir
        self.profile_ms = float(profile_ms)
        self.cooldown_s = float(cooldown_s)
        self.max_spans = int(max_spans)
        self._tracer = tracer if tracer is not None else TRACER
        self._registry = registry if registry is not None else METRICS
        self._clock = clock
        self._lock = threading.Lock()
        self._win_snap = None
        self._win_t0: Optional[float] = None
        self._last_trip: Optional[float] = None
        self._records: deque = deque(maxlen=8)
        self._seq = 0
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)

    # -- the supervisor check ----------------------------------------------

    def check(self) -> Optional[str]:
        """Close the window if due and evaluate; returns the written
        flight-record path (or reason) when one was captured."""
        now = self._clock()
        with self._lock:
            if self._win_snap is None:
                self._win_snap = self._registry.snapshot()
                self._win_t0 = now
                return None
            if now - self._win_t0 < self.window_s:
                return None
            delta = self._registry.delta(self._win_snap)
            self._win_snap = self._registry.snapshot()
            self._win_t0 = now
            reasons = self._evaluate_locked(delta)
            if not reasons:
                return None
            if self._last_trip is not None and \
                    now - self._last_trip < self.cooldown_s:
                return None
            self._last_trip = now
            rec = self._capture_locked("slo_breach", reasons, delta)
        self._after_capture(rec)
        return rec.get("path") or rec["reason"]

    def _evaluate_locked(self, delta: Dict[str, Any]) -> List[Dict]:
        reasons = []
        for slo in self.slos:
            hit = slo.breached(delta)
            if hit:
                reasons.append(hit)
        for name, labels in self.watch_counters:
            want = tuple(sorted((k, str(v)) for k, v in labels.items()))
            tripped = 0
            for series, n in delta["counters"].items():
                if not series.startswith(name):
                    continue
                if all(f'{k}="{v}"' in series for k, v in want) and n > 0:
                    tripped += n
            if tripped:
                reasons.append({"counter": render_series(name, want),
                                "delta": tripped})
        return reasons

    # -- manual trigger (breaker trips, operator request) ------------------

    def trigger(self, reason: str,
                detail: Optional[Dict[str, Any]] = None) -> Optional[str]:
        now = self._clock()
        with self._lock:
            if self._last_trip is not None and \
                    now - self._last_trip < self.cooldown_s:
                return None
            self._last_trip = now
            delta = self._registry.delta(self._win_snap)
            rec = self._capture_locked(reason, [detail or {}], delta)
        self._after_capture(rec)
        return rec.get("path") or rec["reason"]

    # -- capture -----------------------------------------------------------

    def _offending_spans(self) -> List[Dict[str, Any]]:
        win_t0 = time.time() - self.window_s * 2
        spans = [s for s in self._tracer.snapshot()
                 if s["t1"] is not None and s["t1"] >= win_t0]
        bad = [s for s in spans if s["status"] not in ("ok", "open")]
        slow = sorted((s for s in spans if s["status"] == "ok"),
                      key=lambda s: -(s["duration_s"] or 0.0))
        picked = (bad + slow)[: self.max_spans]
        picked.sort(key=lambda s: (s["t0"], s["sid"]))
        return picked

    def _capture_locked(self, reason: str, details: List[Dict],
                        delta: Dict[str, Any]) -> Dict[str, Any]:
        self._seq += 1
        rec: Dict[str, Any] = {
            "reason": reason,
            "details": details,
            "ts": time.time(),
            "seq": self._seq,
            "metrics_delta": delta,
            "spans": self._offending_spans(),
            "spans_active": self._tracer.active_count(),
        }
        if self.out_dir:
            path = os.path.join(self.out_dir,
                                f"flight_{self._seq:04d}.json")
            try:
                with open(path, "w", encoding="utf-8") as f:
                    json.dump(rec, f, default=str, indent=1)
                rec["path"] = path
            except OSError:
                pass  # capture still lives in memory
        self._records.append(rec)
        return rec

    def _after_capture(self, rec: Dict[str, Any]) -> None:
        _m.count("observe_flight_records_total",
                 flat="observe/flight_records", reason=rec["reason"])
        if self.profile_dir:
            t = threading.Thread(target=self._profile_once,
                                 name="flight-profiler", daemon=True)
            t.start()

    def _profile_once(self) -> None:
        """Arm a short profiler trace; must never propagate a failure."""
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            with self._lock:
                seq = self._seq
            with profile(activities=acts) as prof:
                time.sleep(self.profile_ms / 1000.0)
            os.makedirs(self.profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                self.profile_dir, f"flight_{seq:04d}.trace.json"))
        except Exception:
            pass

    # -- introspection -----------------------------------------------------

    def records(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._records)

    def last_record(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._records[-1] if self._records else None

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            last = self._records[-1] if self._records else None
            return {
                "flight_records": self._seq,
                "last_reason": last["reason"] if last else None,
                "last_path": (last or {}).get("path"),
                "window_s": self.window_s,
                "slos": [s.name for s in self.slos],
            }
