"""Labelled metrics: counters / gauges / histograms with label sets,
layered over the flat ``core.profiling.TIMERS`` registry.

One metric name fans out into series keyed by sorted ``(key, value)``
label tuples; ``snapshot()`` marks a point in time and ``delta(snap)``
reads the window since it.  Every metric name the port emits is declared
in ``CATALOG``; emitting an undeclared name still works but is itself
counted (``observe_undeclared_metrics_total``).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from analytics_zoo_tpu_torch.core.profiling import TIMERS

__all__ = ["CATALOG", "MetricsRegistry", "MetricsSnapshot", "METRICS",
           "count", "set_gauge", "observe", "render_series"]

LabelTuple = Tuple[Tuple[str, str], ...]
SeriesKey = Tuple[str, LabelTuple]

_HIST_RING = 1024

# name -> (type, help, allowed label keys)
CATALOG: Dict[str, Tuple[str, str, Tuple[str, ...]]] = {
    "serving_stage_seconds": (
        "histogram", "per-stage latency of the serving pipeline",
        ("model", "stage")),
    "serving_shed_total": (
        "counter", "requests shed before dispatch, by typed error code",
        ("code", "model")),
    "inference_novel_batch_shapes_total": (
        "counter", "novel batch signatures dispatched", ("model",)),
    "inference_compile_count": (
        "gauge", "distinct batch signatures dispatched", ("model",)),
    "ops_kernel_selected_total": (
        "counter", "kernel routing decisions, one per call, by kernel and "
        "chosen path (cuda | reference)", ("kernel", "path")),
    "observe_undeclared_metrics_total": (
        "counter", "emissions against names missing from CATALOG", ()),
}


def _labels_of(labels: Dict[str, Any]) -> LabelTuple:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def render_series(name: str, labels: LabelTuple) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return f"{name}{{{inner}}}"


class _Hist:
    __slots__ = ("count", "total", "seq", "samples")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.seq = 0  # monotonically increasing sample number
        self.samples: deque = deque(maxlen=_HIST_RING)  # (seq, value)


def _percentile(values: List[float], q: float) -> Optional[float]:
    if not values:
        return None
    vs = sorted(values)
    idx = min(len(vs) - 1, max(0, int(round(q / 100.0 * (len(vs) - 1)))))
    return vs[idx]


class MetricsSnapshot:
    """An immutable mark; feed it back to ``registry.delta``."""

    __slots__ = ("ts", "counters", "hist_marks")

    def __init__(self, ts: float, counters: Dict[SeriesKey, float],
                 hist_marks: Dict[SeriesKey, Tuple[int, float, int]]):
        self.ts = ts
        self.counters = counters
        self.hist_marks = hist_marks  # (count, total, seq)


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[SeriesKey, float] = {}
        self._gauges: Dict[SeriesKey, float] = {}
        self._hists: Dict[SeriesKey, _Hist] = {}

    def _declared(self, name: str) -> None:
        if name not in CATALOG:
            key = ("observe_undeclared_metrics_total", ())
            self._counters[key] = self._counters.get(key, 0) + 1

    def inc(self, name: str, n: float = 1, **labels: Any) -> None:
        key = (name, _labels_of(labels))
        with self._lock:
            self._declared(name)
            self._counters[key] = self._counters.get(key, 0) + n

    def set(self, name: str, value: float, **labels: Any) -> None:
        key = (name, _labels_of(labels))
        with self._lock:
            self._declared(name)
            self._gauges[key] = float(value)

    def observe(self, name: str, value: float, **labels: Any) -> None:
        key = (name, _labels_of(labels))
        with self._lock:
            self._declared(name)
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = _Hist()
            v = float(value)
            h.count += 1
            h.total += v
            h.seq += 1
            h.samples.append((h.seq, v))

    def snapshot(self) -> MetricsSnapshot:
        with self._lock:
            return MetricsSnapshot(
                time.time(), dict(self._counters),
                {k: (h.count, h.total, h.seq)
                 for k, h in self._hists.items()})

    def delta(self, since: Optional[MetricsSnapshot]) -> Dict[str, Any]:
        """The window since ``since`` (or process lifetime if None):
        counter increments, current gauges, and histogram percentiles over
        the samples observed inside the window."""
        with self._lock:
            now = time.time()
            counters = {}
            for k, v in self._counters.items():
                prev = since.counters.get(k, 0) if since else 0
                if v - prev:
                    counters[render_series(*k)] = v - prev
            gauges = {render_series(*k): v
                      for k, v in self._gauges.items()}
            hists = {}
            for k, h in self._hists.items():
                c0, t0, s0 = (since.hist_marks.get(k, (0, 0.0, 0))
                              if since else (0, 0.0, 0))
                dcount = h.count - c0
                if not dcount:
                    continue
                window = [v for s, v in h.samples if s > s0]
                hists[render_series(*k)] = {
                    "count": dcount,
                    "mean": (h.total - t0) / dcount,
                    "p50": _percentile(window, 50),
                    "p99": _percentile(window, 99),
                }
        return {"window_s": (now - since.ts) if since else None,
                "counters": counters, "gauges": gauges, "histograms": hists}


METRICS = MetricsRegistry()


def count(name: str, n: float = 1, flat: Optional[str] = None,
          **labels: Any) -> None:
    METRICS.inc(name, n, **labels)
    if flat:
        TIMERS.incr(flat, int(n))


def set_gauge(name: str, value: float, **labels: Any) -> None:
    METRICS.set(name, value, **labels)


def observe(name: str, seconds: float, flat: Optional[str] = None,
            **labels: Any) -> None:
    METRICS.observe(name, seconds, **labels)
    if flat:
        TIMERS.observe(flat, seconds)
