"""Labelled metrics: counters / gauges / histograms with label sets,
layered over the flat ``core.profiling.TIMERS`` registry.

One metric name fans out into series keyed by sorted ``(key, value)``
label tuples; ``snapshot()`` marks a point in time and ``delta(snap)``
reads the window since it.  The module-level helpers take a ``flat=``
name that mirrors the labelled series onto the flat ``TIMERS`` counter,
timer or gauge the serving pipeline's ``health()`` reads.  Every metric
name the port emits is declared in ``CATALOG``; emitting an undeclared
name still works but is itself counted
(``observe_undeclared_metrics_total``).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterable, List, Optional, Tuple

from analytics_zoo_tpu_torch.core.profiling import TIMERS

__all__ = ["CATALOG", "MetricsRegistry", "MetricsSnapshot", "METRICS",
           "count", "set_gauge", "observe", "time_stage", "render_series"]

LabelTuple = Tuple[Tuple[str, str], ...]
SeriesKey = Tuple[str, LabelTuple]

_HIST_RING = 1024

# name -> (type, help, allowed label keys)
CATALOG: Dict[str, Tuple[str, str, Tuple[str, ...]]] = {
    # serving pipeline (the ``model`` label names the serving model in a
    # multi-model pipeline; single-model paths emit model="default")
    "serving_stage_seconds": (
        "histogram", "per-stage latency of the serving pipeline",
        ("model", "stage")),
    "serving_records_total": (
        "counter", "records answered, by outcome (ok|error)",
        ("model", "outcome")),
    "serving_shed_total": (
        "counter", "records shed before the device, by typed code",
        ("code", "model")),
    "serving_errors_total": (
        "counter", "typed error payloads returned, by code",
        ("code", "model")),
    "serving_batches_total": (
        "counter", "batches dispatched to a device replica",
        ("model", "replica")),
    "serving_batch_rows_total": (
        "counter", "rows dispatched to a device replica",
        ("model", "replica")),
    "serving_batch_retries_total": (
        "counter", "batches retried on a healthy peer replica",
        ("model",)),
    "serving_replica_events_total": (
        "counter", "replica lifecycle events "
        "(quarantined|restored|rebuilt)", ("event", "model", "replica")),
    "serving_shm_lease_reclaims_total": (
        "counter", "shm result-slot leases harvested because the owner "
        "process died before get_result", ()),
    "serving_stage_restarts_total": (
        "counter", "dead stage threads respawned by the supervisor",
        ("stage",)),
    "serving_device_busy_seconds_total": (
        "counter", "seconds the card ran the bucket programs of harvested "
        "flights, timed by CUDA events around each replay", ("model",)),
    "serving_inflight": (
        "gauge", "batches dispatched and not yet harvested", ()),
    "serving_replicas_healthy": (
        "gauge", "replicas currently accepting batches", ("model",)),
    "serving_compile_cache_events_total": (
        "counter", "persistent compile-cache outcomes "
        "(hit|miss|corrupt|version_skew)", ("event", "model")),
    "serving_autoscale_actions_total": (
        "counter", "autoscaler decisions applied, by resource "
        "(decode_workers|replicas|batch_deadline) and direction "
        "(up|down)", ("direction", "model", "resource")),
    "inference_novel_batch_shapes_total": (
        "counter", "novel batch signatures dispatched (one per live "
        "capture)", ("model",)),
    "inference_compile_count": (
        "gauge", "distinct batch signatures captured live "
        "(cache-warmed signatures excluded)", ("model",)),
    "serving_heartbeat_age_seconds": (
        "gauge", "age of each stage's last heartbeat", ("stage",)),
    "serving_wire_bytes_total": (
        "counter", "tensor payload bytes crossing the serving wire, by "
        "codec (json_b64|binary|file|shm)", ("codec",)),
    "serving_codec_seconds": (
        "histogram", "wire codec encode/decode wall time, by codec and "
        "direction", ("codec", "op")),
    # load harness (loadgen/ — docs/LOADGEN.md)
    "loadgen_requests_total": (
        "counter", "requests offered by the open-loop generator, by "
        "traffic leg and target model", ("leg", "model")),
    "loadgen_outcomes_total": (
        "counter", "terminal outcomes observed by loadgen clients "
        "(ok | typed error code | lost)", ("model", "outcome")),
    "loadgen_schedule_lag_seconds": (
        "histogram", "how far behind its Poisson slot each send fired "
        "(open-loop honesty: stays flat while the server stalls)",
        ("leg",)),
    "loadgen_open_loop_drops_total": (
        "counter", "scheduled sends the transport refused (ring full, "
        "queue closed) — the schedule moves on instead of blocking",
        ("leg",)),
    # robustness
    "breaker_transitions_total": (
        "counter", "circuit breaker state transitions",
        ("breaker", "to")),
    "supervisor_check_errors_total": (
        "counter", "supervisor checks that raised", ("check",)),
    # training
    "train_steps_total": (
        "counter", "optimizer steps dispatched, by dispatch kind "
        "(1|K|resident)", ("kind",)),
    "train_step_seconds": (
        "histogram", "host wall time of one step dispatch", ("kind",)),
    "prefetch_queue_depth": (
        "gauge", "batches queued ahead of the consumer in the prefetch "
        "pipeline", ()),
    "prefetch_producer_stalls_total": (
        "counter", "producer put() attempts that found the prefetch "
        "queue full (consumer is the bottleneck)", ()),
    "checkpoint_seconds": (
        "histogram", "checkpoint op wall time", ("op",)),
    "checkpoint_total": (
        "counter", "checkpoint ops, by op and status", ("op", "status")),
    # kernel dispatch and CUDA graphs
    "ops_kernel_selected_total": (
        "counter", "kernel routing decisions, one per call, by kernel and "
        "chosen path (cuda | reference)", ("kernel", "path")),
    "graph_captures_total": (
        "counter", "CUDA graphs captured, by owner (train|serving)",
        ("kind",)),
    "graph_capture_seconds": (
        "histogram", "wall time of one CUDA graph capture", ("kind",)),
    # the observability layer itself
    "observe_flight_records_total": (
        "counter", "flight-recorder snapshots captured, by reason",
        ("reason",)),
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
    __slots__ = ("count", "total", "vmin", "vmax", "seq", "samples")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None
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

    __slots__ = ("ts", "counters", "gauges", "hist_marks")

    def __init__(self, ts: float, counters: Dict[SeriesKey, float],
                 gauges: Dict[SeriesKey, float],
                 hist_marks: Dict[SeriesKey, Tuple[int, float, int]]):
        self.ts = ts
        self.counters = counters
        self.gauges = gauges
        self.hist_marks = hist_marks  # (count, total, seq)


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[SeriesKey, float] = {}
        self._gauges: Dict[SeriesKey, float] = {}
        self._hists: Dict[SeriesKey, _Hist] = {}

    # -- write path --------------------------------------------------------

    def _declared(self, name: str) -> bool:
        if name in CATALOG:
            return True
        key = ("observe_undeclared_metrics_total", ())
        self._counters[key] = self._counters.get(key, 0) + 1
        return False

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
            h.vmin = v if h.vmin is None else min(h.vmin, v)
            h.vmax = v if h.vmax is None else max(h.vmax, v)
            h.seq += 1
            h.samples.append((h.seq, v))

    # -- read path ---------------------------------------------------------

    def snapshot(self) -> MetricsSnapshot:
        with self._lock:
            return MetricsSnapshot(
                time.time(), dict(self._counters), dict(self._gauges),
                {k: (h.count, h.total, h.seq)
                 for k, h in self._hists.items()})

    def delta(self, since: Optional[MetricsSnapshot]) -> Dict[str, Any]:
        """The window since ``since`` (or process lifetime if None).

        Histogram percentiles are computed over only the samples whose
        sequence number postdates the snapshot — a true window read, to
        the extent the per-series sample ring (last ``1024``) reaches
        back that far.
        """
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
                    "total": h.total - t0,
                    "mean": (h.total - t0) / dcount,
                    "p50": _percentile(window, 50),
                    "p99": _percentile(window, 99),
                    "max": max(window) if window else None,
                    "window_samples": len(window),
                }
        return {
            "window_s": (now - since.ts) if since else None,
            "counters": counters, "gauges": gauges, "histograms": hists,
        }

    def collect(self) -> Iterable[Tuple[str, str, str,
                                        List[Tuple[LabelTuple, Any]]]]:
        """(name, type, help, [(labels, value-or-hist)]) for exporters,
        sorted by name for stable output."""
        with self._lock:
            by_name: Dict[str, List[Tuple[LabelTuple, Any]]] = {}
            kinds: Dict[str, str] = {}
            for (name, labels), v in self._counters.items():
                by_name.setdefault(name, []).append((labels, v))
                kinds[name] = "counter"
            for (name, labels), v in self._gauges.items():
                by_name.setdefault(name, []).append((labels, v))
                kinds[name] = "gauge"
            for (name, labels), h in self._hists.items():
                summary = {
                    "count": h.count, "sum": h.total,
                    "p50": _percentile([v for _, v in h.samples], 50),
                    "p99": _percentile([v for _, v in h.samples], 99),
                }
                by_name.setdefault(name, []).append((labels, summary))
                kinds[name] = "histogram"
        out = []
        for name in sorted(by_name):
            help_ = CATALOG.get(name, ("", "", ()))[1]
            out.append((name, kinds[name], help_,
                        sorted(by_name[name], key=lambda kv: kv[0])))
        return out

    def series_count(self) -> int:
        with self._lock:
            return (len(self._counters) + len(self._gauges) +
                    len(self._hists))

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


METRICS = MetricsRegistry()


# -- module-level helpers with the flat-Timers mirror -----------------------


def count(name: str, n: float = 1, flat: Optional[str] = None,
          **labels: Any) -> None:
    METRICS.inc(name, n, **labels)
    if flat:
        TIMERS.incr(flat, int(n))


def set_gauge(name: str, value: float, flat: Optional[str] = None,
              **labels: Any) -> None:
    METRICS.set(name, value, **labels)
    if flat:
        TIMERS.set_gauge(flat, value)


def observe(name: str, seconds: float, flat: Optional[str] = None,
            **labels: Any) -> None:
    METRICS.observe(name, seconds, **labels)
    if flat:
        TIMERS.observe(flat, seconds)


@contextmanager
def time_stage(name: str, flat: Optional[str] = None, **labels: Any):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        observe(name, time.perf_counter() - t0, flat=flat, **labels)
