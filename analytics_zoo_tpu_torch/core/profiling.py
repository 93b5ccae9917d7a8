"""Host-side timers and event counters, and device traces.

``TIMERS`` is the process-wide registry of named durations (count,
total, p50/p99 over a ring of recent samples, which the serving
pipeline's ``health()`` reads per stage), event counters, and gauges
(point-in-time levels: replicas healthy, heartbeat ages); ``timeit``
and ``count_event`` feed it.  ``trace`` captures a ``torch.profiler``
trace of the host and the card (the JAX package's ``jax.profiler``
wrapper), and ``annotate`` names a region inside it.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional

logger = logging.getLogger("analytics_zoo_tpu_torch.profiling")

# per-stat reservoir of recent durations for percentile rollups
_MAX_SAMPLES = 512


@dataclass
class _Stat:
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0
    samples: list = field(default_factory=list)  # ring of recent durations
    cursor: int = 0  # next ring slot to overwrite once the ring is full

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0

    def add(self, dt: float) -> None:
        self.count += 1
        self.total_s += dt
        self.max_s = max(self.max_s, dt)
        if len(self.samples) < _MAX_SAMPLES:
            self.samples.append(dt)
        else:
            self.samples[self.cursor] = dt
            self.cursor = (self.cursor + 1) % _MAX_SAMPLES

    def percentile(self, q: float) -> float:
        """q-th percentile (0-100) over the recent-sample ring."""
        if not self.samples:
            return 0.0
        s = sorted(self.samples)
        i = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
        return s[i]


class Timers:
    """Process-wide named durations + event counters (thread-safe)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._stats: Dict[str, _Stat] = {}
        self._counts: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}

    @contextlib.contextmanager
    def scope(self, name: str, log: bool = False) -> Iterator[None]:
        """Time the block under ``name`` (logged when ``log``)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.observe(name, dt)
            if log:
                logger.info("[timeit] %s: %.3fms", name, dt * 1e3)

    def observe(self, name: str, seconds: float) -> None:
        """Record one duration measured externally."""
        with self._lock:
            self._stats.setdefault(name, _Stat()).add(seconds)

    def percentile(self, name: str, q: float) -> float:
        """q-th percentile (0-100) of the named timer's recent samples
        (0.0 if never observed)."""
        with self._lock:
            s = self._stats.get(name)
            return s.percentile(q) if s else 0.0

    def incr(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def count(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def set_gauge(self, name: str, value: float) -> None:
        """Record a point-in-time level; unlike a counter it overwrites,
        so the reader sees the current state."""
        with self._lock:
            self._gauges[name] = float(value)

    def gauge(self, name: str, default: float = 0.0) -> float:
        with self._lock:
            return self._gauges.get(name, default)

    def gauges(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._gauges)

    def stats(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {k: {"count": v.count, "total_s": v.total_s,
                        "mean_s": v.mean_s, "max_s": v.max_s,
                        "p50_s": v.percentile(50), "p99_s": v.percentile(99)}
                    for k, v in self._stats.items()}

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()
            self._counts.clear()
            self._gauges.clear()

    def report(self) -> str:
        """A table of the timers (longest total first), then the counters
        and gauges: the JAX package's layout."""
        lines = ["name count total_s mean_ms p50_ms p99_ms max_ms"]
        for k, v in sorted(self.stats().items(),
                           key=lambda kv: -kv[1]["total_s"]):
            lines.append(f"{k} {v['count']} {v['total_s']:.3f} "
                         f"{v['mean_s'] * 1e3:.2f} {v['p50_s'] * 1e3:.2f} "
                         f"{v['p99_s'] * 1e3:.2f} {v['max_s'] * 1e3:.2f}")
        counts = self.counts()
        if counts:
            lines.append("-- counters --")
            for k, n in sorted(counts.items()):
                lines.append(f"{k} {n}")
        gauges = self.gauges()
        if gauges:
            lines.append("-- gauges --")
            for k, v in sorted(gauges.items()):
                lines.append(f"{k} {v:g}")
        return "\n".join(lines)


TIMERS = Timers()


def timeit(name: str, log: bool = False):
    """``with timeit("shard_batch"): ...`` — a scoped wall-clock timer."""
    return TIMERS.scope(name, log=log)


def count_event(name: str, n: int = 1) -> None:
    """Bump a process-wide event counter (``TIMERS.counts()`` reads it)."""
    TIMERS.incr(name, n)


# one profiler trace per process: a nested trace() raises instead of
# corrupting the active one
_trace_lock = threading.Lock()
_active_trace_dir: Optional[str] = None


@contextlib.contextmanager
def trace(log_dir: str, annotation: Optional[str] = None) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the host and, where there is
    one, the card into ``log_dir`` (a Chrome trace, ``trace.json``,
    readable by Perfetto or TensorBoard's profile plugin).

    A nested ``trace()`` raises ``RuntimeError``, and a profiler that
    failed to start is never stopped.  The profiler runs only on the
    thread that opened it: a CUDA graph captured inside the block on
    another thread is not traced."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    global _active_trace_dir
    with _trace_lock:
        if _active_trace_dir is not None:
            raise RuntimeError(
                f"profiling.trace({log_dir!r}) called while a trace into "
                f"{_active_trace_dir!r} is active; one trace per process "
                "— end the outer trace first")
        _active_trace_dir = log_dir
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    started = False
    try:
        prof.__enter__()
        started = True
        if annotation:
            with annotate(annotation):
                yield
        else:
            yield
    finally:
        with _trace_lock:
            _active_trace_dir = None
        if started:
            prof.__exit__(None, None, None)
            os.makedirs(log_dir, exist_ok=True)
            path = os.path.join(log_dir, "trace.json")
            prof.export_chrome_trace(path)
            logger.info("profiler trace written to %s", path)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region on the profiler's timeline
    (``torch.profiler.record_function``)."""
    import torch

    with torch.profiler.record_function(name):
        yield

