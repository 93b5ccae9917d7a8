"""Host-side timers and event counters.

``TIMERS`` is the process-wide registry of named durations (count,
total, p50/p99 over a ring of recent samples, which the serving
pipeline's ``health()`` reads per stage), event counters, and gauges
(point-in-time levels: replicas healthy, heartbeat ages).  The
JAX package's ``jax.profiler`` wrappers have no counterpart here: device
traces come from ``torch.profiler``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict

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

    def gauges(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._gauges)

    def stats(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {k: {"count": v.count, "total_s": v.total_s,
                        "mean_s": v.mean_s, "max_s": v.max_s,
                        "p50_s": v.percentile(50), "p99_s": v.percentile(99)}
                    for k, v in self._stats.items()}


TIMERS = Timers()

