"""Supervisor — background health checks + stage heartbeats.

The serving pipeline's self-healing loop (docs/SERVING.md "Failure
semantics"): a single daemon thread runs a set of registered *checks*
every ``interval_s``.  Checks are plain callables that inspect state and
repair it — rebuild quarantined replicas, abandon a hung harvest,
restart a dead stage thread, publish health gauges.  A check that raises
is logged and counted (``robust/supervisor_check_error/<name>``) but
never kills the supervisor: the healer must be harder to kill than the
thing it heals.

:class:`Heartbeat` is the companion liveness registry: each pipeline
stage stamps ``beat(stage)`` as it iterates, and the supervisor's stage
watchdog reads ``age(stage)`` to tell a wedged thread (stale beat while
work is pending) from an idle one.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from analytics_zoo_tpu_torch.observe import metrics as obs

logger = logging.getLogger("analytics_zoo_tpu_torch.robust")


class Heartbeat:
    """Thread-safe per-stage liveness stamps (monotonic clock)."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._beats: Dict[str, float] = {}

    def beat(self, stage: str) -> None:
        with self._lock:
            self._beats[stage] = self._clock()

    def age(self, stage: str) -> float:
        """Seconds since the stage last beat (0.0 if it never has —
        a stage that hasn't started yet is not "stalled")."""
        with self._lock:
            t = self._beats.get(stage)
            return 0.0 if t is None else max(0.0, self._clock() - t)

    def ages(self) -> Dict[str, float]:
        with self._lock:
            now = self._clock()
            return {k: max(0.0, now - t) for k, t in self._beats.items()}


class Supervisor:
    """Daemon thread running registered repair checks on an interval.

    ``stop()`` is idempotent and safe to call from any thread (including
    a check itself).  Checks run sequentially in registration order each
    tick, so a check may rely on an earlier one having run (e.g. the
    harvest watchdog quarantines before the rebuild check looks for
    quarantined slots).
    """

    def __init__(self, interval_s: float = 0.25, name: str = "supervisor"):
        self.interval_s = max(0.01, float(interval_s))
        self.name = name
        self._checks: List[Tuple[str, Callable[[], object], int]] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._tick = 0

    def add_check(self, name: str, fn: Callable[[], object],
                  every: int = 1) -> "Supervisor":
        """Register a repair check.  ``every=k`` runs it on every k-th
        tick only — slow controllers (the serving autoscaler) ride the
        same supervisor thread at a coarser cadence than the hot repair
        checks."""
        with self._lock:
            self._checks.append((name, fn, max(1, int(every))))
        return self

    def start(self) -> "Supervisor":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=self.name)
        self._thread.start()
        return self

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=timeout)

    def is_alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def run_checks_once(self, tick: Optional[int] = None) -> None:
        """One synchronous pass over the checks (tests drive this
        directly for determinism instead of waiting out the interval).
        ``tick=None`` runs EVERY check regardless of its ``every=``
        cadence; the supervisor loop passes its tick counter so coarse
        checks fire on their multiple only."""
        with self._lock:
            checks = list(self._checks)
        for name, fn, every in checks:
            if self._stop.is_set():
                return
            if tick is not None and tick % every != 0:
                continue
            try:
                fn()
            except Exception:
                obs.count("supervisor_check_errors_total", check=name,
                          flat=f"robust/supervisor_check_error/{name}")
                logger.exception("supervisor check %r failed; supervisor "
                                 "continues", name)

    def _loop(self) -> None:
        while not self._stop.wait(timeout=self.interval_s):
            self._tick += 1
            self.run_checks_once(tick=self._tick)
