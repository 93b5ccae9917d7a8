"""CircuitBreaker — consecutive-failure replica health state machine.

The serving DeviceExecutor gives every model replica one breaker; the
breaker decides, per dispatch, whether the replica may receive work
(docs/SERVING.md "Failure semantics").  Three states:

- **closed**     — normal operation.  Failures increment a consecutive
                   counter; any success clears it.  ``failure_threshold``
                   consecutive failures open the breaker.
- **open**       — quarantined: ``allow()`` refuses all work until
                   ``cooldown_s`` has elapsed since opening.
- **half-open**  — after the cooldown, exactly ONE probe dispatch is let
                   through.  Success closes the breaker (the replica is
                   restored); failure re-opens it and the cooldown
                   restarts.

The health view collapses to the three-stage replica lifecycle:
``healthy`` (closed, no recent failures) → ``degraded`` (closed, some
consecutive failures below the threshold) → ``quarantined`` (open or
probing).

Like :class:`~analytics_zoo_tpu_torch.robust.retry.RetryPolicy`, the clock is
injectable so chaos tests step time deterministically instead of
sleeping.  All methods are thread-safe: ``allow()`` is called from the
executor's dispatch thread while ``record_*`` arrive from the harvest
thread and ``force_open`` from the supervisor's watchdog.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict

from analytics_zoo_tpu_torch.core.profiling import TIMERS
from analytics_zoo_tpu_torch.observe import metrics as obs

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """Consecutive-failure breaker with a single-probe half-open state."""

    def __init__(self, failure_threshold: int = 3, cooldown_s: float = 2.0,
                 name: str = "breaker",
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = max(1, int(failure_threshold))
        self.cooldown_s = float(cooldown_s)
        self.name = name
        self.clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._opened_t = 0.0
        self._probe_inflight = False
        self.open_count = 0     # times the breaker has opened (ever)
        self.failures = 0       # total recorded failures (ever)

    # -- state views -------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def health(self) -> str:
        """The replica-lifecycle view: healthy → degraded → quarantined."""
        with self._lock:
            if self._state != CLOSED:
                return "quarantined"
            return "degraded" if self._consecutive else "healthy"

    @property
    def consecutive_failures(self) -> int:
        with self._lock:
            return self._consecutive

    def open_age_s(self) -> float:
        """Seconds since the breaker last opened (0 while closed)."""
        with self._lock:
            if self._state == CLOSED:
                return 0.0
            return max(0.0, self.clock() - self._opened_t)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"state": self._state,
                    "health": ("quarantined" if self._state != CLOSED else
                               "degraded" if self._consecutive else
                               "healthy"),
                    "consecutive_failures": self._consecutive,
                    "failures": self.failures,
                    "opens": self.open_count,
                    "open_age_s": (0.0 if self._state == CLOSED
                                   else max(0.0,
                                            self.clock() - self._opened_t))}

    # -- decisions ---------------------------------------------------------
    def allow(self) -> bool:
        """May a dispatch go to this replica right now?  In the open
        state this is also where the half-open transition happens: the
        first call after the cooldown claims the single probe slot."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self.clock() - self._opened_t < self.cooldown_s:
                    return False
                self._state = HALF_OPEN
                self._probe_inflight = True
                TIMERS.incr(f"robust/breaker_probe/{self.name}")
                return True
            # HALF_OPEN: one probe at a time
            if self._probe_inflight:
                return False
            self._probe_inflight = True
            TIMERS.incr(f"robust/breaker_probe/{self.name}")
            return True

    def record_success(self) -> bool:
        """Outcome hook.  Returns True when this success CLOSED a
        previously open/probing breaker (the replica was restored)."""
        with self._lock:
            self._probe_inflight = False
            self._consecutive = 0
            restored = self._state != CLOSED
            self._state = CLOSED
        if restored:
            obs.count("breaker_transitions_total", breaker=self.name,
                      to="closed", flat=f"robust/breaker_closed/{self.name}")
        return restored

    def record_failure(self) -> bool:
        """Outcome hook.  Returns True when this failure OPENED the
        breaker (threshold reached, or a half-open probe failed)."""
        with self._lock:
            self.failures += 1
            self._probe_inflight = False
            self._consecutive += 1
            was_open = self._state == OPEN
            trip = (self._state == HALF_OPEN
                    or self._consecutive >= self.failure_threshold)
            if trip:
                self._state = OPEN
                self._opened_t = self.clock()
                if not was_open:
                    self.open_count += 1
        if trip and not was_open:
            # the flight recorder watches this labeled counter: any
            # breaker opening inside a window trips a snapshot
            obs.count("breaker_transitions_total", breaker=self.name,
                      to="open", flat=f"robust/breaker_open/{self.name}")
            return True
        return False

    def force_open(self) -> bool:
        """Quarantine immediately (supervisor watchdog: a hung replica
        never *returns* a failure, so the breaker is opened for it).
        Returns True if the breaker was not already open."""
        with self._lock:
            self.failures += 1
            self._probe_inflight = False
            self._consecutive = max(self._consecutive + 1,
                                    self.failure_threshold)
            was_open = self._state == OPEN
            self._state = OPEN
            self._opened_t = self.clock()
            if not was_open:
                self.open_count += 1
        if not was_open:
            obs.count("breaker_transitions_total", breaker=self.name,
                      to="open", flat=f"robust/breaker_open/{self.name}")
            return True
        return False

    def reset(self) -> None:
        """Back to a fresh closed breaker (a rebuilt replica starts with
        a clean slate; historical ``opens``/``failures`` are kept for
        telemetry)."""
        with self._lock:
            self._state = CLOSED
            self._consecutive = 0
            self._probe_inflight = False


class QuarantineBroadcast:
    """Epoch-tagged atomic group quarantine for mesh replicas.

    A mesh replica is ONE failure domain spread over many breakers (one
    per mesh-replica slot, and — across hosts — one per surviving
    process).  When a member host dies, every survivor observes the
    loss independently (its own dispatch barrier times out), so the
    naive reaction would trip the same breakers repeatedly and at
    slightly different times.  The broadcast makes the reaction atomic
    and idempotent: a loss event is tagged with the host-roster *epoch*
    it was observed at, and ``trip(epoch, breakers)`` force-opens the
    whole set exactly once per epoch — later observers of the same
    epoch are no-ops, so concurrent harvest threads, supervisor ticks
    and barrier-timeout handlers collapse into one quarantine.

    Thread-safe; the epoch ledger is guarded by its own lock while the
    breakers use theirs (``force_open``), so there is no nested-lock
    order to get wrong.
    """

    def __init__(self, name: str = "mesh"):
        self.name = name
        self._lock = threading.Lock()
        self._seen: set = set()
        self._last_epoch = 0

    @property
    def last_epoch(self) -> int:
        with self._lock:
            return self._last_epoch

    def tripped(self, epoch: int) -> bool:
        with self._lock:
            return int(epoch) in self._seen

    def trip(self, epoch: int, breakers) -> bool:
        """Force-open every breaker in ``breakers`` for loss ``epoch``.
        Returns True when THIS call performed the trip, False when the
        epoch was already quarantined (idempotent re-observation)."""
        epoch = int(epoch)
        with self._lock:
            if epoch in self._seen:
                return False
            self._seen.add(epoch)
            self._last_epoch = max(self._last_epoch, epoch)
        for b in breakers:
            b.force_open()
        TIMERS.incr(f"robust/quarantine_broadcast/{self.name}")
        return True
