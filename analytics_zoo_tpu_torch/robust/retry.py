"""RetryPolicy — exponential backoff + jitter + deadline + sliding window.

The JAX package's ``robust/retry.py``, copied: one policy object covers
both usage shapes:

- ``policy.call(fn, ...)`` — functional: run ``fn``, retrying on the
  configured exception types with backoff until attempts/deadline run
  out (checkpoint writes).
- ``policy.state()`` → :class:`RetryState` — loop-style: an explicit
  failure recorder for retry loops that restore state between attempts
  (the Estimator's retry-from-checkpoint), keeping the reference's
  sliding-window semantics (``failure_retry_interval_s``: old failures
  age out so long jobs survive rare transient faults).

Every attempt/backoff/deadline event is counted in
``core.profiling.TIMERS`` under ``robust/retry_*`` so chaos tests can
assert on behaviour instead of timing.
"""

from __future__ import annotations

import logging
import random
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple, Type

from analytics_zoo_tpu_torch.core.profiling import TIMERS

logger = logging.getLogger("analytics_zoo_tpu_torch.robust")


class RetryDeadlineExceeded(RuntimeError):
    """The retry deadline expired before an attempt succeeded.  The
    causing exception of the last attempt is chained as ``__cause__``."""


@dataclass
class RetryPolicy:
    """Exponential backoff with full-jitter, bounded by attempts and an
    optional wall-clock deadline.

    ``window_s`` gives the sliding-window semantics the Estimator's
    failure retry needs: only failures younger than the window count
    against ``max_attempts``.
    """

    max_attempts: int = 5
    base_delay_s: float = 0.1
    max_delay_s: float = 30.0
    multiplier: float = 2.0
    jitter: float = 0.1            # +/- fraction of the computed delay
    deadline_s: Optional[float] = None
    window_s: Optional[float] = None
    retry_on: Tuple[Type[BaseException], ...] = (Exception,)
    name: str = "retry"
    # observer invoked once per FAILED attempt inside ``call`` (attempt
    # number, exception) before the backoff sleep
    on_retry: Optional[Callable[[int, BaseException], None]] = None
    # injectable for determinism in tests (and to keep chaos suites fast)
    sleep: Callable[[float], None] = time.sleep
    clock: Callable[[], float] = time.monotonic
    seed: Optional[int] = None
    _rng: random.Random = field(init=False, repr=False, default=None)

    def __post_init__(self):
        self._rng = random.Random(self.seed)

    @classmethod
    def from_config(cls, cfg, **overrides) -> "RetryPolicy":
        """Policy from the ``retry_*`` config knobs (core/config.py)."""
        kw = dict(max_attempts=cfg.retry_max_attempts,
                  base_delay_s=cfg.retry_base_delay_s,
                  max_delay_s=cfg.retry_max_delay_s,
                  multiplier=cfg.retry_multiplier,
                  jitter=cfg.retry_jitter,
                  deadline_s=cfg.retry_deadline_s)
        kw.update(overrides)
        return cls(**kw)

    def delay(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (1-based)."""
        d = min(self.max_delay_s,
                self.base_delay_s * (self.multiplier ** max(0, attempt - 1)))
        if self.jitter:
            d *= 1.0 + self._rng.uniform(-self.jitter, self.jitter)
        return max(0.0, d)

    def state(self) -> "RetryState":
        return RetryState(self)

    def call(self, fn: Callable, *args, **kwargs):
        """Run ``fn(*args, **kwargs)``, retrying on ``retry_on`` with
        backoff.  Raises the last error once attempts are exhausted, or
        :class:`RetryDeadlineExceeded` once the deadline would pass."""
        start = self.clock()
        attempt = 0
        while True:
            try:
                return fn(*args, **kwargs)
            except self.retry_on as e:
                attempt += 1
                TIMERS.incr(f"robust/retry_attempts/{self.name}")
                if self.on_retry is not None:
                    try:
                        self.on_retry(attempt, e)
                    except Exception:
                        logger.debug("%s: on_retry observer raised",
                                     self.name, exc_info=True)
                if attempt >= self.max_attempts:
                    TIMERS.incr(f"robust/retry_exhausted/{self.name}")
                    raise
                d = self.delay(attempt)
                if (self.deadline_s is not None
                        and self.clock() - start + d > self.deadline_s):
                    TIMERS.incr(f"robust/retry_deadline/{self.name}")
                    raise RetryDeadlineExceeded(
                        f"{self.name}: deadline {self.deadline_s}s exceeded "
                        f"after {attempt} attempts") from e
                logger.warning("%s: attempt %d/%d failed (%s); retrying in "
                               "%.3fs", self.name, attempt,
                               self.max_attempts, e, d)
                self.sleep(d)


class RetryState:
    """Loop-style failure recorder for a :class:`RetryPolicy`.

    ``record_failure()`` returns whether the caller should retry (ages
    failures out of the sliding window first); ``backoff()`` sleeps the
    policy's next delay.  The caller owns the actual retry (restoring a
    checkpoint, rebuilding an iterator, ...).
    """

    def __init__(self, policy: RetryPolicy):
        self.policy = policy
        self.start = policy.clock()
        self.fail_times: List[float] = []

    @property
    def failures(self) -> int:
        return len(self.fail_times)

    def record_failure(self) -> bool:
        p = self.policy
        now = p.clock()
        if p.window_s is not None:
            self.fail_times = [t for t in self.fail_times
                               if now - t < p.window_s]
        self.fail_times.append(now)
        TIMERS.incr(f"robust/retry_attempts/{p.name}")
        if len(self.fail_times) > p.max_attempts:
            TIMERS.incr(f"robust/retry_exhausted/{p.name}")
            return False
        if (p.deadline_s is not None
                and now - self.start > p.deadline_s):
            TIMERS.incr(f"robust/retry_deadline/{p.name}")
            return False
        return True

    def backoff(self) -> None:
        self.policy.sleep(self.policy.delay(len(self.fail_times)))

    def describe(self) -> str:
        p = self.policy
        win = (f" within {p.window_s:.0f}s window"
               if p.window_s is not None else "")
        return f"{len(self.fail_times)}/{p.max_attempts}{win}"
