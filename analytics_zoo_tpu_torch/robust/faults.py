"""FaultInjector — deterministic fault injection at named sites.

Chaos testing substrate: production code consults cheap hooks
(``fire(site)`` / ``inject(site)``) that are no-ops unless an injector
is active, and tests activate an injector with an explicit plan — *the
Nth call at this site fails in this way* — so every chaos scenario is
deterministic and replayable (no random sleeps, no flaky races).

Sites wired into the port (call granularity in parentheses); the
names are the JAX package's:

- ``checkpoint.write``    — one per ``save_pytree`` (raise, or the
                            ``torn`` action: the final path receives a
                            truncated archive, as a non-atomic writer
                            dying mid-write would leave it)
- ``prefetch.producer``   — one per item the prefetch producer yields
- ``estimator.step``      — one per prepared batch on the host input
                            paths (raise, or ``nan``: the batch's float
                            arrays are NaN, so the loss is; a batch of
                            ids and integer labels has its loss made NaN)
- ``estimator.preempt``   — one per train step; firing simulates SIGTERM
                            (the ``sigterm`` action sends the real
                            signal to this process, through the
                            handler ``fit`` installs)
- ``estimator.resident_nan_rows`` — one per device-resident epoch
                            (payload: row indices whose float values
                            become NaN for that epoch)

Usage::

    fi = FaultInjector()
    fi.plan("checkpoint.write", at=2, action="torn")
    fi.plan("prefetch.producer", at=5, exc=RuntimeError("disk gone"))
    with fi:
        run_training()
    assert fi.fired["checkpoint.write"] == 1

Thread-safe: sites are consulted from producer/writer threads.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Iterable, List, Optional, Union

import numpy as np

from analytics_zoo_tpu_torch.core.profiling import TIMERS

_ACTIVE: Optional["FaultInjector"] = None
_ACTIVE_LOCK = threading.Lock()


class _Plan:
    __slots__ = ("at", "exc", "action", "payload")

    def __init__(self, at, exc, action, payload):
        self.at = at            # set of 0-based call indices
        self.exc = exc          # exception instance/class to raise
        self.action = action    # site-specific action tag ("torn", "nan"...)
        self.payload = payload  # site-specific extra data


class FaultInjector:
    """Deterministic planned faults, keyed by (site, call index)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._plans: Dict[str, List[_Plan]] = {}
        self._calls: Dict[str, int] = {}
        self.fired: Dict[str, int] = {}

    # -- planning ----------------------------------------------------------
    def plan(self, site: str, at: Union[int, Iterable[int]] = 0, *,
             exc: Optional[BaseException] = None,
             action: Optional[str] = None,
             payload: Any = None) -> "FaultInjector":
        """Arm ``site`` to fail at the given 0-based call indices."""
        idx = {int(at)} if isinstance(at, (int, np.integer)) \
            else {int(i) for i in at}
        with self._lock:
            self._plans.setdefault(site, []).append(
                _Plan(idx, exc, action, payload))
        return self

    # -- activation --------------------------------------------------------
    def __enter__(self) -> "FaultInjector":
        global _ACTIVE
        with _ACTIVE_LOCK:
            if _ACTIVE is not None:
                raise RuntimeError("another FaultInjector is already active")
            _ACTIVE = self
        return self

    def __exit__(self, *exc_info) -> None:
        global _ACTIVE
        with _ACTIVE_LOCK:
            _ACTIVE = None

    # -- consultation ------------------------------------------------------
    def calls(self, site: str) -> int:
        with self._lock:
            return self._calls.get(site, 0)

    def _consult(self, site: str) -> Optional[_Plan]:
        with self._lock:
            i = self._calls.get(site, 0)
            self._calls[site] = i + 1
            for plan in self._plans.get(site, ()):
                if i in plan.at:
                    self.fired[site] = self.fired.get(site, 0) + 1
                    TIMERS.incr(f"robust/fault_injected/{site}")
                    return plan
        return None


def get_injector() -> Optional[FaultInjector]:
    return _ACTIVE


def fire(site: str) -> Optional[_Plan]:
    """Consult ``site``; returns the matching plan if a fault fires at
    this call index (None otherwise, and always None when no injector
    is active — the happy-path cost is one global read)."""
    inj = _ACTIVE
    if inj is None:
        return None
    return inj._consult(site)


def inject(site: str) -> None:
    """Consult ``site`` and raise its planned exception if one fires
    (for sites whose only failure mode is an exception)."""
    plan = fire(site)
    if plan is not None and plan.exc is not None:
        raise plan.exc


def poison_nan(arrays):
    """NaN-fill every float array in ``arrays`` (non-float pass through
    untouched) — used by the ``estimator.step`` NaN action: NaN inputs
    guarantee a NaN loss through any differentiable model."""
    out = []
    for a in arrays:
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.floating):
            a = np.full_like(a, np.nan)
        out.append(a)
    return out
