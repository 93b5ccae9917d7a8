"""Typed errors: every serving error carries a stable ``code`` that
clients branch on instead of parsing messages; ``TrainingPreempted``
ends a preempted ``fit``."""

from __future__ import annotations


class ServingError(Exception):
    """Base of the serving pipeline's typed error contract."""

    code = "internal"

    def __init__(self, message: str, code: str = None):
        super().__init__(message)
        if code is not None:
            self.code = code


class DeadlineExpired(ServingError):
    """The record's client TTL elapsed before (or while) the pipeline
    could serve it — the work was shed, not attempted and failed."""

    code = "expired"


class TrainingPreempted(Exception):
    """Raised by ``Estimator.fit`` after a preemption (SIGTERM or an
    injected fault) has been handled: the final synchronous checkpoint
    is already on disk when this propagates, and ``fit(resume=True)``
    continues the run where it stopped.

    Not retried by the failure-retry loop: a preemption means the host
    is going away."""

    def __init__(self, message: str, step: int = -1):
        super().__init__(message)
        self.step = step
