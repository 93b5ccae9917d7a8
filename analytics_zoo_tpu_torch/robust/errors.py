"""Typed errors: every serving error carries a stable ``code`` that
clients branch on instead of parsing messages; ``TrainingPreempted``
ends a preempted ``fit``.

``SERVING_ERROR_CODES`` lists every ``code`` a typed serving error
payload may carry (the JAX package's table, less ``mesh_replica_lost``,
whose mesh replicas the port does not have yet).
"""

from __future__ import annotations

# code -> one-line meaning
SERVING_ERROR_CODES = {
    "expired": "client TTL elapsed before the pipeline could serve it",
    "overloaded": "shed at admission: projected wait exceeds the TTL",
    "malformed": "record cannot be decoded/encoded for serving",
    "decode_error": "decode stage raised while materializing tensors",
    "model_error": "model forward failed (or no healthy replica)",
    "host_lost": "a peer process missed a coordination barrier deadline",
    "internal": "unclassified server-side failure",
}


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


class ServingOverloaded(ServingError):
    """Shed at admission: the estimated pipeline wait already exceeds
    the record's remaining TTL (or a shared-memory ring stayed full), so
    serving it would only spend device time on an answer the client has
    given up on."""

    code = "overloaded"


class MalformedRecordError(ServingError, ValueError):
    """The record cannot be decoded/encoded for serving (no tensor
    fields, non-encodable dtype, invalid TTL).  Raised client-side by
    ``InputQueue`` validation and worker-side by the decode stage."""

    code = "malformed"


class HostLostError(RuntimeError):
    """A peer process failed to reach a coordination barrier within its
    deadline and is presumed dead.  Not retried by the failure-retry
    loop: a dead peer cannot be fixed by a local restore-and-retry."""

    code = "host_lost"

    def __init__(self, message: str, barrier: str = "",
                 timeout_s: float = None):
        super().__init__(message)
        self.barrier = barrier
        self.timeout_s = timeout_s


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
