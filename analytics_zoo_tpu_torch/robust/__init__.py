"""Resilience: the retry policy, deterministic fault injection, the
typed errors, and the serving pipeline's self-healing pieces (the JAX
package's ``robust/``):

- :class:`CircuitBreaker` — consecutive-failure health state machine
  (closed → open → half-open probe) guarding each serving replica, and
  :class:`QuarantineBroadcast`, its once-per-epoch group trip;
- :class:`Supervisor` / :class:`Heartbeat` — background repair checks
  (replica rebuild, harvest watchdog, stage restart) and per-stage
  liveness stamps.
"""

from analytics_zoo_tpu_torch.robust.breaker import (  # noqa: F401
    CircuitBreaker,
    QuarantineBroadcast,
)
from analytics_zoo_tpu_torch.robust.errors import (  # noqa: F401
    SERVING_ERROR_CODES,
    DeadlineExpired,
    HostLostError,
    MalformedRecordError,
    ServingError,
    ServingOverloaded,
    TrainingPreempted,
)
from analytics_zoo_tpu_torch.robust.faults import (  # noqa: F401
    FaultInjector,
    fire,
    inject,
)
from analytics_zoo_tpu_torch.robust.retry import (  # noqa: F401
    RetryDeadlineExceeded,
    RetryPolicy,
    RetryState,
)
from analytics_zoo_tpu_torch.robust.supervisor import (  # noqa: F401
    Heartbeat,
    Supervisor,
)
