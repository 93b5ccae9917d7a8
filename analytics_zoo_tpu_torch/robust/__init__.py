"""Resilience: the retry policy, deterministic fault injection, and the
typed errors (the JAX package's ``robust/``; its circuit breaker and
supervisor arrive with ``ClusterServing``)."""

from analytics_zoo_tpu_torch.robust.errors import (  # noqa: F401
    DeadlineExpired,
    ServingError,
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
