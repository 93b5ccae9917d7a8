from analytics_zoo_tpu_torch.robust.errors import (  # noqa: F401
    DeadlineExpired,
    ServingError,
)
