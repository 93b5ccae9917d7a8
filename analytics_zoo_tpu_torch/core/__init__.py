from analytics_zoo_tpu_torch.core.config import ZooConfig  # noqa: F401
from analytics_zoo_tpu_torch.core.context import (  # noqa: F401
    ZooContext,
    get_zoo_context,
    init_zoo_context,
    resolve_device,
    set_zoo_context,
)
