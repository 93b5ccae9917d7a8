from analytics_zoo_tpu_torch.nn.module import (  # noqa: F401
    Layer,
    StatelessLayer,
    reset_name_scope,
)
from analytics_zoo_tpu_torch.nn.topology import KerasNet, Model, Sequential  # noqa: F401
from analytics_zoo_tpu_torch.nn.net import GraphNet  # noqa: F401
from analytics_zoo_tpu_torch.nn.autograd import Input, Parameter, Variable  # noqa: F401
from analytics_zoo_tpu_torch.nn import (  # noqa: F401
    activations,
    autograd,
    initializers,
    metrics,
    objectives,
    regularizers,
)
from analytics_zoo_tpu_torch.nn.layers import *  # noqa: F401,F403
