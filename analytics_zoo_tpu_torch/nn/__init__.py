from analytics_zoo_tpu_torch.nn.module import Layer, reset_name_scope  # noqa: F401
from analytics_zoo_tpu_torch.nn.topology import KerasNet, Model, Sequential  # noqa: F401
from analytics_zoo_tpu_torch.nn.autograd import Input, Variable  # noqa: F401
from analytics_zoo_tpu_torch.nn import activations, initializers  # noqa: F401
from analytics_zoo_tpu_torch.nn.layers import *  # noqa: F401,F403
