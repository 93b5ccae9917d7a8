"""Analytics Zoo on PyTorch and CUDA — the port of ``analytics_zoo_tpu``.

The package keeps the module layout and public names of the JAX package,
so every module here has one counterpart there:

- ``core``     — config, context (global config + device), host timers.
- ``observe``  — labelled metrics registry.
- ``robust``   — typed serving errors.
- ``ops``      — hand-written CUDA kernels (``csrc/``) with their plain
                 PyTorch versions and the dispatch that chooses between
                 them: the embedding-bag forward and the dequantize-matmul.
- ``nn``       — layers as ``torch.nn.Module``s, the ``Input``/``Model``
                 graph DSL.
- ``models``   — NeuralCF.
- ``deploy``   — ``InferenceModel`` (int8/int4 weights) and
                 ``DynamicBatcher``.
- ``convert``  — loads a JAX-package parameter tree into a port model.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no CUDA device they raise instead of falling back.
"""

__version__ = "0.1.0"

from analytics_zoo_tpu_torch.core.config import ZooConfig  # noqa: F401
from analytics_zoo_tpu_torch.core.context import (  # noqa: F401
    ZooContext,
    get_zoo_context,
    init_zoo_context,
    resolve_device,
)
