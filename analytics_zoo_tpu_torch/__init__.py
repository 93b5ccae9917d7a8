"""Analytics Zoo on PyTorch and CUDA — the port of ``analytics_zoo_tpu``.

The package keeps the module layout and public names of the JAX package,
so every module here has one counterpart there:

- ``core``     — config, context (global config + device), host timers,
                 training triggers.
- ``observe``  — labelled metrics registry.
- ``robust``   — typed serving errors.
- ``ops``      — hand-written CUDA kernels (``csrc/``) with their plain
                 PyTorch versions and the dispatch that chooses between
                 them: the embedding-bag forward and backward, the
                 dequantize-matmul and the flash-attention forward; the
                 attention ops around the last.
- ``nn``       — layers as ``torch.nn.Module``s (the attention layers and
                 BERT among them), the ``Input``/``Model`` graph DSL with
                 its compile/fit facade, losses, metrics, regularizers.
- ``train``    — the ``Estimator`` and optax-equivalent optimizers.
- ``data``     — ``FeatureSet`` (HOST / DEVICE cache levels), MovieLens.
- ``models``   — NeuralCF and the implicit-feedback samplers.
- ``tfpark``   — BERTClassifier, BERTNER and BERTSQuAD.
- ``deploy``   — ``InferenceModel`` (int8/int4 weights) and
                 ``DynamicBatcher``.
- ``convert``  — a JAX-package parameter tree into a port model and back.

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
