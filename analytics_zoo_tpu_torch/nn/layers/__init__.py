from analytics_zoo_tpu_torch.nn.layers.core import (  # noqa: F401
    Activation,
    Dense,
    Dropout,
    Flatten,
)
from analytics_zoo_tpu_torch.nn.layers.embedding import (  # noqa: F401
    Embedding,
    EmbeddingBag,
)
from analytics_zoo_tpu_torch.nn.layers.merge import Merge, merge  # noqa: F401
from analytics_zoo_tpu_torch.nn.layers.normalization import LayerNorm  # noqa: F401
from analytics_zoo_tpu_torch.nn.layers.pooling import (  # noqa: F401
    GlobalAveragePooling1D,
    GlobalMaxPooling1D,
)
from analytics_zoo_tpu_torch.nn.layers.attention import (  # noqa: F401
    BERT,
    MultiHeadAttention,
    TransformerBlock,
    TransformerLayer,
)
