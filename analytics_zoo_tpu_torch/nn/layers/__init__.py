from analytics_zoo_tpu_torch.nn.layers.core import (  # noqa: F401
    Activation,
    Dense,
    Dropout,
    Flatten,
    GaussianSampler,
    InputLayer,
    Lambda,
    Masking,
    MaxoutDense,
    Permute,
    RepeatVector,
    Reshape,
)
from analytics_zoo_tpu_torch.nn.layers.convolutional import (  # noqa: F401
    AtrousConvolution1D,
    AtrousConvolution2D,
    Convolution1D,
    Convolution2D,
    Convolution3D,
    SeparableConvolution2D,
    SpaceToDepthStemConv,
)
from analytics_zoo_tpu_torch.nn.layers.embedding import (  # noqa: F401
    Embedding,
    EmbeddingBag,
)
from analytics_zoo_tpu_torch.nn.layers.merge import Merge, merge  # noqa: F401
from analytics_zoo_tpu_torch.nn.layers.normalization import (  # noqa: F401
    BatchNormalization,
    LayerNorm,
)
from analytics_zoo_tpu_torch.nn.layers.pooling import (  # noqa: F401
    AveragePooling1D,
    AveragePooling2D,
    AveragePooling3D,
    GlobalAveragePooling1D,
    GlobalAveragePooling2D,
    GlobalAveragePooling3D,
    GlobalMaxPooling1D,
    GlobalMaxPooling2D,
    GlobalMaxPooling3D,
    MaxPooling1D,
    MaxPooling2D,
    MaxPooling3D,
)
from analytics_zoo_tpu_torch.nn.layers.attention import (  # noqa: F401
    BERT,
    MultiHeadAttention,
    TransformerBlock,
    TransformerLayer,
)
from analytics_zoo_tpu_torch.nn.layers.recurrent import (  # noqa: F401
    GRU,
    LSTM,
    Bidirectional,
    ConvLSTM2D,
    ConvLSTM3D,
    Highway,
    SimpleRNN,
    TimeDistributed,
)
