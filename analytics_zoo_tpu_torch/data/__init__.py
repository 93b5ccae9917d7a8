"""Host datasets: ``FeatureSet`` with its memory tiers and HOST / DEVICE /
STREAM cache levels (``SlicedFeatureSet`` for slices on disk, the STREAM
tier in ``streaming``), the MovieLens, VOC / COCO and text-corpus
readers, the image pipeline (``ImageSet``) and the text pipeline
(``TextSet``); the host preprocessing combinators, TFRecord IO
(``tfrecord``), ``SyntheticGiantTable`` and the 3-D volume transforms
(``image3d``)."""

from analytics_zoo_tpu_torch.data.datasets import (  # noqa: F401
    VOC_CLASSES,
    generate_movielens_like,
    generate_text_classification,
    movielens_featureset,
    read_coco,
    read_movielens_1m,
    read_pascal_voc,
    read_text_folder,
)
from analytics_zoo_tpu_torch.data.featureset import (  # noqa: F401
    CacheLevel,
    FeatureSet,
    SlicedFeatureSet,
    npy_header,
)
from analytics_zoo_tpu_torch.data.giant_table import (  # noqa: F401
    SyntheticGiantTable,
)
from analytics_zoo_tpu_torch.data.image import (  # noqa: F401
    ImageFeature,
    ImagePreprocessing,
    ImageSet,
)
from analytics_zoo_tpu_torch.data.preprocessing import (  # noqa: F401
    ChainedPreprocessing,
    FeatureLabelPreprocessing,
    Preprocessing,
    SeqToTensor,
)
from analytics_zoo_tpu_torch.data.zipf import (  # noqa: F401
    zipf_weights,
    zipfian_ids,
)
from analytics_zoo_tpu_torch.data.text import (  # noqa: F401
    TextFeature,
    TextSet,
    load_glove_embeddings,
)
