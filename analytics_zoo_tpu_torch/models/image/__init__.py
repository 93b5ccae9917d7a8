from analytics_zoo_tpu_torch.models.image.imageclassification import (  # noqa: F401
    PREPROCESS_CONFIG,
    ImageClassifier,
    inception_v1,
    mobilenet,
    resnet50,
    vgg16,
)
