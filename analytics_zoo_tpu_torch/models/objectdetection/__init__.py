"""Object detection: SSD (``ObjectDetector``), its boxes, priors, NMS,
MultiBox loss, VOC mAP and drawing — the JAX package's
``models/objectdetection``."""

from analytics_zoo_tpu_torch.models.objectdetection.bbox import (  # noqa: F401
    decode_boxes,
    encode_boxes,
    generate_priors,
    iou_matrix,
    match_priors,
)
from analytics_zoo_tpu_torch.models.objectdetection.nms import (  # noqa: F401
    batched_class_nms,
    nms,
)
from analytics_zoo_tpu_torch.models.objectdetection.loss import (  # noqa: F401
    MultiBoxLoss,
    multibox_loss,
    smooth_l1,
)
from analytics_zoo_tpu_torch.models.objectdetection.ssd import (  # noqa: F401
    SSD300_CONFIG,
    ObjectDetector,
    SSDTargetAssigner,
    build_ssd,
)
from analytics_zoo_tpu_torch.models.objectdetection.evaluation import (  # noqa: F401
    MeanAveragePrecision,
    PascalVocEvaluator,
    average_precision,
)
from analytics_zoo_tpu_torch.models.objectdetection.visualizer import (  # noqa: F401
    draw_detections,
    save_detection_images,
)
