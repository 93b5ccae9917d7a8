"""Detection visualization, the JAX package's
``models/objectdetection/visualizer.py``: draw detected boxes and
class / score captions onto images and save them.  Drawing and writing
files are OpenCV's (``cv2``), imported where they run; without it they
raise ``data.image.Cv2Unavailable``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from analytics_zoo_tpu_torch.data.image import require_cv2

# deterministic class palette (BGR) — stable across runs for diffable
# output images
_PALETTE = [(66, 133, 244), (52, 168, 83), (251, 188, 5), (234, 67, 53),
            (154, 160, 166), (255, 112, 67), (0, 172, 193), (171, 71, 188)]


def draw_detections(image: np.ndarray, boxes: np.ndarray,
                    scores: np.ndarray, labels: np.ndarray,
                    class_names: Optional[Sequence[str]] = None,
                    normalized: bool = True,
                    thickness: int = 2) -> np.ndarray:
    """Return a copy of ``image`` (H, W, 3 uint8 or float in [0,1]) with
    one rectangle + ``class score`` caption per detection."""
    cv2 = require_cv2("draw_detections")

    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    img = np.ascontiguousarray(img.copy())
    h, w = img.shape[:2]
    for box, score, label in zip(np.asarray(boxes), np.asarray(scores),
                                 np.asarray(labels)):
        x1, y1, x2, y2 = box
        if normalized:
            x1, x2 = x1 * w, x2 * w
            y1, y2 = y1 * h, y2 * h
        p1 = (int(round(x1)), int(round(y1)))
        p2 = (int(round(x2)), int(round(y2)))
        color = _PALETTE[int(label) % len(_PALETTE)]
        cv2.rectangle(img, p1, p2, color, thickness)
        name = (class_names[int(label)] if class_names
                and int(label) < len(class_names) else str(int(label)))
        caption = f"{name} {float(score):.2f}"
        cv2.putText(img, caption, (p1[0], max(12, p1[1] - 4)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.4, color, 1)
    return img


def save_detection_images(out_dir: str, images, detections,
                          class_names: Optional[Sequence[str]] = None,
                          prefix: str = "detection",
                          normalized: bool = True) -> list:
    """Draw + write one annotated file per image
    (``{prefix}_{i}.jpg``); returns the written paths."""
    cv2 = require_cv2("save_detection_images")

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, (img, (boxes, scores, labels)) in enumerate(
            zip(images, detections)):
        drawn = draw_detections(img, boxes, scores, labels,
                                class_names=class_names,
                                normalized=normalized)
        path = os.path.join(out_dir, f"{prefix}_{i}.jpg")
        cv2.imwrite(path, drawn)
        paths.append(path)
    return paths
