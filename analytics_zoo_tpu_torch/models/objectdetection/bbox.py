"""Bounding-box utilities: IoU, prior (anchor) generation, encode and
decode, and SSD's prior matching — the JAX package's
``models/objectdetection/bbox.py``.

Boxes are (x1, y1, x2, y2), normalised to [0, 1].  The functions take
tensors and compute where they lie; arrays (numpy, lists) go to
``device`` (default ``cuda``: pass ``device="cpu"`` for the CPU).
``generate_priors`` stays numpy, as in the JAX package.

``match_priors`` forces each real gt's best prior to match it.  The JAX
function writes those matches with a scatter that repeats indices (two
gts sharing a best prior; every padding row aiming at prior 0, the
argmax of its zeroed column), where the last write in gt order wins;
a padding row writes back the value read before the scatter.  The port
makes that rule explicit and deterministic on any device: for each
prior the largest gt index that targets it (a ``scatter_reduce``
``amax``) picks the value it takes.
"""

from __future__ import annotations

import itertools
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.core.context import resolve_device


def as_tensor(x, device=None, dtype=torch.float32) -> torch.Tensor:
    """``x`` as a tensor of ``dtype``: a tensor stays on its device, an
    array goes to ``device`` (default ``cuda``)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype,
                           device=resolve_device(device))


def _iou(a, b):
    """IoU of every pair along the last-but-one dims of broadcastable
    ``a`` (..., N, 1, 4) and ``b`` (..., 1, M, 4): the JAX function's
    arithmetic, element by element."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]).clamp(min=0) * \
        (a[..., 3] - a[..., 1]).clamp(min=0)
    area_b = (b[..., 2] - b[..., 0]).clamp(min=0) * \
        (b[..., 3] - b[..., 1]).clamp(min=0)
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def iou_matrix(a, b, device=None):
    """Pairwise IoU. a (N, 4), b (M, 4) -> (N, M)."""
    a = as_tensor(a, device)
    b = as_tensor(b, a.device)
    return _iou(a[:, None, :], b[None, :, :])


def _corner_to_center(boxes):
    cx = (boxes[..., 0] + boxes[..., 2]) / 2.0
    cy = (boxes[..., 1] + boxes[..., 3]) / 2.0
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return cx, cy, w, h


def encode_boxes(matched, priors, variances=(0.1, 0.2), device=None):
    """gt corner boxes -> loc regression targets relative to the priors
    (SSD's variances)."""
    matched = as_tensor(matched, device)
    priors = as_tensor(priors, matched.device)
    gcx, gcy, gw, gh = _corner_to_center(matched)
    pcx, pcy, pw, ph = _corner_to_center(priors)
    eps = 1e-8
    dx = (gcx - pcx) / pw.clamp(min=eps) / variances[0]
    dy = (gcy - pcy) / ph.clamp(min=eps) / variances[0]
    dw = torch.log(gw.clamp(min=eps) / pw.clamp(min=eps)) / variances[1]
    dh = torch.log(gh.clamp(min=eps) / ph.clamp(min=eps)) / variances[1]
    return torch.stack([dx, dy, dw, dh], dim=-1)


def decode_boxes(loc, priors, variances=(0.1, 0.2), device=None):
    """loc predictions -> corner boxes (the inverse of
    ``encode_boxes``)."""
    loc = as_tensor(loc, device)
    priors = as_tensor(priors, loc.device)
    pcx, pcy, pw, ph = _corner_to_center(priors)
    cx = loc[..., 0] * variances[0] * pw + pcx
    cy = loc[..., 1] * variances[0] * ph + pcy
    w = pw * torch.exp(loc[..., 2] * variances[1])
    h = ph * torch.exp(loc[..., 3] * variances[1])
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def match_priors_batch(gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                       priors: torch.Tensor, iou_threshold: float = 0.5,
                       variances=(0.1, 0.2)):
    """``match_priors`` over a batch: gt_boxes (B, G, 4), gt_labels (B,
    G), priors (P, 4), all on one device -> (loc targets (B, P, 4), class
    targets (B, P) int32)."""
    B, G = gt_labels.shape
    valid = gt_labels > 0
    iou = _iou(priors[None, :, None, :], gt_boxes[:, None, :, :]) \
        * valid[:, None, :].to(torch.float32)                  # (B, P, G)
    best_iou, best_gt = iou.max(dim=2)                          # (B, P)
    best_prior = iou.argmax(dim=1)                              # (B, G)
    g_idx = torch.arange(G, device=gt_labels.device).expand(B, G)
    # the values the JAX scatter writes for each gt
    val_gt = torch.where(valid, g_idx, best_gt.gather(1, best_prior))
    val_iou = torch.where(valid, torch.full_like(best_iou[:, :1], 2.0),
                          best_iou.gather(1, best_prior))
    # the last write in gt order wins: for each prior, the largest gt
    # index aiming at it
    last = torch.full_like(best_gt, -1).scatter_reduce(
        1, best_prior, g_idx, reduce="amax", include_self=True)
    hit = last >= 0
    src = last.clamp(min=0)
    best_gt = torch.where(hit, val_gt.gather(1, src), best_gt)
    best_iou = torch.where(hit, val_iou.gather(1, src), best_iou)
    matched = gt_boxes.gather(1, best_gt[..., None].expand(B, -1, 4))
    labels = gt_labels.gather(1, best_gt)
    cls = torch.where(best_iou >= iou_threshold, labels,
                      torch.zeros_like(labels))
    loc = encode_boxes(matched, priors, variances)
    return loc, cls.to(torch.int32)


def match_priors(gt_boxes, gt_labels, priors, iou_threshold: float = 0.5,
                 variances=(0.1, 0.2), device=None):
    """Assign each prior a gt box and label (0: background), SSD's
    matching step: each real gt's best prior is forced to match it, then
    any prior with IoU >= ``iou_threshold``.  gt rows with label 0 are
    padding and never matched.  Returns (loc targets (P, 4), class
    targets (P,) int32)."""
    boxes = as_tensor(gt_boxes, device)
    labels = as_tensor(gt_labels, boxes.device, torch.int64)
    priors = as_tensor(priors, boxes.device)
    loc, cls = match_priors_batch(boxes[None], labels[None], priors,
                                  iou_threshold, variances)
    return loc[0], cls[0]


def generate_priors(feature_sizes: Sequence[int], image_size: int,
                    min_sizes: Sequence[float], max_sizes: Sequence[float],
                    aspect_ratios: Sequence[Sequence[float]],
                    clip: bool = True) -> np.ndarray:
    """SSD prior boxes for a pyramid of feature maps (Liu et al. 2016,
    section 2.2): per cell a square ``min_size`` anchor, a
    ``sqrt(min * max)`` one, and two per aspect ratio, in (row, column,
    anchor) order.  Returns (P, 4) corner boxes, normalised."""
    priors: List[Tuple[float, float, float, float]] = []
    for k, fsize in enumerate(feature_sizes):
        step = image_size / fsize
        s_min = min_sizes[k] / image_size
        s_max = max_sizes[k] / image_size
        for i, j in itertools.product(range(fsize), repeat=2):
            cx = (j + 0.5) * step / image_size
            cy = (i + 0.5) * step / image_size
            sizes = [(s_min, s_min), (math.sqrt(s_min * s_max),) * 2]
            for ar in aspect_ratios[k]:
                r = math.sqrt(ar)
                sizes.append((s_min * r, s_min / r))
                sizes.append((s_min / r, s_min * r))
            for w, h in sizes:
                priors.append((cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2))
    out = np.asarray(priors, np.float32)
    if clip:
        out = np.clip(out, 0.0, 1.0)
    return out
