"""Non-maximum suppression with fixed shapes — the JAX package's
``models/objectdetection/nms.py``.

Greedy NMS runs a fixed ``max_output`` number of steps over a mask of
live boxes, with no host synchronisation and no shape that depends on
the data, so a whole post-processing step can be captured in a CUDA
graph.  The JAX function builds the (N, N) IoU matrix and vmaps over
classes; at SSD300's 8,732 priors that matrix is 305 MB per image and
class.  The port keeps the live masks of every image and class as one
(B, K, N) state and computes, at each step, only the IoU row of each
chosen box: the same arithmetic element by element, so the same
selections.  ``argmax`` takes the first of equal scores and the final
ranking is a stable sort, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch

from analytics_zoo_tpu_torch.models.objectdetection.bbox import _iou, as_tensor


def nms_steps(boxes: torch.Tensor, scores: torch.Tensor,
              iou_threshold: float, score_threshold: float,
              max_output: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS of K score vectors per image at once: boxes (B, N, 4),
    scores (B, K, N) -> (indices (B, K, max_output) int64, -1 padded;
    counts (B, K) int32)."""
    B, K, N = scores.shape
    alive = scores >= score_threshold
    out = torch.full((B, K, max_output), -1, dtype=torch.int64,
                     device=scores.device)
    count = torch.zeros((B, K), dtype=torch.int32, device=scores.device)
    ar = torch.arange(N, device=scores.device)
    # filled on the device: a host copy cannot be captured in a graph
    neg_inf = torch.full((), float("-inf"), device=scores.device)
    cols = boxes[:, None, :, :]                              # (B, 1, N, 4)
    for i in range(min(max_output, N)):
        masked = torch.where(alive, scores, neg_inf)
        best = masked.argmax(dim=-1)                         # (B, K)
        ok = masked.gather(-1, best[..., None])[..., 0] > neg_inf
        out[..., i] = torch.where(ok, best, torch.full_like(best, -1))
        count += ok.to(torch.int32)
        chosen = boxes.gather(1, best.reshape(B, K, 1).expand(B, K, 4))
        row = _iou(chosen[:, :, None, :], cols)              # (B, K, N)
        suppress = (row >= iou_threshold) | (ar == best[..., None])
        alive = alive & (~ok[..., None] | ~suppress)
    return out, count


def nms(boxes, scores, iou_threshold: float = 0.45,
        score_threshold: float = 0.01, max_output: int = 100,
        device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS. boxes (N, 4), scores (N,) -> (indices (max_output,)
    int32 with -1 padding, count ())."""
    boxes = as_tensor(boxes, device)
    scores = as_tensor(scores, boxes.device)
    out, count = nms_steps(boxes[None], scores[None, None], iou_threshold,
                           score_threshold, max_output)
    return out[0, 0].to(torch.int32), count[0, 0]


def class_nms_batch(boxes: torch.Tensor, class_scores: torch.Tensor,
                    iou_threshold: float = 0.45,
                    score_threshold: float = 0.01,
                    max_per_class: int = 50, max_total: int = 100):
    """``batched_class_nms`` over a batch: boxes (B, P, 4), class_scores
    (B, P, C) -> (boxes (B, D, 4), scores (B, D), labels (B, D) int32),
    D = min(max_total, (C - 1) * max_per_class)."""
    B, P, C = class_scores.shape
    fg = class_scores[..., 1:].transpose(1, 2)               # (B, C-1, P)
    idx, _ = nms_steps(boxes, fg, iou_threshold, score_threshold,
                       max_per_class)
    sel = idx.clamp(min=0)
    valid = idx >= 0
    n_fg = C - 1
    cls_boxes = boxes.gather(1, sel.reshape(B, -1, 1).expand(B, -1, 4))
    cls_scores = torch.where(valid, fg.gather(-1, sel),
                             torch.full((), float("-inf"),
                                        device=fg.device))
    labels = torch.arange(1, C, device=fg.device)[:, None].expand(
        n_fg, max_per_class).reshape(-1)
    flat_scores = cls_scores.reshape(B, -1)
    top = torch.argsort(-flat_scores, dim=-1, stable=True)[:, :max_total]
    out_scores = flat_scores.gather(1, top)
    keep = torch.isfinite(out_scores)
    out_boxes = cls_boxes.gather(1, top[..., None].expand(B, -1, 4))
    return (torch.where(keep[..., None], out_boxes,
                        torch.zeros_like(out_boxes)),
            torch.where(keep, out_scores, torch.zeros_like(out_scores)),
            torch.where(keep, labels[top], torch.zeros_like(top)).to(
                torch.int32))


def batched_class_nms(boxes, class_scores, iou_threshold: float = 0.45,
                      score_threshold: float = 0.01,
                      max_per_class: int = 50, max_total: int = 100,
                      device=None):
    """Per-class NMS over one image's decoded boxes: boxes (P, 4),
    class_scores (P, C) with class 0 the background -> (boxes
    (max_total, 4), scores (max_total,), labels (max_total,) int32, 0
    where padded)."""
    boxes = as_tensor(boxes, device)
    scores = as_tensor(class_scores, boxes.device)
    b, s, lab = class_nms_batch(boxes[None], scores[None], iou_threshold,
                                score_threshold, max_per_class, max_total)
    return b[0], s[0], lab[0]
