"""MultiBox loss: smooth-L1 localisation plus softmax confidence with
hard negative mining — the JAX package's
``models/objectdetection/loss.py``.

Mining is the JAX rank trick with fixed shapes: a negative is kept when
its rank among the negatives by confidence loss is below ``neg_pos_ratio``
times the image's positives.  The ranks come from a stable ``argsort``
of the negated losses, as the JAX package's stable sort orders ties, and
its inverse (a scatter of positions).
"""

from __future__ import annotations

import torch


def smooth_l1(x):
    ax = torch.abs(x)
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def multibox_loss(loc_preds, cls_logits, loc_targets, cls_targets,
                  neg_pos_ratio: float = 3.0, loc_weight: float = 1.0):
    """SSD's training loss: loc_preds (B, P, 4), cls_logits (B, P, C),
    loc_targets (B, P, 4), cls_targets (B, P) int (0: background)."""
    cls_targets = cls_targets.to(torch.int64)
    pos = cls_targets > 0                                    # (B, P)
    num_pos = pos.sum(dim=1)                                 # (B,)
    loc_l = smooth_l1(loc_preds - loc_targets).sum(dim=-1)
    loc_loss = (loc_l * pos).sum(dim=1)
    logp = torch.log_softmax(cls_logits, dim=-1)
    ce = -logp.gather(-1, cls_targets[..., None])[..., 0]    # (B, P)
    neg_ce = torch.where(pos, torch.full_like(ce, float("-inf")), ce)
    order = torch.argsort(-neg_ce.detach(), dim=1, stable=True)
    ranks = torch.empty_like(order).scatter_(
        1, order, torch.arange(order.shape[1], device=order.device)
        .expand_as(order))
    num_neg = torch.minimum(neg_pos_ratio * num_pos.to(torch.float32),
                            (~pos).sum(dim=1).to(torch.float32)).to(
                                torch.int64)
    neg_keep = ranks < num_neg[:, None]
    conf_loss = (ce * (pos | (neg_keep & ~pos))).sum(dim=1)
    denom = num_pos.to(torch.float32).clamp(min=1.0)
    return torch.mean((loc_weight * loc_loss + conf_loss) / denom)


class MultiBoxLoss:
    """The loss object: ``(y_true, y_pred)`` with y_true (B, P, 5) [loc
    targets | class target], already matched to the priors by
    ``SSDTargetAssigner``, and y_pred (loc (B, P, 4), logits (B, P,
    C)).  ``batch_structured``: it couples rows, so evaluation runs it on
    whole batches."""

    def __init__(self, neg_pos_ratio: float = 3.0, loc_weight: float = 1.0):
        self.neg_pos_ratio = neg_pos_ratio
        self.loc_weight = loc_weight
        self.batch_structured = True

    def __call__(self, y_true, y_pred):
        loc_preds, cls_logits = y_pred
        return multibox_loss(loc_preds, cls_logits, y_true[..., :4],
                             y_true[..., 4].to(torch.int64),
                             self.neg_pos_ratio, self.loc_weight)
