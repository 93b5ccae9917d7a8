"""Loss functions (Keras-named), the JAX package's ``nn/objectives.py`` in
PyTorch: each is ``fn(y_true, y_pred) -> scalar`` reduced by the mean over
the batch, with the same clips (1e-7) and label handling.
"""

from __future__ import annotations

import math
from typing import Callable, Union

import torch
import torch.nn.functional as F

LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

_EPS = 1e-7


def _align(y_true, y_pred):
    """Match a (B,) target against a (B, 1) prediction (and vice versa) so
    elementwise losses never silently broadcast to (B, B)."""
    y_true = torch.as_tensor(y_true, device=y_pred.device)
    if (y_pred.ndim == y_true.ndim + 1 and y_pred.shape[-1] == 1
            and y_pred.shape[:-1] == y_true.shape):
        y_pred = y_pred[..., 0]
    elif (y_true.ndim == y_pred.ndim + 1 and y_true.shape[-1] == 1
            and y_true.shape[:-1] == y_pred.shape):
        y_true = y_true[..., 0]
    return y_true.to(y_pred.dtype), y_pred


def mean_squared_error(y_true, y_pred):
    y_true, y_pred = _align(y_true, y_pred)
    return torch.mean(torch.square(y_pred - y_true))


def mean_absolute_error(y_true, y_pred):
    y_true, y_pred = _align(y_true, y_pred)
    return torch.mean(torch.abs(y_pred - y_true))


def mean_absolute_percentage_error(y_true, y_pred):
    y_true, y_pred = _align(y_true, y_pred)
    diff = torch.abs((y_true - y_pred) / torch.clamp(torch.abs(y_true),
                                                     min=_EPS))
    return 100.0 * torch.mean(diff)


def mean_squared_logarithmic_error(y_true, y_pred):
    y_true, y_pred = _align(y_true, y_pred)
    a = torch.log(torch.clamp(y_pred, min=_EPS) + 1.0)
    b = torch.log(torch.clamp(y_true, min=_EPS) + 1.0)
    return torch.mean(torch.square(a - b))


def binary_crossentropy(y_true, y_pred):
    """y_pred are probabilities in (0, 1) (post-sigmoid), Keras semantics."""
    y_true, y_pred = _align(y_true, y_pred)
    p = torch.clamp(y_pred, _EPS, 1.0 - _EPS)
    return -torch.mean(y_true * torch.log(p)
                       + (1.0 - y_true) * torch.log1p(-p))


def binary_crossentropy_with_logits(y_true, logits):
    """Numerically stable BCE on logits."""
    y_true, logits = _align(y_true, logits)
    return torch.mean(torch.clamp(logits, min=0) - logits * y_true
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def categorical_crossentropy(y_true, y_pred):
    """One-hot targets vs probability outputs."""
    p = torch.clamp(y_pred, _EPS, 1.0)
    y_true = torch.as_tensor(y_true, device=y_pred.device).to(y_pred.dtype)
    return -torch.mean(torch.sum(y_true * torch.log(p), dim=-1))


def _sparse_labels(y_true, preds):
    """Integer labels matching preds' leading dims: supports (B,) vs
    (B, C), (B, 1) vs (B, C), and sequence targets (B, T) vs (B, T, C)."""
    labels = torch.as_tensor(y_true, device=preds.device).to(torch.int64)
    if labels.ndim == preds.ndim:          # trailing singleton
        labels = labels[..., 0]
    if labels.shape != preds.shape[:-1]:
        raise ValueError(
            f"label shape {tuple(labels.shape)} incompatible with "
            f"predictions {tuple(preds.shape)}")
    return labels


def sparse_categorical_crossentropy(y_true, y_pred, zero_based_label=True):
    """Integer targets vs PROBABILITY outputs (clipped to [1e-7, 1]);
    pair a logits head with ``sparse_categorical_crossentropy_with_logits``
    instead."""
    labels = _sparse_labels(y_true, y_pred)
    if not zero_based_label:
        labels = labels - 1
    p = torch.clamp(y_pred, _EPS, 1.0)
    ll = torch.gather(torch.log(p), -1, labels[..., None])
    return -torch.mean(ll)


def sparse_categorical_crossentropy_with_logits(y_true, logits):
    """Integer targets vs raw logits (fused log-softmax).  Sequence
    targets (B, T) vs (B, T, V) are averaged over all positions."""
    labels = _sparse_labels(y_true, logits)
    logp = F.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, -1, labels[..., None]))


def class_nll(y_true, log_probs):
    """NLL on log-probabilities."""
    labels = _sparse_labels(y_true, log_probs)
    return -torch.mean(torch.gather(log_probs, -1, labels[..., None]))


def kullback_leibler_divergence(y_true, y_pred):
    yt = torch.clamp(torch.as_tensor(y_true, device=y_pred.device)
                     .to(y_pred.dtype), _EPS, 1.0)
    yp = torch.clamp(y_pred, _EPS, 1.0)
    return torch.mean(torch.sum(yt * torch.log(yt / yp), dim=-1))


def poisson(y_true, y_pred):
    y_true, y_pred = _align(y_true, y_pred)
    return torch.mean(y_pred - y_true * torch.log(y_pred + _EPS))


def cosine_proximity(y_true, y_pred):
    y_true = torch.as_tensor(y_true, device=y_pred.device).to(y_pred.dtype)
    yt = y_true / (torch.linalg.norm(y_true, dim=-1, keepdim=True) + _EPS)
    yp = y_pred / (torch.linalg.norm(y_pred, dim=-1, keepdim=True) + _EPS)
    return -torch.mean(torch.sum(yt * yp, dim=-1))


def hinge(y_true, y_pred):
    y_true, y_pred = _align(y_true, y_pred)
    return torch.mean(torch.clamp(1.0 - y_true * y_pred, min=0.0))


def squared_hinge(y_true, y_pred):
    y_true, y_pred = _align(y_true, y_pred)
    return torch.mean(torch.square(torch.clamp(1.0 - y_true * y_pred,
                                               min=0.0)))


def _pairs(rows: torch.Tensor) -> tuple:
    """The (even, odd) rows of the complete pairs: an odd last row has no
    partner and is in neither."""
    n = 2 * (rows.shape[0] // 2)
    return rows[0:n:2], rows[1:n:2]


def _pair_mask(mask) -> torch.Tensor:
    """1 for each complete pair whose two rows are both real."""
    a, b = _pairs(torch.as_tensor(mask))
    return a * b


def rank_hinge(y_true, y_pred, margin: float = 1.0, mask=None):
    """Pairwise ranking hinge over (pos, neg) interleaved rows.

    ``mask`` is a per-row validity vector (B,): a pair counts only when
    both its rows are real, so the rows past the end of a short last
    batch are left out exactly, as in the JAX package.  An odd last row
    has no partner and never counts."""
    pos, neg = _pairs(y_pred)
    per_pair = torch.clamp(margin - pos + neg, min=0.0)
    if mask is None:
        return torch.mean(per_pair)
    pair_mask = _pair_mask(mask).to(per_pair.dtype).reshape(
        (-1,) + (1,) * (per_pair.ndim - 1))
    denom = torch.clamp(torch.sum(pair_mask), min=1.0) * math.prod(
        per_pair.shape[1:])
    return torch.sum(per_pair * pair_mask) / denom


# couples rows across the batch: shuffles keep (pos, neg) pairs together
rank_hinge.batch_structured = True
# takes mask=; its unit of aggregation is the pair
rank_hinge.supports_mask = True
rank_hinge.mask_count = lambda mask: torch.sum(_pair_mask(mask))


_REGISTRY = {
    "mse": mean_squared_error,
    "mean_squared_error": mean_squared_error,
    "mae": mean_absolute_error,
    "mean_absolute_error": mean_absolute_error,
    "mape": mean_absolute_percentage_error,
    "mean_absolute_percentage_error": mean_absolute_percentage_error,
    "msle": mean_squared_logarithmic_error,
    "mean_squared_logarithmic_error": mean_squared_logarithmic_error,
    "binary_crossentropy": binary_crossentropy,
    "bce": binary_crossentropy,
    "binary_crossentropy_with_logits": binary_crossentropy_with_logits,
    "categorical_crossentropy": categorical_crossentropy,
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "sparse_categorical_crossentropy_with_logits":
        sparse_categorical_crossentropy_with_logits,
    "class_nll": class_nll,
    "kld": kullback_leibler_divergence,
    "kullback_leibler_divergence": kullback_leibler_divergence,
    "poisson": poisson,
    "cosine_proximity": cosine_proximity,
    "hinge": hinge,
    "squared_hinge": squared_hinge,
    "rank_hinge": rank_hinge,
}


def get(loss: Union[str, LossFn]) -> LossFn:
    """String → loss lowering (Keras names)."""
    if callable(loss):
        return loss
    key = loss.lower()
    if key not in _REGISTRY:
        raise ValueError(f"unknown loss {loss!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[key]
