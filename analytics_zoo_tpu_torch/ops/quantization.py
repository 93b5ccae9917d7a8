"""Symmetric per-channel int8 weight quantization, and the feature
codec of the STREAM tier's compressed device cache.

``quantize_tensor`` is bit-identical to the JAX package's: the same f32
arithmetic, and ``torch.round`` rounds half to even as ``jnp.round``
does, so quantized trees interchange between the packages.
``quantize_feature_array`` is the JAX package's host encode, copied
(numpy), and ``dequantize_features`` its decode on the device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["quantize_tensor", "quantize_feature_array",
           "dequantize_features"]


def quantize_feature_array(a: np.ndarray, dtype: str = "uint8"
                           ) -> Tuple[np.ndarray, np.float32, np.float32]:
    """Host-side encode of a float feature array for the compressed
    device cache (``data/streaming.py``): ``(q, scale, zero)`` with
    ``a ≈ q * scale + zero``.  ``uint8`` is affine (min / max over the
    array), ``int8`` symmetric (abs-max, ``zero == 0``); the scales are
    scalars, so the decode is one multiply-add."""
    a = np.asarray(a)
    if not np.issubdtype(a.dtype, np.floating):
        raise TypeError(f"quantize_feature_array needs floats, got "
                        f"{a.dtype}")
    if dtype == "int8":
        amax = float(np.max(np.abs(a))) if a.size else 0.0
        scale = amax / 127.0 if amax > 0 else 1.0
        q = np.clip(np.round(a / scale), -127, 127).astype(np.int8)
        return q, np.float32(scale), np.float32(0.0)
    if dtype == "uint8":
        lo = float(a.min()) if a.size else 0.0
        hi = float(a.max()) if a.size else 0.0
        scale = (hi - lo) / 255.0 if hi > lo else 1.0
        q = np.clip(np.round((a - lo) / scale), 0, 255).astype(np.uint8)
        return q, np.float32(scale), np.float32(lo)
    raise ValueError(f"unknown feature cache dtype {dtype!r}; "
                     "known: uint8, int8")


def dequantize_features(q: torch.Tensor, scale, zero) -> torch.Tensor:
    """Decode gathered rows of a ``quantize_feature_array`` shard back to
    f32 (``scale`` and ``zero``: f32 scalars, tensors on ``q``'s device
    in a captured program)."""
    return q.to(torch.float32) * scale + zero


def quantize_tensor(w: torch.Tensor, axis: int = -1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel int8: returns (int8 weights, f32 scales)
    with ``scale`` shaped to broadcast along ``axis``."""
    w = torch.as_tensor(w)
    reduce_dims = tuple(i for i in range(w.ndim) if i != axis % w.ndim)
    amax = w.abs().amax(dim=reduce_dims, keepdim=True)
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / 127.0)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)
