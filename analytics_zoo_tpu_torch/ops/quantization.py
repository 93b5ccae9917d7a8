"""Symmetric per-channel int8 weight quantization.

Bit-identical to the JAX package's ``ops/quantization.quantize_tensor``:
the same f32 arithmetic, and ``torch.round`` rounds half to even as
``jnp.round`` does, so quantized trees interchange between the packages.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["quantize_tensor"]


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
