"""Flash-attention forward: online-softmax attention over key tiles.

The plain PyTorch version (``flash_attention_reference``) writes the
(B, H, Lq, Lk) logits and probabilities to device memory; the CUDA kernel
(``csrc/flash_attention.cu``, the port of the JAX package's Pallas
``_fwd_kernel``) keeps them in registers and one shared tile, and reads
q, k and v once.  Both follow the TPU kernel's numerics: q scaled in f32
before the dot, f32 running max / normaliser / accumulator, the causal
mask aligned bottom-right by ``Lk - Lq``, masked logits -1e30 with their
probability forced to 0, and the normaliser clamped at 1e-20, so a query
row that sees no key (causal with Lq > Lk) comes out exactly 0.

Routing (``ops.dispatch.select_path("flash_attention")``): a CUDA tensor
launches the kernel, or raises for what it cannot take (a dtype other
than float32 / bfloat16, a head width D above 128); a CPU tensor takes
the plain version.  The kernel takes q, k, v as strided views with D
contiguous, so the heads split of ``MultiHeadAttention`` is not copied.

Gradients: on the card the launch sits in ``_FlashFwd``, whose backward
raises ``NotImplementedError`` — the backward kernels come with the
attention-training slice — rather than return an output that trains
nothing.  The plain version is differentiable by autograd.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from analytics_zoo_tpu_torch.ops import _build, dispatch

NEG_INF = -1e30
MAX_HEAD_DIM = 128
DTYPES = (torch.float32, torch.bfloat16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# one per launch of the CUDA kernel, nowhere else
LAUNCHES = dispatch.LaunchCount()

_SIGNATURES = {
    "zoo_flash_attention_fwd": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int] + [ctypes.c_int64] * 9 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
    "zoo_flash_attention_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def _check_args(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention takes q (B, H, Lq, D) and k, v "
                         f"(B, H, Lk, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch, heads or head width")


def _scale(q, sm_scale):
    return sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])


def flash_attention_reference(q, k, v, causal: bool = False,
                              sm_scale: Optional[float] = None):
    """Plain PyTorch version of the kernel's function, with its constants
    and rules; it materialises the (B, H, Lq, Lk) logits, which the kernel
    never does.  Computes in f32 (f64 for f64 inputs), returns q's
    dtype."""
    _check_args(q, k, v)
    acc = torch.promote_types(q.dtype, torch.float32)
    lq, lk = q.shape[2], k.shape[2]
    logits = torch.matmul(q.to(acc) * _scale(q, sm_scale),
                          k.to(acc).transpose(-1, -2))
    if causal:
        qpos = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
        kpos = torch.arange(lk, device=q.device)[None, :]
        logits = torch.where(qpos >= kpos, logits,
                             torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    p = torch.where(logits <= NEG_INF / 2, torch.zeros_like(p), p)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    return (torch.matmul(p, v.to(acc)) / l).to(q.dtype)


def _lib():
    return _build.library("flash_attention", _SIGNATURES)


def _launch(q, k, v, causal, scale):
    """Run the kernel on CUDA q (B, H, Lq, D) and k, v (B, H, Lk, D)."""
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention kernel needs q, k and v on one "
                         f"CUDA device, got {q.device}, {k.device} and "
                         f"{v.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel needs one dtype for q, k "
                        f"and v, got {q.dtype}, {k.dtype} and {v.dtype}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    b, h, lq, d = q.shape
    lk = k.shape[2]
    out = torch.empty((b, h, lq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().zoo_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[q.dtype], b, h, lq, lk, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(scale), int(bool(causal)), stream)
    if rc != 0:
        msg = _lib().zoo_flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention CUDA kernel launch failed "
                           f"({msg}) for q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, {q.dtype}")
    LAUNCHES.add()
    return out


class _FlashFwd(torch.autograd.Function):
    """The kernel's forward.  It saves nothing; its backward raises, so a
    loss through the kernel fails loudly instead of training nothing."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        return _launch(q, k, v, causal, scale)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "the flash-attention kernel has no backward yet: its backward "
            "kernels (dQ and dK/dV) arrive with the attention-training "
            "slice (ROADMAP B4/B5); train attention on the CPU or under "
            "ops.dispatch.forced('reference') until then")


def flash_attention(q, k, v, causal: bool = False,
                    sm_scale: Optional[float] = None):
    """Fused attention forward: q (B, H, Lq, D), k and v (B, H, Lk, D);
    ``sm_scale`` defaults to 1/sqrt(D); ``causal`` masks bottom-right
    aligned.  Returns (B, H, Lq, D) in q's dtype.  Takes no mask and no
    dropout (``ops.attention.dot_product_attention`` routes those)."""
    _check_args(q, k, v)
    d = q.shape[-1]
    path = dispatch.select_path(
        "flash_attention", device=q.device,
        shapes_ok=(q.dtype in DTYPES and 1 <= d <= MAX_HEAD_DIM
                   and k.shape[2] >= 1),
        shape=f"{q.dtype} q/k/v with head width D={d} and {k.shape[2]} "
              f"keys (it takes float32 or bfloat16, D <= {MAX_HEAD_DIM} "
              f"and at least one key)")
    scale = _scale(q, sm_scale)
    if path == dispatch.PATH_REFERENCE:
        return flash_attention_reference(q, k, v, causal, scale)
    return _FlashFwd.apply(q, k, v, causal, scale)
