"""Flash attention: online-softmax attention over key tiles, forward and
backward.

The plain PyTorch versions (``flash_attention_reference``,
``flash_attention_lse_reference``, ``flash_attention_bwd_reference``)
write the (B, H, Lq, Lk) logits and probabilities to device memory; the
CUDA kernels keep them in registers and shared tiles:

- ``csrc/flash_attention.cu::flash_fwd``, the port of the JAX package's
  Pallas ``_fwd_kernel`` (no lse) and ``_fwd_lse_kernel`` (its LSE
  instance: the per-row logsumexp as well, the backward's residual);
- ``csrc/flash_attention_bwd.cu::flash_bwd_dq`` and ``flash_bwd_dkv``,
  the ports of ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` (the
  FlashAttention-2 backward: probabilities recomputed from q, k and lse).
  ``delta = rowsum(dO * O)`` stays a PyTorch op, as the JAX package
  leaves it to XLA.

All follow the TPU kernels' numerics: q scaled in f32 before the dot,
f32 running max / normaliser / accumulators, the causal mask aligned
bottom-right by ``Lk - Lq``, masked logits -1e30 with their probability
forced to 0, and the normaliser clamped at 1e-20, so a query row that
sees no key (causal with Lq > Lk) comes out exactly 0, with lse -1e30 and
a zero gradient.

Routing (``ops.dispatch.select_path``, ``"flash_attention"`` for the
forward and ``"flash_attention_bwd"`` for the backward): a CUDA tensor
launches the kernels, or raises for what they cannot take (a dtype other
than float32 / bfloat16, a head width D above 128); a CPU tensor takes
the plain versions.  The kernels take q, k, v (and dO) as strided views
with D contiguous, so the heads split of ``MultiHeadAttention`` is not
copied.

Gradients: ``flash_attention`` is one ``torch.autograd.Function``
(``_Flash``) on every device.  When a gradient is wanted its forward is
the lse kernel and it saves (q, k, v, out, lse); otherwise (serving,
``evaluate``, ``torch.no_grad``) it is the plain forward kernel and
saves nothing.  Its backward is ``flash_attention_bwd``: the dQ and
dK/dV kernels, or their plain version on the CPU.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from analytics_zoo_tpu_torch.ops import _build, dispatch

NEG_INF = -1e30
MAX_HEAD_DIM = 128
DTYPES = (torch.float32, torch.bfloat16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# one per launch of each CUDA kernel, nowhere else
LAUNCHES = dispatch.LaunchCount("flash_attention")             # kernel 4
LSE_LAUNCHES = dispatch.LaunchCount("flash_attention_lse")     # kernel 5
BWD_DQ_LAUNCHES = dispatch.LaunchCount("flash_attention_bwd_dq")    # kernel 6
BWD_DKV_LAUNCHES = dispatch.LaunchCount("flash_attention_bwd_dkv")  # kernel 7

_FWD_ARGS = [ctypes.c_int] * 6 + [ctypes.c_int64] * 9 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_SIGNATURES = {
    "zoo_flash_attention_fwd": (ctypes.c_int, [ctypes.c_void_p] * 4
                                + _FWD_ARGS),
    "zoo_flash_attention_fwd_lse": (ctypes.c_int, [ctypes.c_void_p] * 5
                                    + _FWD_ARGS),
    "zoo_flash_attention_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}
_BWD_TAIL = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int64),
                                  ctypes.c_float, ctypes.c_int,
                                  ctypes.c_void_p]
_BWD_SIGNATURES = {
    "zoo_flash_attention_bwd_dq": (ctypes.c_int, [ctypes.c_void_p] * 7
                                   + _BWD_TAIL),
    "zoo_flash_attention_bwd_dkv": (ctypes.c_int, [ctypes.c_void_p] * 8
                                    + _BWD_TAIL),
    "zoo_flash_attention_bwd_error_string": (ctypes.c_char_p,
                                             [ctypes.c_int]),
}


def _check_args(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention takes q (B, H, Lq, D) and k, v "
                         f"(B, H, Lk, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch, heads or head width")


def _check_bwd_args(q, k, v, out, lse, g):
    _check_args(q, k, v)
    if out.shape != q.shape or g.shape != q.shape:
        raise ValueError(f"flash_attention_bwd takes out and g shaped as q "
                         f"{tuple(q.shape)}, got {tuple(out.shape)} and "
                         f"{tuple(g.shape)}")
    if lse.shape != q.shape[:3]:
        raise ValueError(f"flash_attention_bwd takes lse (B, H, Lq) = "
                         f"{tuple(q.shape[:3])}, got {tuple(lse.shape)}")


def _scale(q, sm_scale):
    return sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])


def _kernel_shapes_ok(q, k):
    return q.dtype in DTYPES and 1 <= q.shape[-1] <= MAX_HEAD_DIM \
        and k.shape[2] >= 1


def _shape_text(q, k):
    return (f"{q.dtype} q/k/v with head width D={q.shape[-1]} and "
            f"{k.shape[2]} keys (it takes float32 or bfloat16, "
            f"D <= {MAX_HEAD_DIM} and at least one key)")


def _logits(q, k, causal, scale):
    """The masked (B, H, Lq, Lk) logits in the accumulation type (f32,
    f64 for f64 inputs), q scaled before the dot as the kernels do."""
    acc = torch.promote_types(q.dtype, torch.float32)
    lq, lk = q.shape[2], k.shape[2]
    logits = torch.matmul(q.to(acc) * scale, k.to(acc).transpose(-1, -2))
    if causal:
        qpos = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
        kpos = torch.arange(lk, device=q.device)[None, :]
        logits = torch.where(qpos >= kpos, logits,
                             torch.full_like(logits, NEG_INF))
    return logits


def _masked_exp(logits, shift):
    """exp(logits - shift), exactly 0 where a logit is masked."""
    p = torch.exp(logits - shift)
    return torch.where(logits <= NEG_INF / 2, torch.zeros_like(p), p)


def flash_attention_lse_reference(q, k, v, causal: bool = False,
                                  sm_scale: Optional[float] = None):
    """Plain PyTorch version of the lse kernel's function: ``(out, lse)``,
    out in q's dtype and lse (B, H, Lq) in the accumulation type (f32,
    f64 for f64 inputs), ``m + log(max(l, 1e-20))`` per row.  It
    materialises the logits, which the kernel never does."""
    _check_args(q, k, v)
    logits = _logits(q, k, causal, _scale(q, sm_scale))
    m = logits.amax(dim=-1, keepdim=True)
    p = _masked_exp(logits, m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    out = (torch.matmul(p, v.to(logits.dtype)) / l).to(q.dtype)
    return out, (m + torch.log(l)).squeeze(-1)


def flash_attention_reference(q, k, v, causal: bool = False,
                              sm_scale: Optional[float] = None):
    """Plain PyTorch version of the forward kernel's function, with its
    constants and rules.  Computes in f32 (f64 for f64 inputs), returns
    q's dtype."""
    return flash_attention_lse_reference(q, k, v, causal, sm_scale)[0]


def flash_attention_bwd_reference(q, k, v, out, lse, g, causal: bool = False,
                                  sm_scale: Optional[float] = None):
    """Plain PyTorch version of the backward kernels' function:
    ``(dq, dk, dv)`` in the dtypes of q, k and v, from the forward's
    ``out`` and ``lse`` and the output gradient ``g``.  The probabilities
    are recomputed from lse with the TPU kernels' constants, as
    ``_recompute_p`` does there."""
    _check_bwd_args(q, k, v, out, lse, g)
    scale = _scale(q, sm_scale)
    logits = _logits(q, k, causal, scale)
    acc = logits.dtype
    p = _masked_exp(logits, lse.to(acc)[..., None])
    gf = g.to(acc)
    delta = (gf * out.to(acc)).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(gf, v.to(acc).transpose(-1, -2)) - delta)
    dq = scale * torch.matmul(ds, k.to(acc))
    dk = scale * torch.matmul(ds.transpose(-1, -2), q.to(acc))
    dv = torch.matmul(p.transpose(-1, -2), gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _lib():
    return _build.library("flash_attention", _SIGNATURES)


def _bwd_lib():
    return _build.library("flash_attention_bwd", _BWD_SIGNATURES)


def _on_card(name, *ts):
    """``ts`` with D made contiguous where it is not (a view that the
    kernels cannot walk), after checking they share one CUDA device and
    one dtype."""
    dev, dtype = ts[0].device, ts[0].dtype
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"{name} kernel needs its tensors on one CUDA "
                         f"device, got {[str(t.device) for t in ts]}")
    if any(t.dtype != dtype for t in ts):
        raise TypeError(f"{name} kernel needs one dtype for its tensors, "
                        f"got {[str(t.dtype) for t in ts]}")
    return [t if t.stride(-1) == 1 else t.contiguous() for t in ts]


def _raise_failed(name, rc, lib_error, q, k):
    msg = lib_error(rc).decode()
    raise RuntimeError(f"{name} CUDA kernel launch failed ({msg}) for q "
                       f"{tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype}")


def _launch(q, k, v, causal, scale, with_lse=False):
    """Run the forward kernel on CUDA q (B, H, Lq, D) and k, v (B, H, Lk,
    D): ``out``, or ``(out, lse)`` with ``with_lse`` (the lse instance)."""
    q, k, v = _on_card("flash_attention", q, k, v)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    out = torch.empty((b, h, lq, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return (out, lse) if with_lse else out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (_DTYPE_CODE[q.dtype], b, h, lq, lk, d,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                float(scale), int(bool(causal)), stream)
        if with_lse:
            rc = _lib().zoo_flash_attention_fwd_lse(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), *args)
        else:
            rc = _lib().zoo_flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                *args)
    if rc != 0:
        _raise_failed("flash_attention", rc,
                      _lib().zoo_flash_attention_error_string, q, k)
    if with_lse:
        LSE_LAUNCHES.add()
        return out, lse
    LAUNCHES.add()
    return out


def bwd_operands(q, k, v, out, lse, g):
    """The backward kernels' operands from CUDA tensors: (q, k, v, g)
    walkable by the kernels, lse as contiguous f32, and delta =
    rowsum(g * out), one PyTorch product and row sum (the JAX package
    leaves it to XLA)."""
    q, k, v, g = _on_card("flash_attention_bwd", q, k, v, g)
    lse = lse.to(device=q.device, dtype=torch.float32).contiguous()
    delta = (g.float() * out.float()).sum(dim=-1).contiguous()
    return q, k, v, g, lse, delta


def _bwd_call(fn, outs, q, k, v, g, lse, delta, causal, scale):
    lib = _bwd_lib()
    b, h, lq, d = q.shape
    strides = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3],
                                    *v.stride()[:3], *g.stride()[:3])
    with torch.cuda.device(q.device):
        rc = getattr(lib, fn)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(o.data_ptr() for o in outs),
            _DTYPE_CODE[q.dtype], b, h, lq, k.shape[2], d, strides,
            float(scale), int(bool(causal)),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        _raise_failed(fn, rc, lib.zoo_flash_attention_bwd_error_string, q, k)


def launch_bwd_dq(q, k, v, g, lse, delta, causal, scale):
    """The dQ kernel on ``bwd_operands``: dq (B, H, Lq, D) in q's
    dtype."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _bwd_call("zoo_flash_attention_bwd_dq", (dq,), q, k, v, g, lse, delta,
              causal, scale)
    BWD_DQ_LAUNCHES.add()
    return dq


def launch_bwd_dkv(q, k, v, g, lse, delta, causal, scale):
    """The dK/dV kernel on ``bwd_operands``: dk, dv (B, H, Lk, D) in k's
    dtype."""
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    _bwd_call("zoo_flash_attention_bwd_dkv", (dk, dv), q, k, v, g, lse,
              delta, causal, scale)
    BWD_DKV_LAUNCHES.add()
    return dk, dv


def _launch_bwd(q, k, v, out, lse, g, causal, scale):
    """Run the dQ and the dK/dV kernels on CUDA tensors."""
    if q.numel() == 0 or k.numel() == 0:
        _on_card("flash_attention_bwd", q, k, v, g)
        return (torch.zeros(q.shape, dtype=q.dtype, device=q.device),
                torch.zeros(k.shape, dtype=k.dtype, device=k.device),
                torch.zeros(v.shape, dtype=v.dtype, device=v.device))
    ops = bwd_operands(q, k, v, out, lse, g)
    dq = launch_bwd_dq(*ops, causal, scale)
    return (dq, *launch_bwd_dkv(*ops, causal, scale))


def flash_attention_bwd(q, k, v, out, lse, g, causal: bool = False,
                        sm_scale: Optional[float] = None):
    """Gradients ``(dq, dk, dv)`` of ``flash_attention`` from its inputs,
    its output ``out``, the per-row logsumexp ``lse`` (B, H, Lq) and the
    output gradient ``g`` — the JAX package's ``_flash_bwd``.  ``out`` and
    ``lse`` are the caller's, so a caller that merges partial attentions
    (ring attention) passes the global ones.  A CUDA tensor launches the
    dQ and dK/dV kernels, or raises; a CPU tensor takes the plain
    version."""
    _check_bwd_args(q, k, v, out, lse, g)
    path = dispatch.select_path(
        "flash_attention_bwd", device=q.device,
        shapes_ok=_kernel_shapes_ok(q, k), shape=_shape_text(q, k))
    scale = _scale(q, sm_scale)
    if path == dispatch.PATH_REFERENCE:
        return flash_attention_bwd_reference(q, k, v, out, lse, g, causal,
                                             scale)
    return _launch_bwd(q, k, v, out, lse, g, causal, scale)


def flash_attention_lse(q, k, v, causal: bool = False,
                        sm_scale: Optional[float] = None):
    """The forward with the per-row logsumexp, as the JAX package's
    ``_flash_fwd(..., with_lse=True)``: ``(out, lse)``, lse (B, H, Lq) f32
    (the accumulation type on the CPU).  A CUDA tensor launches the lse
    kernel, or raises; a CPU tensor takes the plain version.  Not
    differentiable: it is the residual maker of ``flash_attention``'s
    backward and of ring attention's per-hop forward."""
    path = _select(q, k, v)
    with torch.no_grad():
        return _forward(q, k, v, causal, _scale(q, sm_scale), path, True)


def _select(q, k, v):
    """The forward's route, after the shape checks."""
    _check_args(q, k, v)
    return dispatch.select_path(
        "flash_attention", device=q.device,
        shapes_ok=_kernel_shapes_ok(q, k), shape=_shape_text(q, k))


def _forward(q, k, v, causal, scale, path, with_lse):
    if path == dispatch.PATH_REFERENCE:
        return (flash_attention_lse_reference(q, k, v, causal, scale)
                if with_lse else
                flash_attention_reference(q, k, v, causal, scale))
    return _launch(q, k, v, causal, scale, with_lse=with_lse)


class _Flash(torch.autograd.Function):
    """Flash attention with its kernel backward.  ``path`` is the
    forward's routing decision; ``save`` is False when no gradient is
    wanted, and then the forward is the kernel without lse and keeps
    nothing."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, path, save):
        if not save:
            return _forward(q, k, v, causal, scale, path, False)
        out, lse = _forward(q, k, v, causal, scale, path, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g, ctx.causal,
                                         ctx.scale)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal: bool = False,
                    sm_scale: Optional[float] = None):
    """Fused attention: q (B, H, Lq, D), k and v (B, H, Lk, D);
    ``sm_scale`` defaults to 1/sqrt(D); ``causal`` masks bottom-right
    aligned.  Returns (B, H, Lq, D) in q's dtype, differentiable in q, k
    and v.  Takes no mask and no dropout
    (``ops.attention.dot_product_attention`` routes those)."""
    path = _select(q, k, v)
    save = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    return _Flash.apply(q, k, v, causal, _scale(q, sm_scale), path, save)


# ``ops.flash_attention(...)`` calls the function, as in the JAX package
dispatch.callable_module(__name__)
