"""Attention ops: the oracle, blockwise online-softmax attention, and the
router the attention layers call.

Shapes follow the JAX package: q (B, H, Lq, D), k and v (B, H, Lk, D);
masks broadcast to (B, H, Lq, Lk) with 1 = attend.  Masked logits are
-1e30 everywhere, and a query row with no live key comes out 0 on every
path.

- ``reference_attention``: the materialised O(L²) softmax.
- ``blockwise_attention``: a loop over key blocks with a running
  (max, normaliser, accumulator) in f32 — masks, ragged key lengths and
  probability dropout, at O(Lq · block) memory.
- ``flash_attention`` (``ops/flash_attention.py``): the hand-written CUDA
  kernels, forward and backward; no mask, no dropout.
- ``dot_product_attention`` routes between them as the JAX package does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from analytics_zoo_tpu_torch.ops import dispatch
from analytics_zoo_tpu_torch.ops.flash_attention import (_kernel_shapes_ok,
                                                         flash_attention)

NEG_INF = -1e30


def _scale(q, sm_scale):
    return sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])


def _neg_like(logits):
    """-1e30 in the logits' dtype, as the JAX package's weakly typed
    NEG_INF becomes in a ``where``: -inf in float16, whose range ends at
    65504 (a Python -1e30 cannot fill a float16 tensor)."""
    # a fill, not a host copy: capturable in a CUDA graph
    return torch.full((), NEG_INF, dtype=torch.float32,
                      device=logits.device).to(logits.dtype)


def reference_attention(q, k, v, mask=None, causal: bool = False,
                        sm_scale: Optional[float] = None):
    """Naive O(L²) attention — the numerics oracle for tests.  Fully masked
    query rows are zeroed, so every path agrees there."""
    lq, lk = q.shape[2], k.shape[2]
    logits = torch.matmul(q, k.transpose(-1, -2)) * _scale(q, sm_scale)
    neg = _neg_like(logits)
    if causal:
        cm = torch.ones((lq, lk), dtype=torch.bool,
                        device=q.device).tril(lk - lq)
        logits = torch.where(cm, logits, neg)
    if mask is not None:
        logits = torch.where(mask.to(torch.bool), logits, neg)
    w = torch.softmax(logits, dim=-1)
    row_valid = (logits > NEG_INF / 2).any(dim=-1, keepdim=True)
    w = torch.where(row_valid, w, torch.zeros_like(w))
    return torch.matmul(w, v)


def online_softmax_fold(m_prev, l_prev, acc, logits, values,
                        drop_mask=None, keep_prob: float = 1.0):
    """One fold of the online-softmax accumulation over a key block.

    ``logits`` (B, H, Lq, Kblk) already carry every mask as -1e30.
    Returns the running (max, normaliser, weighted-value accumulator);
    fully masked rows stay finite and contribute 0.  ``drop_mask`` (the
    logits' shape) is dropout on the softmax probabilities: the normaliser
    keeps the undropped sum and only the value accumulation is masked and
    rescaled — dropout on the normalised weights, never materialised.
    """
    m_cur = logits.amax(dim=-1)
    m_new = torch.maximum(m_prev, m_cur)
    finite = torch.isfinite(m_new)
    m_safe = torch.where(finite, m_new, torch.zeros_like(m_new))
    p = torch.exp(logits - m_safe[..., None])
    p = torch.where(logits <= NEG_INF / 2, torch.zeros_like(p), p)
    alpha = torch.exp(torch.where(torch.isfinite(m_prev), m_prev - m_safe,
                                  torch.full_like(m_prev, NEG_INF)))
    l_new = l_prev * alpha + p.sum(dim=-1)
    p_acc = p if drop_mask is None else (
        torch.where(drop_mask, p, torch.zeros_like(p)) / keep_prob)
    acc = acc * alpha[..., None] + torch.matmul(p_acc, values)
    m_out = m_safe + torch.where(finite, torch.zeros_like(m_safe),
                                 torch.full_like(m_safe, NEG_INF))
    return m_out, l_new, acc


def blockwise_attention(q, k, v, mask=None, causal: bool = False,
                        sm_scale: Optional[float] = None,
                        block_size: int = 512, dropout_rate: float = 0.0,
                        dropout_generator: Optional[torch.Generator] = None):
    """Attention as a loop over key blocks of ``block_size`` with an
    online softmax: O(Lq · block) memory, differentiable by autograd.
    A ragged last block is padded and its pad keys masked.

    ``dropout_rate`` > 0 with ``dropout_generator`` (a ``torch.Generator``
    on q's device) drops softmax probabilities, each kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)``: the law of
    the JAX package's per-block ``fold_in`` draws, with no bit parity with
    ``jax.random``.  The carry is f32 whatever the inputs' dtype.
    """
    b, h, lq, d = q.shape
    lk = k.shape[2]
    bs = min(block_size, lk)
    nblocks = -(-lk // bs)
    pad = nblocks * bs - lk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    if mask is not None:
        mask = torch.broadcast_to(mask.to(torch.bool), (b, h, lq, lk))
        if pad:
            mask = torch.nn.functional.pad(mask, (0, pad))
    acc_t = torch.promote_types(q.dtype, torch.float32)
    q_scaled = q * _scale(q, sm_scale)
    q_pos = torch.arange(lq, device=q.device) + (lk - lq)
    dropping = dropout_rate > 0.0 and dropout_generator is not None
    m = torch.full((b, h, lq), NEG_INF, dtype=acc_t, device=q.device)
    l = torch.zeros((b, h, lq), dtype=acc_t, device=q.device)
    acc = torch.zeros((b, h, lq, d), dtype=acc_t, device=q.device)
    for blk in range(nblocks):
        sl = slice(blk * bs, (blk + 1) * bs)
        vb = v[:, :, sl]
        logits = torch.matmul(q_scaled, k[:, :, sl].transpose(-1, -2))
        neg = _neg_like(logits)
        kpos = blk * bs + torch.arange(bs, device=q.device)
        if pad:
            logits = torch.where(kpos < lk, logits, neg)
        if causal:
            logits = torch.where(q_pos[:, None] >= kpos[None, :], logits,
                                 neg)
        if mask is not None:
            logits = torch.where(mask[..., sl], logits, neg)
        logits = logits.to(acc_t)
        keep = None
        if dropping:
            keep = torch.rand(logits.shape, generator=dropout_generator,
                              device=q.device) < 1.0 - dropout_rate
        m, l, acc = online_softmax_fold(m, l, acc, logits, vb.to(acc_t),
                                        drop_mask=keep,
                                        keep_prob=1.0 - dropout_rate)
    return (acc / l.clamp_min(1e-20)[..., None]).to(q.dtype)


def takes_flash(q, k, mask=None, dropping: bool = False) -> bool:
    """The router's predicate: True where ``flash_attention`` can answer
    the call — no mask, no probability dropout, and q, k of a dtype and
    head width the kernel takes (float32 or bfloat16, D <= 128), as the
    JAX router passes its kernel limits as ``shapes_ok``."""
    return mask is None and not dropping and _kernel_shapes_ok(q, k)


def dot_product_attention(q, k, v, mask=None, causal: bool = False,
                          sm_scale: Optional[float] = None,
                          block_size: int = 512,
                          use_flash: Optional[bool] = None,
                          dropout_rate: float = 0.0,
                          dropout_generator: Optional[torch.Generator] = None):
    """Entry point of the attention layers, with the JAX package's routes.

    A call that ``takes_flash`` — no mask, no dropout, and a shape the
    kernel takes — goes to ``flash_attention``: on a CUDA tensor the
    kernel, on the CPU its plain version.  Any other call takes the JAX
    package's other route, counted as
    ``ops_kernel_selected_total{kernel="flash_attention",path="reference"}``:
    ``reference_attention`` when ``Lq · Lk <= 256²`` without dropout, else
    ``blockwise_attention``.  The choice is made from the shapes before any
    launch, on every device.  ``use_flash`` forces it: True takes the flash
    route (and raises for a mask or dropout, and on the card for a shape
    the kernel cannot take), False the other one.  The JAX package's TPU
    gates (D % 128, L % 128, L >= 2048) are not carried over.
    """
    dropping = dropout_rate > 0.0 and dropout_generator is not None
    if use_flash or (use_flash is None and takes_flash(q, k, mask, dropping)):
        if mask is not None:
            raise ValueError("flash kernel does not take a mask; pass "
                             "use_flash=False (or None for auto dispatch)")
        if dropping:
            raise ValueError("flash kernel does not support attention "
                             "dropout; pass use_flash=False/None")
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    dispatch.select_path("flash_attention", device=q.device,
                         force=dispatch.PATH_REFERENCE)
    if not dropping and q.shape[2] * k.shape[2] <= 256 * 256:
        # tiny sequences: one fused softmax beats the block loop
        return reference_attention(q, k, v, mask=mask, causal=causal,
                                   sm_scale=sm_scale)
    return blockwise_attention(q, k, v, mask=mask, causal=causal,
                               sm_scale=sm_scale, block_size=block_size,
                               dropout_rate=dropout_rate if dropping else 0.0,
                               dropout_generator=(dropout_generator
                                                  if dropping else None))
