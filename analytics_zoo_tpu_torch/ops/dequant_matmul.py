"""Fused dequantize-matmul for int8 / packed-int4 weights.

The plain PyTorch version (``dequant_matmul_reference``) decodes the
whole weight to f32 in device memory and multiplies; the CUDA kernel
(``csrc/dequant_matmul.cu``, the port of the JAX package's Pallas
``_dq_kernel``) keeps the decode inside the matmul, so weights travel at
one byte (int8) or a nibble (int4) per element.

int4 packing is two's-complement nibbles along the K axis: packed byte
``(q[2k+1] << 4) | (q[2k] & 0xF)``, odd K padded with a zero nibble
(``rows`` carries the true K).  Packing and quantization are bit-identical
to the JAX package's, so quantized trees interchange.

Routing (``ops.dispatch.select_path``): a CUDA tensor launches the kernel
or raises; a CPU tensor takes the plain version.  Like the JAX package's
``dequant_matmul`` it has no config knob.  Forward only: serving never
differentiates it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from analytics_zoo_tpu_torch.ops import _build, dispatch

BITS = (8, 4)

# one per launch of the CUDA kernel, nowhere else
LAUNCHES = dispatch.LaunchCount()

_SIGNATURES = {
    "zoo_dequant_matmul_f32": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]),
    "zoo_dequant_matmul_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def pack_int4(q4: torch.Tensor) -> torch.Tensor:
    """(K, N) int8 values in [-8, 7] → (ceil(K/2), N) packed bytes."""
    if q4.shape[0] % 2:
        q4 = torch.cat([q4, torch.zeros_like(q4[:1])], dim=0)
    q32 = q4.to(torch.int32)
    # (hi << 4) | (lo & 0xF) stays in [-128, 127]: exact int8 round-trip
    packed = (q32[1::2] * 16) | (q32[0::2] & 0xF)
    return packed.to(torch.int8)


def unpack_int4(packed: torch.Tensor, rows: int) -> torch.Tensor:
    """Inverse of ``pack_int4``: (Kp, N) bytes → (rows, N) int8 nibbles."""
    b32 = packed.to(torch.int32)
    lo = ((b32 & 0xF) ^ 8) - 8                   # sign-extend low nibble
    hi = b32 >> 4                                # arithmetic: sign-extends
    full = torch.stack([lo, hi], dim=1).reshape(2 * packed.shape[0],
                                                packed.shape[1])
    return full[:rows].to(torch.int8)


def quantize_weights(w, bits: int = 8):
    """Symmetric per-output-channel quantization of a (K, N) weight.

    Returns ``(q, scale)``: ``q`` int8 — (K, N) values for ``bits=8``,
    nibble-packed (ceil(K/2), N) for ``bits=4`` — and ``scale`` f32 (1, N).
    """
    if bits not in BITS:
        raise ValueError(f"bits must be one of {BITS}, got {bits}")
    w = torch.as_tensor(w)
    if w.ndim != 2:
        raise ValueError(f"weights must be (in, out), got {tuple(w.shape)}")
    qmax = 127.0 if bits == 8 else 7.0
    amax = w.abs().amax(dim=0, keepdim=True)
    scale = torch.where(amax == 0, torch.ones_like(amax),
                        amax / qmax).to(torch.float32)
    q = torch.clamp(torch.round(w / scale), -qmax, qmax).to(torch.int8)
    return (pack_int4(q) if bits == 4 else q), scale


def dequantize_leaf(leaf: dict) -> torch.Tensor:
    """f32 tensor back from a quantized leaf — ``{"q", "scale"}`` (int8)
    or ``{"q4", "scale"}`` (packed int4, even row count)."""
    if "q4" in leaf:
        q = unpack_int4(leaf["q4"], 2 * leaf["q4"].shape[0])
        return q.to(torch.float32) * leaf["scale"]
    return leaf["q"].to(torch.float32) * leaf["scale"]


def dequant_matmul_reference(x, q, scale, bits: int = 8,
                             rows: Optional[int] = None):
    """Plain PyTorch version: ``x @ (unpack(q) * scale)``, with the
    dequantized f32 weight materialised."""
    if bits == 4:
        q = unpack_int4(q, rows if rows is not None else 2 * q.shape[0])
    w = q.to(torch.float32) * scale.reshape(1, -1)
    return torch.matmul(x.to(torch.float32), w).to(x.dtype)


def _lib():
    return _build.library("dequant_matmul", _SIGNATURES)


def _launch(x, q, scale, bits):
    """Run the CUDA kernel on (M, K) ``x``."""
    dev = x.device
    if dev.type != "cuda" or q.device != dev or scale.device != dev:
        raise ValueError(f"dequant_matmul kernel needs x, q and scale on "
                         f"one CUDA device, got {x.device}, {q.device} and "
                         f"{scale.device}")
    if x.dtype != torch.float32 or q.dtype != torch.int8 \
            or scale.dtype != torch.float32:
        raise TypeError(f"dequant_matmul kernel takes f32 x, int8 q and f32 "
                        f"scale, got {x.dtype}, {q.dtype} and {scale.dtype}")
    m, k = x.shape
    n = q.shape[1]
    k_store = 2 * q.shape[0] if bits == 4 else q.shape[0]
    if k > k_store:
        raise ValueError(f"x K dim {k} exceeds stored weight rows {k_store}")
    if scale.numel() != n:
        raise ValueError(f"scale has {scale.numel()} entries for {n} "
                         "output channels")
    x, q, scale = x.contiguous(), q.contiguous(), scale.contiguous()
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0 or n == 0:
        return y
    if k == 0:
        return y.zero_()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().zoo_dequant_matmul_f32(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(),
            m, k, n, bits, stream)
    if rc != 0:
        msg = _lib().zoo_dequant_matmul_error_string(rc).decode()
        raise RuntimeError(
            f"dequant_matmul CUDA kernel launch failed ({msg}) for x "
            f"{tuple(x.shape)}, int{bits} q {tuple(q.shape)}")
    LAUNCHES.add()
    return y


def dequant_matmul(x, q, scale, bits: int = 8, rows: Optional[int] = None):
    """``x @ dequant(q, scale)`` with the dequantize fused into the matmul.

    ``x`` (..., K) float; ``q`` int8 weight storage — (K, N) for
    ``bits=8``, nibble-packed (ceil(K/2), N) for ``bits=4`` (``rows=K``
    disambiguates odd K); ``scale`` f32 per-output-channel, (N,) or
    (1, N).  Returns (..., N) in ``x.dtype``.
    """
    if bits not in BITS:
        raise ValueError(f"bits must be one of {BITS}, got {bits}")
    k = x.shape[-1]
    lead = tuple(x.shape[:-1])
    path = dispatch.select_path(
        "dequant_matmul", device=x.device, shapes_ok=q.ndim == 2,
        shape=f"a {q.ndim}-D weight {tuple(q.shape)} (it takes (K, N))")
    if path == dispatch.PATH_REFERENCE:
        return dequant_matmul_reference(x, q, scale, bits, rows)
    out = _launch(x.reshape(-1, k), q, scale, bits)
    return out.reshape(lead + (q.shape[1],))
