"""Fused embedding-bag forward (multi-hot gather + combine).

The plain PyTorch version (``embedding_bag_reference``) gathers the
(B, N, D) rows into device memory and reduces them; the CUDA kernel
(``csrc/embedding_bag.cu``, the port of the JAX package's Pallas
``_fwd_kernel``) reads each row once and writes only the (B, D) result.

Routing (``ops.dispatch.select_path``, knob ``ZooConfig.fused_embedding``):
a CUDA tensor launches the kernel unless the knob says ``off``; a CPU
tensor takes the plain version.  For a CUDA tensor the wrapper launches or
raises — it never falls back.  Out-of-range ids clip to ``[0, V-1]`` on
both paths (the rule of the TPU kernel).  Forward only: the backward
kernel belongs to the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from analytics_zoo_tpu_torch.ops import _build, dispatch

COMBINERS = ("sum", "mean", "sqrtn")
_COMBINER_CODE = {"sum": 0, "mean": 1, "sqrtn": 2}
_INT32 = (-(1 << 31), (1 << 31) - 1)

# one per launch of the CUDA kernel, nowhere else
LAUNCHES = dispatch.LaunchCount()

_SIGNATURES = {
    "zoo_embedding_bag_fwd_f32": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
    "zoo_embedding_bag_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def _check_args(table, ids, combiner):
    if table.ndim != 2:
        raise ValueError(f"table must be (vocab, dim), got {tuple(table.shape)}")
    if ids.ndim != 2:
        raise ValueError(f"ids must be (bags, max_nnz), got {tuple(ids.shape)}")
    if combiner not in COMBINERS:
        raise ValueError(f"combiner must be one of {COMBINERS}, "
                         f"got {combiner!r}")


def _bag_mask(ids, pad_id):
    """(B, N) f32 validity mask; ``pad_id=None`` means every slot counts."""
    if pad_id is None:
        return torch.ones(ids.shape, dtype=torch.float32, device=ids.device)
    return (ids != pad_id).to(torch.float32)


def _combiner_scale(mask, combiner):
    """(B, 1) f32 per-bag weight applied after the masked sum."""
    if combiner == "sum":
        return torch.ones((mask.shape[0], 1), dtype=torch.float32,
                          device=mask.device)
    n = torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)
    return 1.0 / (n if combiner == "mean" else torch.sqrt(n))


def _clip_ids(ids, vocab):
    return torch.clamp(ids.to(torch.int64), 0, vocab - 1)


def embedding_bag_reference(table, ids, combiner: str = "sum", pad_id=0):
    """Plain PyTorch version: gather + masked combine, ids clipped.

    Same math as the kernel and the oracle of the parity tests; it
    materialises the (B, N, D) gathered rows, which the kernel never
    does."""
    _check_args(table, ids, combiner)
    mask = _bag_mask(ids, pad_id)
    rows = table[_clip_ids(ids, table.shape[0])]           # (B, N, D)
    out = (rows.to(torch.float32) * mask[..., None]).sum(dim=1)
    out = out * _combiner_scale(mask, combiner)
    return out.to(table.dtype)


def _lib():
    return _build.library("embedding_bag", _SIGNATURES)


def _launch(table, ids, combiner, pad_id):
    """Run the CUDA kernel on (V, D) ``table`` and (B, N) ``ids``."""
    if table.device.type != "cuda" or ids.device != table.device:
        raise ValueError(f"embedding_bag kernel needs table and ids on one "
                         f"CUDA device, got {table.device} and {ids.device}")
    if table.dtype != torch.float32:
        raise TypeError(f"embedding_bag kernel takes a float32 table, "
                        f"got {table.dtype}")
    if pad_id is not None and not _INT32[0] <= int(pad_id) <= _INT32[1]:
        raise ValueError(f"pad_id {pad_id} does not fit int32")
    vocab, dim = table.shape
    ids32 = ids.to(torch.int32).contiguous()
    table = table.contiguous()
    bags, nnz = ids32.shape
    out = torch.empty((bags, dim), dtype=table.dtype, device=table.device)
    if bags == 0:
        return out
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().zoo_embedding_bag_fwd_f32(
            table.data_ptr(), ids32.data_ptr(), out.data_ptr(), vocab, dim,
            bags, nnz, int(pad_id is not None),
            0 if pad_id is None else int(pad_id), _COMBINER_CODE[combiner],
            stream)
    if rc != 0:
        msg = _lib().zoo_embedding_bag_error_string(rc).decode()
        raise RuntimeError(
            f"embedding_bag CUDA kernel launch failed ({msg}) for table "
            f"{tuple(table.shape)} and ids {tuple(ids32.shape)}")
    LAUNCHES.add()
    return out


def embedding_bag(table, ids, combiner: str = "sum", pad_id=0):
    """Fused multi-hot lookup: ``combine_j table[ids[b, j]]`` per bag.

    ``table`` (vocab, dim) float; ``ids`` (bags, max_nnz) int.  Slots
    equal to ``pad_id`` contribute nothing (``pad_id=None`` counts every
    slot).  ``combiner`` is ``"sum" | "mean" | "sqrtn"`` over each bag's
    valid slots.  Out-of-range ids clip.
    """
    _check_args(table, ids, combiner)
    path = dispatch.select_path(
        "embedding_bag", device=table.device,
        shapes_ok=table.shape[0] >= 1,
        shape=f"an empty table {tuple(table.shape)}",
        knob=dispatch.config_knob("fused_embedding", "auto"))
    if path == dispatch.PATH_REFERENCE:
        return embedding_bag_reference(table, ids, combiner, pad_id)
    return _launch(table, ids, combiner, pad_id)


def embedding_gather(table, ids):
    """Plain ``table[ids]`` lookup routed through the bag kernel.

    A gather is the degenerate bag (one id per bag, no combine): ids of
    any shape flatten to (num, 1) singleton bags and the result folds
    back to ``ids.shape + (dim,)``.  Ids clip like the bag's.
    """
    if table.ndim != 2:
        raise ValueError(f"table must be (vocab, dim), got {tuple(table.shape)}")
    path = dispatch.select_path(
        "embedding_gather", device=table.device,
        knob=dispatch.config_knob("fused_embedding", "auto"))
    if path == dispatch.PATH_REFERENCE:
        return table[_clip_ids(ids, table.shape[0])]
    out = _launch(table, ids.reshape(-1, 1), "sum", None)
    return out.reshape(tuple(ids.shape) + (table.shape[1],))
