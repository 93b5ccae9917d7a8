"""Fused embedding bag (multi-hot gather + combine), forward and backward.

The plain PyTorch versions (``embedding_bag_reference`` and
``embedding_bag_backward_reference``) gather the (B, N, D) rows, or
scatter the (B, N, D) contributions, through device memory; the CUDA
kernels (``csrc/embedding_bag.cu``, the ports of the JAX package's Pallas
``_fwd_kernel`` and ``_bwd_kernel``) read each row once and write only
the (B, D) result, and sum ``scale_b * g[b]`` per row in a fixed order
(within chunks of slots, then the chunks in order), writing each row of
the (V, D) table gradient once: the same bits on every run.  Tables of
float32, bfloat16 and float16 sum in f32 and answer in the table's type,
rounded once (the JAX kernel's rule); float64 tables sum in f64.  The
backward takes ``g`` in f32, as the JAX rule does
(``g.astype(jnp.float32)``), and ``_Bag`` casts the f32 gradient to the
table's type.

Routing (``ops.dispatch.select_path``, knob ``ZooConfig.fused_embedding``):
a CUDA tensor launches the kernel unless the knob says ``off``; a CPU
tensor takes the plain version.  For a CUDA tensor the wrapper launches or
raises — it never falls back.  Out-of-range ids clip to ``[0, V-1]`` on
both paths (the rule of the TPU kernel).

Both lookups are one ``torch.autograd.Function`` (``_Bag``) on every
device, differentiable with respect to the table: the forward saves only
the ids and the table's shape (nothing under ``torch.no_grad`` or
``torch.inference_mode``), and the backward is the backward kernel, or
its plain version on the CPU.  The backward is the true gradient of this
forward: every live slot (``id != pad_id``, every slot when ``pad_id`` is
None) scatters to its clipped row, negative ids included — where the JAX
kernel, with ``pad_id=None``, skips negative ids.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from analytics_zoo_tpu_torch.ops import _build, dispatch

COMBINERS = ("sum", "mean", "sqrtn")
_COMBINER_CODE = {"sum": 0, "mean": 1, "sqrtn": 2}
_INT32 = (-(1 << 31), (1 << 31) - 1)

# one per launch of each CUDA kernel, nowhere else
LAUNCHES = dispatch.LaunchCount("embedding_bag")               # forward
BWD_LAUNCHES = dispatch.LaunchCount("embedding_bag_bwd")       # backward

# the forward kernel's table types, by their code in the C entry
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
                 torch.float64: 3}

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
         ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int]
_STREAM = [ctypes.c_void_p]
_SIGNATURES = {
    # ..., dtype, piece, then the five fields of BagLayout
    "zoo_embedding_bag_fwd": (ctypes.c_int,
                              _ARGS + [ctypes.c_int] * 7 + _STREAM),
    # ..., route, then the workspace: partials, prow, counters, list,
    # heavy, state
    "zoo_embedding_bag_bwd": (ctypes.c_int, _ARGS + [ctypes.c_int]
                              + [ctypes.c_void_p] * 6 + _STREAM),
    "zoo_embedding_bag_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


# The backward's sizes (csrc/embedding_bag.cu: kTileSlots, kChunk,
# kScanTile): the most slots the tile way takes, slots per chunk of the
# lists way, and row counters per scan block.  The tile way's blocks each
# read every id: it is taken while (V / 64 blocks) x (slots) stays under
# BWD_TILE_READS.
BWD_TILE_SLOTS = 16384
BWD_TILE_ROWS = 64
BWD_TILE_READS = 1 << 23
BWD_CHUNK = 256
BWD_SCAN_TILE = 8192
_BWD_ROUTES = {"tile": 1, "lists": 2, "owned": 3}
BWD_OWNED_SPAN = 64               # owned rows where B*N <= V <= 64 B*N
_BWD_MAX = (1 << 31) - 1 - BWD_CHUNK       # V and B * N stay below it
_ALIGN = 256


class BwdPlan(NamedTuple):
    """How the backward kernel runs for one shape, and its workspace.

    ``route`` is ``"none"`` (no slot or no column: no launch, the gradient
    is zeros), ``"tile"`` (one kernel: each block owns a range of rows,
    keeps the slots that land in them in slot order and writes its rows;
    for at most ``BWD_TILE_SLOTS`` slots, rows of at most 32 column
    pieces, and where the blocks' reads of the ids stay under
    ``BWD_TILE_READS``) or
    ``"lists"`` (a memset of the counters, then the chunk pass with row
    counts, a scan, the placing of each partial in its row's list, the
    pass over the rows of at most two partials, and the pass over the
    rows of more, off two queues) or ``"owned"`` (the lists way where the
    table has between B*N and ``BWD_OWNED_SPAN`` x B*N rows, so most rows
    take their slots from one chunk: a pass first counts each row's
    slots, and a chunk that holds all of a row's slots writes the row
    itself).  ``sections`` are ``(name, byte offset, bytes)`` in one
    workspace of ``workspace_bytes``; ``zeroed_bytes`` of it (the
    counters) are zeroed by the C entry; ``device_ops`` counts the device
    kernels and memsets one call issues."""

    route: str
    slots: int
    chunks: int
    device_ops: int
    sections: Tuple[Tuple[str, int, int], ...]
    workspace_bytes: int
    zeroed_bytes: int


def _vec_width(dim: int) -> int:
    """Floats a lane moves at once: 4, 2 or 1, the widest that divides
    ``dim`` (csrc: the backward's VW)."""
    return 4 if dim % 4 == 0 else (2 if dim % 2 == 0 else 1)


def bag_bwd_plan(vocab: int, dim: int, bags: int, nnz: int,
                 route: Optional[str] = None) -> BwdPlan:
    """The backward's route and workspace for a (vocab, dim) table and a
    (bags, nnz) id block, from these shapes alone (so a graph replays the
    same allocation).  ``route`` forces ``"tile"``, ``"lists"`` or
    ``"owned"`` where the shape allows it (tests run each at one shape)."""
    vocab, dim, bags, nnz = int(vocab), int(dim), int(bags), int(nnz)
    if min(vocab, dim, bags, nnz) < 0:
        raise ValueError(f"negative size in table ({vocab}, {dim}) or ids "
                         f"({bags}, {nnz})")
    slots = bags * nnz
    if slots == 0 or dim == 0:
        return BwdPlan("none", slots, 0, 0, (), 0, 0)
    if vocab < 1 or vocab > _BWD_MAX or slots > _BWD_MAX:
        raise ValueError(f"embedding_bag backward kernel takes fewer than "
                         f"{_BWD_MAX + 1} rows and slots, got a ({vocab}, "
                         f"{dim}) table and ({bags}, {nnz}) ids")
    fits = (slots <= BWD_TILE_SLOTS and dim // _vec_width(dim) <= 32)
    if fits and -(-vocab // BWD_TILE_ROWS) * slots <= BWD_TILE_READS:
        auto = "tile"
    elif slots <= vocab <= BWD_OWNED_SPAN * slots:
        auto = "owned"
    else:
        auto = "lists"
    route = auto if route is None else route
    if route not in _BWD_ROUTES or (route == "tile" and not fits):
        raise ValueError(f"route {route!r} does not take ({bags}, {nnz}) "
                         f"ids and rows of {dim}")
    if route == "tile":
        return BwdPlan("tile", slots, 0, 1, (), 0, 0)
    chunks = -(-slots // BWD_CHUNK)
    cap = chunks * BWD_CHUNK
    tiles = -(-(vocab + 1) // BWD_SCAN_TILE)
    # counts, tile sums, heavy rows, and each row's slots for owned rows
    # from the next 16 bytes
    lead = vocab + 3 + tiles
    zeroed = 4 * (-(-lead // 4) * 4 + vocab if route == "owned" else lead)
    sizes = [("counters", zeroed), ("list", 4 * cap),
             ("heavy", 4 * min(vocab, cap // 2)), ("prow", 4 * cap),
             ("state", vocab + 1), ("partials", 4 * cap * dim)]
    sections, at = [], 0
    for name, nbytes in sizes:
        sections.append((name, at, nbytes))
        at += -(-nbytes // _ALIGN) * _ALIGN
    return BwdPlan(route, slots, chunks, 7 if route == "owned" else 6,
                   tuple(sections), at, zeroed)


class BagLayout(NamedTuple):
    """How the forward kernel's warp reads a row (``csrc/embedding_bag.cu``):
    ``pieces`` loads of ``piece_bytes`` per row; slot groups of ``width``
    lanes (one piece each), ``groups`` of them in a warp; ``per_bag``
    groups share a bag's slots, and a warp takes ``bags_per_round`` bags
    at once (more than one only where a bag has fewer slots than there
    are groups)."""

    pieces: int
    width: int
    groups: int
    per_bag: int
    bags_per_round: int


def piece_bytes(elem: int, dim: int, address: int) -> int:
    """Bytes per lane load of a (V, dim) table of ``elem``-byte elements
    at ``address``: 16, or where the row's byte width or the address is
    off 16 bytes the largest of 8, 4, 2 that divides both (never less
    than one element)."""
    for piece in (16, 8, 4, 2):
        if piece >= elem and (dim * elem) % piece == 0 \
                and address % piece == 0:
            return piece
    raise ValueError(f"a table of {elem}-byte elements at address "
                     f"{address:#x} is not aligned to its element")


def bag_layout(dim: int, elem: int, piece: int, nnz: int) -> BagLayout:
    """The forward kernel's lane layout for rows of ``dim`` elements of
    ``elem`` bytes read in ``piece``-byte loads, bags of ``nnz`` slots."""
    pieces = dim * elem // piece
    width = min(pieces, 32)
    groups = 32 // width
    per_bag = max(1, min(groups, nnz))
    return BagLayout(pieces, width, groups, per_bag, groups // per_bag)


def _check_args(table, ids, combiner):
    if table.ndim != 2:
        raise ValueError(f"table must be (vocab, dim), got {tuple(table.shape)}")
    if ids.ndim != 2:
        raise ValueError(f"ids must be (bags, max_nnz), got {tuple(ids.shape)}")
    if combiner not in COMBINERS:
        raise ValueError(f"combiner must be one of {COMBINERS}, "
                         f"got {combiner!r}")


def _acc_dtype(dtype):
    """Accumulation type: f32, or f64 for an f64 table (gradcheck)."""
    return torch.promote_types(dtype, torch.float32)


def _bag_mask(ids, pad_id, dtype=torch.float32):
    """(B, N) validity mask; ``pad_id=None`` means every slot counts."""
    if pad_id is None:
        return torch.ones(ids.shape, dtype=dtype, device=ids.device)
    return (ids != pad_id).to(dtype)


def _combiner_scale(mask, combiner):
    """(B, 1) per-bag weight applied after the masked sum."""
    if combiner == "sum":
        return torch.ones((mask.shape[0], 1), dtype=mask.dtype,
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
    acc = _acc_dtype(table.dtype)
    mask = _bag_mask(ids, pad_id, acc)
    rows = table[_clip_ids(ids, table.shape[0])]           # (B, N, D)
    out = (rows.to(acc) * mask[..., None]).sum(dim=1)
    out = out * _combiner_scale(mask, combiner)
    return out.to(table.dtype)


def embedding_bag_backward_reference(vocab: int, ids, g,
                                     combiner: str = "sum", pad_id=0):
    """Plain PyTorch version of the backward: the (vocab, D) table
    gradient ``zeros.index_add_(0, clipped ids, (g * scale)[:, None] *
    mask)`` — autograd of ``embedding_bag_reference``, with the (B, N, D)
    contributions materialised.  f32 (f64 for an f64 ``g``)."""
    if ids.ndim != 2 or g.ndim != 2 or g.shape[0] != ids.shape[0]:
        raise ValueError(f"ids (bags, max_nnz) and g (bags, dim) must "
                         f"agree, got {tuple(ids.shape)} and "
                         f"{tuple(g.shape)}")
    acc = _acc_dtype(g.dtype)
    mask = _bag_mask(ids, pad_id, acc)
    g_scaled = g.to(acc) * _combiner_scale(mask, combiner)   # (B, D)
    contrib = g_scaled[:, None, :] * mask[..., None]         # (B, N, D)
    dim = g.shape[1]
    return torch.zeros((vocab, dim), dtype=acc, device=g.device).index_add_(
        0, _clip_ids(ids, vocab).reshape(-1), contrib.reshape(-1, dim))


def _lib():
    return _build.library("embedding_bag", _SIGNATURES)


def _check_pad(pad_id):
    if pad_id is not None and not _INT32[0] <= int(pad_id) <= _INT32[1]:
        raise ValueError(f"pad_id {pad_id} does not fit int32")


def _raise_on(rc, what, shapes):
    if rc != 0:
        msg = _lib().zoo_embedding_bag_error_string(rc).decode()
        raise RuntimeError(f"embedding_bag {what} CUDA kernel launch failed "
                           f"({msg}) for {shapes}")


def _launch(table, ids, combiner, pad_id):
    """Run the forward kernel on (V, D) ``table`` and (B, N) ``ids``."""
    if table.device.type != "cuda" or ids.device != table.device:
        raise ValueError(f"embedding_bag kernel needs table and ids on one "
                         f"CUDA device, got {table.device} and {ids.device}")
    if table.dtype not in KERNEL_DTYPES:
        raise TypeError(f"embedding_bag kernel takes a float32, bfloat16, "
                        f"float16 or float64 table, got {table.dtype}")
    _check_pad(pad_id)
    vocab, dim = table.shape
    ids32 = ids.to(torch.int32).contiguous()
    table = table.contiguous()
    bags, nnz = ids32.shape
    out = torch.empty((bags, dim), dtype=table.dtype, device=table.device)
    if bags == 0 or dim == 0:
        return out
    elem = table.element_size()
    piece = piece_bytes(elem, dim, table.data_ptr())
    layout = bag_layout(dim, elem, piece, nnz)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().zoo_embedding_bag_fwd(
            table.data_ptr(), ids32.data_ptr(), out.data_ptr(), vocab, dim,
            bags, nnz, int(pad_id is not None),
            0 if pad_id is None else int(pad_id), _COMBINER_CODE[combiner],
            KERNEL_DTYPES[table.dtype], piece, *layout, stream)
    _raise_on(rc, "forward",
              f"table {tuple(table.shape)} {table.dtype} and ids "
              f"{tuple(ids32.shape)}")
    LAUNCHES.add()
    return out


def _launch_bwd(vocab, ids, g, combiner, pad_id, route=None):
    """Run the backward kernel: (B, N) ``ids`` and (B, D) ``g``, widened
    (or narrowed) to f32, into a fresh (vocab, D) f32 gradient that the
    kernel writes whole.  The workspace is sized by ``bag_bwd_plan`` from
    the shapes alone and taken from the caching allocator on the current
    stream; nothing here waits on the device."""
    if g.device.type != "cuda" or ids.device != g.device:
        raise ValueError(f"embedding_bag backward kernel needs ids and g on "
                         f"one CUDA device, got {ids.device} and {g.device}")
    if not g.is_floating_point():
        raise TypeError(f"embedding_bag backward kernel takes a float "
                        f"gradient, got {g.dtype}")
    _check_pad(pad_id)
    ids32 = ids.to(torch.int32).contiguous()
    g = g.to(torch.float32).contiguous()        # the JAX rule: g in f32
    bags, nnz = ids32.shape
    dim = g.shape[1]
    plan = bag_bwd_plan(vocab, dim, bags, nnz, route)
    if plan.route == "none":
        return torch.zeros((vocab, dim), dtype=torch.float32, device=g.device)
    dtab = torch.empty((vocab, dim), dtype=torch.float32, device=g.device)
    work = torch.empty(plan.workspace_bytes, dtype=torch.uint8,
                       device=g.device)
    at = {name: work.data_ptr() + off for name, off, _ in plan.sections}
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().zoo_embedding_bag_bwd(
            ids32.data_ptr(), g.data_ptr(), dtab.data_ptr(), vocab, dim,
            bags, nnz, int(pad_id is not None),
            0 if pad_id is None else int(pad_id), _COMBINER_CODE[combiner],
            _BWD_ROUTES[plan.route], at.get("partials"), at.get("prow"),
            at.get("counters"), at.get("list"), at.get("heavy"),
            at.get("state"), stream)
    _raise_on(rc, "backward", f"table ({vocab}, {dim}), ids "
              f"{tuple(ids32.shape)} and g {tuple(g.shape)}")
    BWD_LAUNCHES.add()
    return dtab


def _knob():
    return dispatch.config_knob("fused_embedding", "auto")


def embedding_bag_backward(vocab: int, ids, g, combiner: str = "sum",
                           pad_id=0):
    """The (vocab, D) f32 gradient of ``embedding_bag`` with respect to
    its table, for (B, N) ``ids`` and the (B, D) output gradient ``g``:
    the backward kernel for a CUDA tensor, the plain version on the CPU
    (``select_path("embedding_bag_bwd")``, knob ``fused_embedding``)."""
    path = dispatch.select_path("embedding_bag_bwd", device=g.device,
                                knob=_knob())
    if path == dispatch.PATH_REFERENCE:
        return embedding_bag_backward_reference(vocab, ids, g, combiner,
                                                pad_id)
    return _launch_bwd(vocab, ids, g, combiner, pad_id)


class _Bag(torch.autograd.Function):
    """The bag lookup with its kernel backward.  ``path`` is the
    forward's routing decision; ``save`` is False when the caller's grad
    mode is off, so serving under ``inference_mode`` keeps nothing."""

    @staticmethod
    def forward(ctx, table, ids, combiner, pad_id, path, save):
        if path == dispatch.PATH_REFERENCE:
            out = embedding_bag_reference(table, ids, combiner, pad_id)
        else:
            out = _launch(table, ids, combiner, pad_id)
        if save:
            ctx.save_for_backward(ids)
        ctx.vocab, ctx.dtype = table.shape[0], table.dtype
        ctx.combiner, ctx.pad_id = combiner, pad_id
        return out

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None, None
        (ids,) = ctx.saved_tensors
        dtab = embedding_bag_backward(ctx.vocab, ids, g, ctx.combiner,
                                      ctx.pad_id)
        return dtab.to(ctx.dtype), None, None, None, None, None


def _apply(table, ids, combiner, pad_id, path):
    save = torch.is_grad_enabled() and table.requires_grad
    return _Bag.apply(table, ids, combiner, pad_id, path, save)


def embedding_bag(table, ids, combiner: str = "sum", pad_id=0):
    """Fused multi-hot lookup: ``combine_j table[ids[b, j]]`` per bag.

    ``table`` (vocab, dim) float; ``ids`` (bags, max_nnz) int.  Slots
    equal to ``pad_id`` contribute nothing (``pad_id=None`` counts every
    slot).  ``combiner`` is ``"sum" | "mean" | "sqrtn"`` over each bag's
    valid slots.  Out-of-range ids clip.  Differentiable with respect to
    ``table``.
    """
    _check_args(table, ids, combiner)
    path = dispatch.select_path(
        "embedding_bag", device=table.device,
        shapes_ok=table.shape[0] >= 1,
        shape=f"an empty table {tuple(table.shape)}",
        knob=_knob())
    return _apply(table, ids, combiner, pad_id, path)


def embedding_gather(table, ids):
    """Plain ``table[ids]`` lookup routed through the bag kernel.

    A gather is the degenerate bag (one id per bag, no combine): ids of
    any shape flatten to (num, 1) singleton bags and the result folds
    back to ``ids.shape + (dim,)``.  Ids clip like the bag's.
    Differentiable with respect to ``table``.
    """
    if table.ndim != 2:
        raise ValueError(f"table must be (vocab, dim), got {tuple(table.shape)}")
    path = dispatch.select_path(
        "embedding_gather", device=table.device,
        shapes_ok=table.shape[0] >= 1,
        shape=f"an empty table {tuple(table.shape)}",
        knob=_knob())
    out = _apply(table, ids.reshape(-1, 1), "sum", None, path)
    return out.reshape(tuple(ids.shape) + (table.shape[1],))
