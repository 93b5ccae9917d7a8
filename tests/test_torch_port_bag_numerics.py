"""The embedding-bag forward kernel's numeric contract
(``analytics_zoo_tpu_torch/csrc/embedding_bag.cu::bag_fwd``) against the
JAX package, on the CPU.

The kernel cannot run here, so ``emulate`` does its arithmetic in numpy,
from the layout the wrapper hands it (``ops.embedding_bag.piece_bytes``
and ``bag_layout``, the functions the wrapper calls):

- the lane map: lane = (slot group, piece); a group's lanes read one row
  ``piece`` bytes each, a bag's ``per_bag`` groups share its slots, and
  where a bag has fewer slots than there are groups a warp takes
  ``bags_per_round`` bags at once; rows wider than 32 pieces go 32
  pieces at a time;
- the id ballot: each 32-slot window of ids is read once, lane t slot t;
  its live mask (``ids != pad_id``) gives the live count by popcount,
  per bag where a window holds several;
- the reduction order: each lane adds its group's slots in f32 (f64 for
  f64 tables) in slot order, dead slots as zeros; a bag's groups are
  summed by the shuffle tree (group s takes s + o, o = 1, 2, 4, ..., where
  s % 2o == 0); the first group multiplies by 1, 1/n or 1/sqrt(n) and the
  result is rounded once into the table's type.

Where a group reads one slot, its lanes load that slot's id themselves
rather than through the window; the values added are the same.  The
knobs (loads in flight per lane, warps per block) change when a load is
issued, never which lane adds what in which order, so the emulation
covers every setting of them.

It is held against the JAX package's Pallas kernel
(``embedding_bag(..., interpret=True)``) and its reference
(``embedding_bag_reference``; in-range ids only, since ``jnp.take`` does
not clip), and ``reads`` checks that every live (slot, column) is added
exactly once and no dead one is.  Lowering the Pallas kernel in
interpret mode costs about 0.8 s per slot of N, so it is called once per
(N, dtype) at D = 130 and each narrower D is held against its first D
columns: the kernel's column d reads only column d of the table.
Tolerances: f32 |err| <= 1e-6 * the summed magnitude of the element's
terms (f32 sums in another order); bf16 and f16 |err| <= 2^-7 (2^-10) *
|jax| + that (one rounding of an f32 result into the table's type, which
may land one unit apart).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.ops import embedding_bag as teb

jeb = importlib.import_module("analytics_zoo_tpu.ops.embedding_bag")

DIMS = (1, 3, 5, 20, 24, 64, 72, 130)
NNZS = (1, 3, 32, 33, 100)
DTYPES = ("float32", "bfloat16", "float16")
RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}
F32_TOL = 1e-6
VOCAB, BAGS = 50, 9


def table_of(rs, vocab, dim, dtype):
    """A seeded (vocab, dim) table in ``dtype``: the torch tensor and its
    values widened exactly to f32 (f64 for f64)."""
    t = torch.from_numpy(rs.randn(vocab, dim).astype(np.float32)).to(
        getattr(torch, dtype))
    wide = torch.float64 if dtype == "float64" else torch.float32
    return t, t.to(wide).numpy()


def ids_of(rs, bags, nnz, pad_id, clip):
    lo, hi = (-7, VOCAB + 7) if clip else (0, VOCAB)
    ids = rs.randint(lo, hi, (bags, nnz)).astype(np.int32)
    if pad_id is not None:
        ids[rs.rand(bags, nnz) < 0.3] = pad_id
        ids[0, :] = pad_id                        # an all-pad bag
    return ids


def emulate(table, ids, combiner, pad_id, elem, address=0):
    """``bag_fwd``'s arithmetic on the widened ``table`` (V, D) of
    ``elem``-byte elements at ``address``.  Returns the output before its
    rounding into the table's type, in the accumulation type, and
    ``reads`` (B, N, D): how often each (slot, column) was added."""
    vocab, dim = table.shape
    bags, nnz = ids.shape
    piece = teb.piece_bytes(elem, dim, address)
    lay = teb.bag_layout(dim, elem, piece, nnz)
    k_el = piece // elem
    acc_t = table.dtype.type
    out = np.zeros((bags, dim), table.dtype)
    reads = np.zeros((bags, nnz, dim), np.int64)
    lane = np.arange(32)
    grp, p = lane // lay.width, lane % lay.width
    bl, sl = grp // lay.per_bag, grp % lay.per_bag
    flat = ids.reshape(-1)
    for b0 in range(0, bags, lay.bags_per_round):
        nb = min(lay.bags_per_round, bags - b0)
        slots = nb * nnz
        for c0 in range(0, lay.pieces, lay.width):
            pc = c0 + p
            on = (grp < lay.groups) & (pc < lay.pieces) & (bl < nb)
            cols = np.minimum(pc, lay.pieces - 1)[:, None] * k_el \
                + np.arange(k_el)
            acc = np.zeros((32, k_el), table.dtype)
            cnt = np.zeros(32, np.int64)
            s0 = 0
            while True:                   # the id windows; at least one
                ln = max(0, min(32, slots - s0))
                raw = np.zeros(32, np.int64)
                raw[:ln] = flat[b0 * nnz + s0:b0 * nnz + s0 + ln]
                live = lane < ln
                if pad_id is not None:
                    live &= raw != pad_id
                row = np.clip(raw, 0, vocab - 1)
                if lay.bags_per_round > 1:    # popcount of the lane's bag
                    in_bag = (lane[None, :] // nnz) == bl[:, None]
                    cnt += (in_bag & live[None, :]).sum(1)
                else:
                    cnt += live.sum()
                steps = 1 if lay.bags_per_round > 1 else max(
                    1, -(-ln // lay.per_bag))
                for k in range(steps):
                    t = bl * nnz + sl + lay.per_bag * k
                    ok = on & (t < ln)
                    ok[ok] &= live[t[ok]]
                    vals = table[row[np.minimum(t, 31)][:, None], cols]
                    acc = acc + np.where(ok[:, None], vals, acc_t(0))
                    f = s0 + t[ok]
                    np.add.at(reads, ((b0 + f // nnz)[:, None],
                                      (f % nnz)[:, None], cols[ok]), 1)
                s0 += 32
                if s0 >= slots:
                    break
            o = 1
            while o < lay.per_bag:        # the shuffle tree
                src = lane + o * lay.width
                moved = np.where((src < 32)[:, None],
                                 acc[np.minimum(src, 31)], acc)
                take = ((sl & (2 * o - 1)) == 0) & (sl + o < lay.per_bag)
                acc = np.where(take[:, None], acc + moved, acc)
                o *= 2
            for ln_ in np.flatnonzero(on & (sl == 0)):
                scale = acc_t(1)
                if combiner != "sum":
                    n = acc_t(max(int(cnt[ln_]), 1))
                    scale = acc_t(1) / (n if combiner == "mean"
                                        else np.sqrt(n))
                out[b0 + bl[ln_], cols[ln_]] = acc[ln_] * scale
    return out, reads


def rounded(out, dtype):
    """The emulation's output rounded once into ``dtype``, as f64."""
    return torch.from_numpy(out).to(getattr(torch, dtype)).double().numpy()


def mass(table, ids, combiner, pad_id):
    """The summed magnitude of each output element's terms, scaled."""
    t = torch.from_numpy(np.abs(table).astype(np.float64))
    return teb.embedding_bag_reference(t, torch.from_numpy(ids), combiner,
                                       pad_id).numpy()


def check(got, want, dtype, scale_of_terms):
    tol = RTOL[dtype] * np.abs(want) + F32_TOL * scale_of_terms
    err = np.abs(got - want)
    assert np.all(err <= tol), (float(err.max()),
                                float((err / np.maximum(tol, 1e-30)).max()))


def check_reads(reads, ids, pad_id):
    live = np.ones(ids.shape, bool) if pad_id is None else ids != pad_id
    assert np.array_equal(reads, np.broadcast_to(
        live[..., None].astype(np.int64), reads.shape))


@pytest.mark.parametrize("nnz", NNZS)
@pytest.mark.parametrize("dim", DIMS)
def test_emulation_matches_the_jax_reference_and_the_plain_version(dim, nnz):
    """Every D and N, each table type, combiner and pad id: the emulation
    against the port's plain version and, on in-range ids, the JAX
    reference; every live (slot, column) read once.  Half the cases clip
    out-of-range ids and half place the table one element off 16 bytes
    (narrower pieces, so another lane map)."""
    rs = np.random.RandomState(dim * 101 + nnz)
    for i, (dtype, combiner, pad_id) in enumerate(
            (d, c, p) for d in DTYPES for c in teb.COMBINERS
            for p in (0, None)):
        t, wide = table_of(rs, VOCAB, dim, dtype)
        clip, address = i % 2 == 1, t.element_size() * (i // 2 % 2)
        ids = ids_of(rs, BAGS, nnz, pad_id, clip)
        out, reads = emulate(wide, ids, combiner, pad_id,
                             t.element_size(), address)
        check_reads(reads, ids, pad_id)
        terms = mass(wide, ids, combiner, pad_id)
        plain = teb.embedding_bag_reference(t, torch.from_numpy(ids),
                                            combiner, pad_id)
        check(rounded(out, dtype), plain.double().numpy(), dtype, terms)
        if not clip:
            want = jeb.embedding_bag_reference(
                jnp.asarray(wide).astype(getattr(jnp, dtype)),
                jnp.asarray(ids), combiner, pad_id)
            check(rounded(out, dtype), np.asarray(want).astype(np.float64),
                  dtype, terms)


# (N, table type, combiner, pad id) of each interpret-mode call
PALLAS_CASES = [(1, "float32", "sum", None), (1, "bfloat16", "mean", 0),
                (1, "float16", "sqrtn", None), (3, "float32", "mean", 0),
                (3, "bfloat16", "sqrtn", None), (3, "float16", "sum", 0),
                (32, "float32", "sum", None), (33, "float32", "mean", 0),
                (100, "float32", "sqrtn", 0)]


@pytest.mark.parametrize("nnz,dtype,combiner,pad_id", PALLAS_CASES)
def test_emulation_matches_the_pallas_kernel(nnz, dtype, combiner, pad_id):
    """The emulation against the JAX Pallas ``_fwd_kernel`` in interpret
    mode at every D (the first D columns of one D = 130 call), out-of-range
    ids included, aligned and one element off 16 bytes."""
    rs = np.random.RandomState(nnz * 7 + len(dtype))
    t, wide = table_of(rs, VOCAB, max(DIMS), dtype)
    ids = ids_of(rs, BAGS, nnz, pad_id, clip=True)
    got = jeb.embedding_bag(jnp.asarray(wide).astype(getattr(jnp, dtype)),
                            jnp.asarray(ids), combiner, pad_id=pad_id,
                            interpret=True)
    assert str(got.dtype) == dtype
    got = np.asarray(got).astype(np.float64)
    for dim in DIMS:
        part = np.ascontiguousarray(wide[:, :dim])
        terms = mass(part, ids, combiner, pad_id)
        for address in (0, t.element_size()):
            out, reads = emulate(part, ids, combiner, pad_id,
                                 t.element_size(), address)
            check_reads(reads, ids, pad_id)
            check(rounded(out, dtype), got[:, :dim], dtype, terms)


@pytest.mark.parametrize("dim", DIMS)
def test_f64_tables_sum_in_f64(dim):
    """An f64 table's instance adds in f64: the emulation equals the
    plain version (f64 sums) to 1e-13 of the terms."""
    rs = np.random.RandomState(dim)
    t, wide = table_of(rs, VOCAB, dim, "float64")
    ids = ids_of(rs, BAGS, 33, 0, clip=True)
    out, reads = emulate(wide, ids, "sqrtn", 0, 8)
    check_reads(reads, ids, 0)
    plain = teb.embedding_bag_reference(t, torch.from_numpy(ids), "sqrtn", 0)
    assert np.all(np.abs(out - plain.numpy())
                  <= 1e-13 * mass(wide, ids, "sqrtn", 0))


@pytest.mark.parametrize("elem,dim,address,piece", [
    (4, 64, 0, 16), (4, 20, 0, 16), (4, 5, 0, 4), (4, 6, 0, 8),
    (4, 64, 4, 4), (4, 64, 8, 8), (2, 64, 0, 16), (2, 3, 0, 2),
    (2, 4, 0, 8), (2, 64, 2, 2), (8, 3, 0, 8), (8, 64, 8, 8),
    (8, 64, 0, 16)])
def test_piece_bytes(elem, dim, address, piece):
    """16-byte loads unless the row's bytes or the table's address are
    off 16 bytes; then the widest piece that divides both."""
    assert teb.piece_bytes(elem, dim, address) == piece


@pytest.mark.parametrize("dim,elem,piece,nnz,want", [
    (64, 4, 16, 32, (16, 16, 2, 2, 1)),      # bench f32: 2 groups
    (64, 2, 16, 32, (8, 8, 4, 4, 1)),        # bench bf16: 4 groups
    (20, 4, 16, 1, (5, 5, 6, 1, 6)),         # NCF: 6 bags of one slot
    (20, 4, 16, 4, (5, 5, 6, 4, 1)),         # 4 slots: 2 groups idle
    (130, 4, 8, 33, (65, 32, 1, 1, 1)),      # wider than 32 pieces
    (1, 4, 4, 3, (1, 1, 32, 3, 10)),
    (5, 4, 4, 0, (5, 5, 6, 1, 6))])          # no slots
def test_bag_layout(dim, elem, piece, nnz, want):
    assert tuple(teb.bag_layout(dim, elem, piece, nnz)) == want
