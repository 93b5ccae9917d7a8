"""The dequantize-matmul kernel's numeric contract
(``analytics_zoo_tpu_torch/csrc/dequant_matmul.cu``) against the JAX
package's Pallas kernel, on the CPU.

The kernel cannot run here, so test-local helpers do its arithmetic in
numpy:

- the weight widening: int8 bytes and int4 nibbles turned into bf16 or
  f16 pairs by the kernel's bit tricks (``mma_tiles.cuh``), bit by bit;
- one warp's m16n8k16 step as ``dq_mma`` lays it out: the weight
  fragments from ``ldmatrix.trans`` on the byte tile (int4 with its
  permuted k order), the x fragments as the kernel reads them, the
  products in the PTX fragment layout, and the epilogue's even/odd
  column mapping back to the output; and ``dq_wgmma``'s register A
  operand, which must be W's columns transposed in k order;
- the whole product: f32 x split into three bf16 pieces x0 + x1 + x2
  (bf16 and f16 x taken as they are), exact products with the exact
  integer weights, summed 16 k at a time into an f32 accumulator with
  one f32 rounding per tensor-core step (small pieces first), the scale
  applied once at the end, the result rounded to x's type.

The emulation is held against ``dequant_matmul(..., interpret=True)``.
Tolerances: f32 max |err| <= 4e-6 * max |jax| (f32 sums in another
order: three accumulator roundings per 16 k here, XLA's order there;
measured 1.1e-6 at K = 4096); bf16 and f16 |err| <= 2^-7 (2^-10) * |jax|
+ 4e-6 * max |jax| (one rounding of an f32 result to x's type, which may
land one unit apart, on top of the f32 difference).  The chip's own
tolerance is max |err| <= 1e-4 * max |plain|.

What the split buys.  x0 alone misses the chip's tolerance at K = 4096
(about 2e-3 of the largest output), so a split is needed.  Dropping the
smallest piece x2 (x kept to 16 bits) cannot miss that tolerance: at
K = 4096 it leaves about 2e-6 of the largest output, and on an H100 the
tensor cores' accumulation, not the split, sets the error there (about
1e-5 with two pieces or three).  It shows at short K: at NCF's K = 40
two pieces leave over ten times the error of three against the exact
product here, and on the card a two-piece kernel missed the served NCF
model's 1e-5 check against the plain path (PERF.md).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jdq = importlib.import_module("analytics_zoo_tpu.ops.dequant_matmul")
from analytics_zoo_tpu_torch.ops import dequant_matmul as tdq  # noqa: E402

F32_TOL = 4e-6
HALF_RTOL = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}
CHIP_TOL = 1e-4


def to_bf16(a):
    """Round f32 to bf16 (nearest even), back as f32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def pieces(x, n=3):
    """f32 x as n bf16 pieces, largest first; each difference is exact."""
    out, r = [], np.asarray(x, np.float32)
    for _ in range(n):
        p = to_bf16(r)
        out.append(p)
        r = (r - p).astype(np.float32)
    return out


def emulate(x, w, scale, dtype, n_pieces=3):
    """The kernel's arithmetic: ``x`` (M, K) in ``dtype`` (given as f32
    values), ``w`` (K, N) integer weights, ``scale`` (N,) f32."""
    xs = pieces(x, n_pieces) if dtype == "float32" else [x]
    m, k = x.shape
    kp = -(-k // 16) * 16
    xs = [np.pad(p, ((0, 0), (0, kp - k))).astype(np.float64) for p in xs]
    wp = np.pad(w, ((0, kp - k), (0, 0))).astype(np.float64)
    acc = np.zeros((m, w.shape[1]), np.float32)
    for k0 in range(0, kp, 16):
        for p in reversed(xs):            # small pieces first
            acc = (acc + p[:, k0:k0 + 16] @ wp[k0:k0 + 16]).astype(np.float32)
    return (acc * scale).astype(np.float32)


def round_to(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype)).float().numpy()


def inputs(m, k, n, bits, dtype, seed):
    rs = np.random.RandomState(seed)
    x = round_to(rs.randn(m, k).astype(np.float32), dtype)
    q, s = jdq.quantize_weights(rs.randn(k, n).astype(np.float32), bits=bits)
    q, s = np.asarray(q), np.asarray(s).reshape(-1)
    w = (np.asarray(jdq.unpack_int4(q, k)) if bits == 4 else q).astype(
        np.float64)
    return x, q, s, w


def jax_dq(x, q, s, bits, k, dtype):
    out = jdq.dequant_matmul(jnp.asarray(x).astype(getattr(jnp, dtype)), q,
                             s, bits=bits, rows=k, interpret=True)
    assert str(out.dtype) == dtype
    return np.asarray(out.astype(jnp.float32))


# ---------------------------------------------------------------------------
# the weight widening, bit by bit


def byte_perm(x, y, s):
    """``__byte_perm``: byte i of the result is byte (s >> 4i) & 7 of
    y:x."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + \
        [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(src[(s >> (4 * i)) & 7] << (8 * i) for i in range(4))


def halves(bits32, kind):
    """The two 16-bit halves of a register as floats, low first."""
    h = np.array([bits32 & 0xFFFF, bits32 >> 16], np.uint16)
    if kind == "bf16":
        return (h.astype(np.uint32) << 16).view(np.float32).astype(np.float64)
    return h.view(np.float16).astype(np.float64)


def u8x2(u, sel, kind):
    """``u8x2_to_bf16x2<SEL>`` / ``u8x2_to_f16x2<SEL>`` on biased bytes."""
    if kind == "bf16":
        vals = [np.array([byte_perm(u, 0x4B000000, 0x7440 + sel + 2 * i)],
                         np.uint32).view(np.float32)[0] - np.float32(8388736)
                for i in range(2)]
        return [float(to_bf16(np.float32(v))[0]) for v in vals]
    h = halves(byte_perm(u, 0x64646464, 0x4240 + sel * 0x101), "f16")
    return list((h - 1152).astype(np.float16).astype(np.float64))


def u4x2(u, sh, kind):
    """``u4x2_to_bf16x2<SH>`` / ``u4x2_to_f16x2<SH>`` on biased nibbles."""
    base, bias = (0x43004300, 136) if kind == "bf16" else (0x64006400, 1032)
    h = halves(((u >> sh) & 0x000F000F) | base, kind)
    out = h * 1.0 - bias
    dt = np.float16 if kind == "f16" else np.float32
    return list(out.astype(dt).astype(np.float64))


@pytest.mark.parametrize("kind", ["bf16", "f16"])
def test_weight_widening_is_exact(kind):
    """Every int8 byte and int4 nibble, at every position of a register,
    widens to its exact value."""
    for v0 in range(-128, 128):
        v2 = -v0 - 1                      # the other byte of the pair
        r = ((v0 & 0xFF) | ((v0 & 0xFF) << 8) | ((v2 & 0xFF) << 16)
             | ((v2 & 0xFF) << 24))
        u = r ^ 0x80808080
        for sel in (0, 1):
            assert u8x2(u, sel, kind) == [v0, v2]
    for n0 in range(-8, 8):
        nib = [n0, -n0 - 1, (n0 + 3) % 16 - 8, (5 - n0) % 16 - 8]
        # byte 0 = (nib0 lo, nib1 hi), byte 1 = (nib2, nib3), bytes 2, 3
        # the same reversed
        b = [(nib[0] & 0xF) | ((nib[1] & 0xF) << 4),
             (nib[2] & 0xF) | ((nib[3] & 0xF) << 4),
             (nib[3] & 0xF) | ((nib[2] & 0xF) << 4),
             (nib[1] & 0xF) | ((nib[0] & 0xF) << 4)]
        u = (b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24)) ^ 0x88888888
        assert u4x2(u, 0, kind) == [nib[0], nib[3]]     # lo nibbles 0, 2
        assert u4x2(u, 4, kind) == [nib[1], nib[2]]     # hi nibbles 0, 2
        assert u4x2(u, 8, kind) == [nib[2], nib[1]]     # lo nibbles 1, 3
        assert u4x2(u, 12, kind) == [nib[3], nib[0]]    # hi nibbles 1, 3


# ---------------------------------------------------------------------------
# one warp's k16 step, in the kernel's fragment layout


def ldmatrix_trans(tile, rows):
    """``ldmatrix.m8n8.trans.b16`` of one 8x8 matrix of 16-bit pairs of
    bytes: ``rows`` are the 8 tile rows the lanes name; lane 4g + t gets
    the bytes of rows 2t and 2t+1 at b16 column g, as one register."""
    regs = []
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        lo, hi = tile[rows[2 * t], 2 * g:2 * g + 2], \
            tile[rows[2 * t + 1], 2 * g:2 * g + 2]
        b = [int(v) & 0xFF for v in (lo[0], lo[1], hi[0], hi[1])]
        regs.append(b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24))
    return regs


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_fragment_layout_computes_the_product(bits, dtype):
    """A warp's 16 x 16 output (two n8 tiles of even and odd columns)
    from one k16 step, built from the registers the kernel forms, equals
    x . w of the same 16 rows, 16 k and 16 columns."""
    rs = np.random.RandomState(bits)
    x = round_to(rs.randn(16, 16).astype(np.float32), dtype)
    lim = 127 if bits == 8 else 7
    w = rs.randint(-lim - 1 if bits == 4 else -lim, lim + 1, (16, 16))
    kind = "f16" if dtype == "float16" else "bf16"
    # weight registers per lane: src0 (and src1 for int8)
    if bits == 8:
        src = [ldmatrix_trans(w, list(range(8))),
               ldmatrix_trans(w, list(range(8, 16)))]
    else:
        packed = np.asarray(tdq.pack_int4(torch.from_numpy(
            w.astype(np.int8)))).astype(np.int64)
        src = [ldmatrix_trans(packed, list(range(8)))]
    a_virt = np.full((2, 16, 16), np.nan)     # per parity (the same A)
    b_virt = np.full((2, 16, 8), np.nan)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        # B: registers b[p][i] of the n8 tile of parity p
        if bits == 8:
            u0, u1 = src[0][lane] ^ 0x80808080, src[1][lane] ^ 0x80808080
            b = [[u8x2(u0, p, kind), u8x2(u1, p, kind)] for p in (0, 1)]
        else:
            u = src[0][lane] ^ 0x88888888
            b = [[u4x2(u, 8 * p, kind), u4x2(u, 8 * p + 4, kind)]
                 for p in (0, 1)]
        for p in (0, 1):
            b_virt[p, 2 * t:2 * t + 2, g] = b[p][0]
            b_virt[p, 2 * t + 8:2 * t + 10, g] = b[p][1]
        # A: the x columns the kernel reads for mma k 2t, 2t+1, 2t+8, 2t+9
        cols = ([2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9] if bits == 8 else
                [4 * t, 4 * t + 2, 4 * t + 1, 4 * t + 3])
        for h in (0, 1):
            a_virt[:, g + 8 * h, [2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9]] = \
                x[g + 8 * h, cols]
    assert not np.isnan(a_virt).any() and not np.isnan(b_virt).any()
    got = np.zeros((16, 16))
    for p in (0, 1):
        c = a_virt[p] @ b_virt[p]             # (16, 8): C layout
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            # c0, c1 (row g, mma columns 2t, 2t+1) -> output columns
            # 4t + p and 4t + 2 + p; c2, c3 the same of row g + 8
            for h in (0, 1):
                got[g + 8 * h, 4 * t + p] = c[g + 8 * h, 2 * t]
                got[g + 8 * h, 4 * t + 2 + p] = c[g + 8 * h, 2 * t + 1]
    np.testing.assert_array_equal(got, x.astype(np.float64) @ w)


def u4pair(u, b, kind):
    """``u4pair_to_bf16x2<B>`` / ``u4pair_to_f16x2<B>``: byte b's low and
    high nibbles (biased) -> two values, the low nibble first."""
    base, bias = (0x43004300, 136) if kind == "bf16" else (0x64006400, 1032)
    x = byte_perm(u, 0, 0x4040 | b | (b << 8))
    h = halves((x & 0x0000000F) | ((x >> 4) & 0x000F0000) | base, kind)
    dt = np.float16 if kind == "f16" else np.float32
    return list((h * 1.0 - bias).astype(dt).astype(np.float64))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("kind", ["bf16", "f16"])
def test_wgmma_weight_fragments_are_w_transposed(bits, kind):
    """dq_wgmma's register A operand for one warp and k16 step: rows g and
    g + 8 of the 16 x 16 A are W's columns 2g and 2g + 1, in k order (the
    x operand's k order is fixed), for int8 and for int4 with ldmatrix
    naming the packed rows 0, 4, 1, 5, 2, 6, 3, 7."""
    rs = np.random.RandomState(bits)
    lim = 127 if bits == 8 else 7
    w = rs.randint(-lim - 1 if bits == 4 else -lim, lim + 1, (16, 16))
    a_virt = np.full((16, 16), np.nan)
    if bits == 8:
        src = [ldmatrix_trans(w, list(range(8))),
               ldmatrix_trans(w, list(range(8, 16)))]
    else:
        packed = np.asarray(tdq.pack_int4(torch.from_numpy(
            w.astype(np.int8)))).astype(np.int64)
        src = [ldmatrix_trans(packed, [0, 4, 1, 5, 2, 6, 3, 7])]
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        if bits == 8:
            lo, hi = src[0][lane] ^ 0x80808080, src[1][lane] ^ 0x80808080
            a = [u8x2(lo, 0, kind), u8x2(lo, 1, kind), u8x2(hi, 0, kind),
                 u8x2(hi, 1, kind)]
        else:
            u = src[0][lane] ^ 0x88888888
            a = [u4pair(u, b, kind) for b in range(4)]
        a_virt[g, 2 * t:2 * t + 2] = a[0]
        a_virt[g + 8, 2 * t:2 * t + 2] = a[1]
        a_virt[g, 2 * t + 8:2 * t + 10] = a[2]
        a_virt[g + 8, 2 * t + 8:2 * t + 10] = a[3]
    np.testing.assert_array_equal(a_virt[:8], w[:, 0::2].T)
    np.testing.assert_array_equal(a_virt[8:], w[:, 1::2].T)


# ---------------------------------------------------------------------------
# the whole product against the JAX kernel

CASES = [
    # (m, k, n, bits, dtype)
    (1, 40, 40, 8, "float32"),
    (65, 41, 70, 8, "float32"),
    (65, 41, 70, 4, "float32"),           # odd K int4
    (33, 77, 9, 4, "float32"),
    (130, 96, 136, 8, "bfloat16"),
    (37, 63, 24, 4, "bfloat16"),          # odd K int4
    (130, 96, 136, 8, "float16"),
    (37, 63, 24, 4, "float16"),
]


def check(got, want, dtype):
    top = np.abs(want).max()
    if dtype == "float32":
        assert np.abs(got - want).max() <= F32_TOL * top
    else:
        assert np.all(np.abs(got - want)
                      <= HALF_RTOL[dtype] * np.abs(want) + F32_TOL * top)


@pytest.mark.parametrize("m,k,n,bits,dtype", CASES)
def test_emulation_matches_jax_kernel(m, k, n, bits, dtype):
    x, q, s, w = inputs(m, k, n, bits, dtype, seed=m + k + n + bits)
    want = jax_dq(x, q, s, bits, k, dtype)
    got = emulate(x, w, s, dtype)
    if dtype != "float32":
        got = round_to(got, dtype)
    check(got, want, dtype)


def split_errors(m, k, n, seed):
    """Max |err| against the exact product, over the largest output, of
    the emulation with 3, 2 and 1 pieces; and the inputs."""
    x, q, s, w = inputs(m, k, n, 8, "float32", seed=seed)
    exact = (x.astype(np.float64) @ w) * s
    top = np.abs(exact).max()
    return {p: np.abs(emulate(x, w, s, "float32", p) - exact).max() / top
            for p in (3, 2, 1)}, (x, q, s, w)


def test_split_pieces_at_k4096():
    """Three pieces hold the f32 tolerance against the JAX kernel at
    K = 4096; x0 alone misses the chip's tolerance there."""
    err, (x, q, s, w) = split_errors(64, 4096, 256, seed=7)
    want = jax_dq(x, q, s, 8, 4096, "float32")
    check(emulate(x, w, s, "float32"), want, "float32")
    assert err[3] <= err[2] <= CHIP_TOL < err[1]
    assert np.abs(emulate(x, w, s, "float32", 1) - want).max() \
        > CHIP_TOL * np.abs(want).max()


def test_smallest_piece_matters_at_ncf_width():
    """At the served NCF model's K = 40 (M = 256, N = 40), dropping x2
    leaves at least 10 times the three pieces' error against the exact
    product."""
    err, (x, q, s, w) = split_errors(256, 40, 40, seed=11)
    check(emulate(x, w, s, "float32"), jax_dq(x, q, s, 8, 40, "float32"),
          "float32")
    assert err[2] >= 10 * err[3]
