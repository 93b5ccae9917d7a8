"""The flash-attention backward kernels' numeric contract
(``analytics_zoo_tpu_torch/csrc/flash_attention_bwd.cu``, dQ and dK/dV)
against the JAX package's Pallas backward, on the CPU.

The kernels cannot run here, so a test-local helper does their arithmetic
in numpy, from the same q, k, v, dO and the forward's out and lse:

    s = (sm_scale q) . k,  p = exp(s - lse) (0 where masked),
    dp = dO . v,  ds = p (dp - delta),  delta = rowsum(dO * out) in f32,
    dq = sm_scale ds . k,  dk = sm_scale ds^T . q,  dv = p^T . dO,

with the kernels' two product schemes on the tensor cores --

- f32 inputs, split-TF32 on every product: each operand x is split as
  x_hi = tf32(x), x_lo = tf32(x - x_hi), tf32 rounding to nearest with
  ties away from zero to a 10-bit mantissa (``cvt.rna.tf32.f32``), and
  a.b is a_hi.b_hi + a_hi.b_lo + a_lo.b_hi, each term exact and summed in
  f32; q is scaled by sm_scale before its split in s;
- bf16 inputs: q.k and dO.v exact (bf16 products fit in f32), s scaled in
  f32 afterwards; p and ds enter P^T.dO, dS.K and dS^T.Q as bf16(x) +
  bf16(x - bf16(x)) against the exact bf16 dO, k or q --

and both are held against ``_flash_bwd(..., interpret=True)`` (its
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``) on the forward test's six
shapes.  Tolerances, the kernels' own on the card: f32 atol 2e-5 + rtol
1e-4, bf16 atol 8e-3 + rtol 8e-3 (one bf16 rounding of an f32 result);
query rows with no live key get an exactly zero dQ.  Plain TF32 (one
term) and a single bf16 rounding of dS both fail the f32 tolerance, so
the tests tell the schemes apart; on bf16 gradients, where both pass the
tolerance, the share that leaves the plain version's bf16 value tells
split dS from a single rounding.
"""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jfa = importlib.import_module("analytics_zoo_tpu.ops.flash_attention")

NEG_INF = np.float32(-1e30)
F32_TOL = (2e-5, 1e-4)
BF16_TOL = (8e-3, 8e-3)
# The largest share of bf16 gradients that may leave the plain version's
# bf16 value on the card (chip_smoke.py, tests/test_torch_port_cuda.py)
BF16_MISMATCH_LIMIT = 0.02

CASES = [
    # (b, h, lq, lk, d, causal): the forward numerics test's shapes
    (1, 2, 96, 96, 24, False),
    (1, 2, 64, 150, 24, True),            # causal Lq < Lk
    (2, 1, 130, 70, 64, True),            # causal Lq > Lk: rows with no key
    (1, 2, 128, 128, 64, False),
    (1, 1, 77, 140, 128, True),
    (1, 1, 140, 77, 128, True),
]


def tf32(x):
    """Round f32 to TF32 as ``cvt.rna.tf32.f32``: nearest, ties away from
    zero, 10 mantissa bits (the low 13 bits cleared)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def bf16(x):
    """Round f32 to bf16, nearest even, as the kernels' conversions."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return t.to(torch.bfloat16).float().numpy()


def _exact(a, b):
    """a @ b of f32 operands whose products are exact in f64, summed in
    f64 and rounded once to f32 (the tensor core's f32 sum, up to
    order)."""
    return np.matmul(a.astype(np.float64), b.astype(np.float64)).astype(
        np.float32)


def _split_tf32(a, b, terms):
    """a @ b from TF32 splits: 3 terms (split-TF32) or 1 (plain TF32)."""
    ah, bh = tf32(a), tf32(b)
    if terms == 1:
        return _exact(ah, bh)
    al, bl = tf32(a - ah), tf32(b - bh)
    return (_exact(al, bh).astype(np.float64) + _exact(ah, bl)
            + _exact(ah, bh)).astype(np.float32)


def _split_bf16(x, b):
    """x @ b with f32 x as bf16(x) + bf16(x - bf16(x)) against bf16 b."""
    hi = bf16(x)
    return (_exact(bf16(x - hi), b).astype(np.float64)
            + _exact(hi, b)).astype(np.float32)


def _t(x):
    return np.swapaxes(x, -1, -2)


def emulate_bwd(q, k, v, out, lse, g, causal, scheme):
    """The kernels' backward on numpy f32 arrays (bf16-valued q, k, v, g
    for the bf16 schemes): ``(dq, dk, dv)`` in f32.  scheme: "split_tf32",
    "tf32" (one term per product), "bf16" (split p and ds),
    "bf16_single_ds" (ds rounded once to bf16)."""
    lq, lk, d = q.shape[-2], k.shape[-2], q.shape[-1]
    scale = np.float32(1.0 / np.sqrt(d))
    delta = np.sum(g * out, axis=-1, keepdims=True, dtype=np.float32)
    if scheme in ("split_tf32", "tf32"):
        terms = 3 if scheme == "split_tf32" else 1

        def nt(a, b):
            return _split_tf32(a, _t(b), terms)

        def pn(x, b):
            return _split_tf32(x, b, terms)

        s = nt((q * scale).astype(np.float32), k)
    else:
        def nt(a, b):
            return _exact(a, _t(b))

        def pn(x, b, single=False):
            return _exact(bf16(x), b) if single else _split_bf16(x, b)

        s = (nt(q, k) * scale).astype(np.float32)
    if causal:
        qpos = np.arange(lq)[:, None] + (lk - lq)
        s = np.where(qpos >= np.arange(lk)[None, :], s, NEG_INF)
    p = np.where(s <= NEG_INF / 2, np.float32(0),
                 np.exp(s - lse[..., None])).astype(np.float32)
    ds = (p * (nt(g, v) - delta)).astype(np.float32)
    kw = {"single": True} if scheme == "bf16_single_ds" else {}
    dq = scale * pn(ds, k, **kw)
    dk = scale * pn(_t(ds), q, **kw)
    dv = pn(_t(p), g)
    return dq, dk, dv


def _inputs(b, h, lq, lk, d, seed, as_bf16):
    rs = np.random.RandomState(seed)
    arrays = [rs.randn(b, h, n, d).astype(np.float32)
              for n in (lq, lk, lk, lq)]
    return [bf16(a) for a in arrays] if as_bf16 else arrays


@functools.lru_cache(maxsize=None)
def _jax(case, dtype):
    """The Pallas forward with lse, then the Pallas backward, in interpret
    mode on the case's inputs (bf16-valued for "bfloat16" and
    "bf16_values", passed as bf16 or as f32): ``(q, k, v, g, out, lse,
    (dq, dk, dv))`` as f32 numpy arrays."""
    b, h, lq, lk, d, causal = case
    q, k, v, g = _inputs(b, h, lq, lk, d, seed=3 * lq + lk + d,
                         as_bf16=dtype != "float32")
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jq, jk, jv, jg = (jnp.asarray(x, jdt) for x in (q, k, v, g))
    scale = 1.0 / np.sqrt(d)
    out, lse = jfa._flash_fwd(jq, jk, jv, scale, causal, 128, 128, True,
                              with_lse=True)
    grads = jfa._flash_bwd(jq, jk, jv, out, lse, jg, scale, causal, 128, 128,
                           True)
    return (q, k, v, g, np.asarray(out, np.float32),
            np.asarray(lse, np.float32),
            tuple(np.asarray(x, np.float32) for x in grads))


def _violation(got, want, tol):
    """max |got - want| / (atol + rtol |want|): above 1 fails."""
    atol, rtol = tol
    return float(np.max(np.abs(got - want) / (atol + rtol * np.abs(want))))


def _emulated(case, dtype, scheme):
    q, k, v, g, out, lse, want = _jax(case, dtype)
    return emulate_bwd(q, k, v, out, lse, g, case[-1], scheme), want


def _check_dead_rows(dq, case):
    b, h, lq, lk, d, causal = case
    if causal and lq > lk:
        assert not np.any(dq[..., :lq - lk, :])


@pytest.mark.parametrize("case", CASES)
def test_split_tf32_bwd_matches_jax_f32(case):
    """f32 inputs: split-TF32 on all five products gives the Pallas
    kernels' dq, dk and dv at the f32 tolerance; rows with no live key
    get an exactly zero dq."""
    got, want = _emulated(case, "float32", "split_tf32")
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert _violation(x, y, F32_TOL) <= 1, name
    _check_dead_rows(got[0], case)


@pytest.mark.parametrize("case", CASES)
def test_bf16_split_bwd_matches_jax_bf16(case):
    """bf16 inputs: exact q.k and dO.v, f32 scale, split p and ds; the
    gradients rounded to bf16 agree with the Pallas kernels' bf16
    gradients at the bf16 tolerance."""
    got, want = _emulated(case, "bfloat16", "bf16")
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert _violation(bf16(x), y, BF16_TOL) <= 1, name
    _check_dead_rows(bf16(got[0]), case)


@pytest.mark.parametrize("case", CASES)
def test_bf16_split_bwd_keeps_the_f32_products_of_the_tpu_kernel(case):
    """Before the gradients' bf16 rounding, the bf16 scheme matches the
    Pallas kernels run in f32 on the same bf16 values at the f32
    tolerance: split p and ds keep the TPU kernels' f32 products."""
    got, want = _emulated(case, "bf16_values", "bf16")
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert _violation(x, y, F32_TOL) <= 1, name


def test_plain_tf32_and_single_rounded_ds_fail_the_f32_tolerance():
    """The schemes are told apart: one TF32 term per product, or ds
    rounded once to bf16, misses the f32 tolerance by more than 2x where
    the kernels' schemes pass."""
    case = (1, 2, 128, 128, 64, False)
    for dtype, good, bad in (("float32", "split_tf32", "tf32"),
                             ("bf16_values", "bf16", "bf16_single_ds")):
        ok, want = _emulated(case, dtype, good)
        off, _ = _emulated(case, dtype, bad)
        assert max(_violation(x, y, F32_TOL)
                   for x, y in zip(ok, want)) <= 1, good
        # dq and dk take ds; dv takes only p, which both bf16 schemes split
        assert min(_violation(x, y, F32_TOL)
                   for x, y in zip(off[:2], want[:2])) > 2, bad


@pytest.mark.parametrize("case", [(1, 2, 128, 128, 64, False),
                                  (1, 1, 77, 140, 128, True)])
def test_bf16_mismatch_share_tells_split_ds_from_single_ds(case):
    """The card's bf16 check holds the share of gradients whose bf16 value
    differs from the plain version's (an f32 result rounded once) to
    BF16_MISMATCH_LIMIT: split ds stays far below it, ds rounded once goes
    far above it, though both pass the bf16 tolerance."""
    q, k, v, g, out, lse, want = _jax(case, "bf16_values")
    plain = [bf16(x) for x in want]

    def shares(scheme):
        got = [bf16(x) for x in emulate_bwd(q, k, v, out, lse, g, case[-1],
                                            scheme)]
        for x, y in zip(got, plain):
            assert _violation(x, y, BF16_TOL) <= 1
        return [float(np.mean(x != y)) for x, y in zip(got, plain)]

    assert max(shares("bf16")) < BF16_MISMATCH_LIMIT / 4
    assert min(shares("bf16_single_ds")[:2]) > 4 * BF16_MISMATCH_LIMIT
