"""The flash-attention forward kernel's numeric contract
(``analytics_zoo_tpu_torch/csrc/flash_attention.cu``) against the JAX
package's Pallas forward, on the CPU.

The kernel cannot run here, so a test-local helper does its arithmetic in
numpy: the online softmax over 64-key tiles with the TPU kernel's
constants, and its two product schemes on the tensor cores --

- f32 inputs, split-TF32: each operand x is split as x_hi = tf32(x),
  x_lo = tf32(x - x_hi), where tf32 rounds to nearest with ties away from
  zero to a 10-bit mantissa (``cvt.rna.tf32.f32``), and a.b is taken as
  a_hi.b_hi + a_hi.b_lo + a_lo.b_hi, each term exact and summed in f32;
  q is scaled by sm_scale before the split;
- bf16 inputs: q.k exact (bf16 products fit in f32), scaled in f32
  afterwards; p enters P.V as bf16(p) + bf16(p - bf16(p)) against the
  exact bf16 v --

and both are held against ``_flash_fwd(..., interpret=True)`` (out and
lse).  Tolerances, the kernel's own on the card: f32 out atol 2e-5 + rtol
1e-4, bf16 out atol 8e-3 + rtol 8e-3 (one bf16 rounding of an f32
result), lse atol 2e-5 + rtol 1e-5; rows with no live key exactly 0 with
lse -1e30.  Plain TF32 (one term) and a single bf16 rounding of p both
fail the f32 tolerance, so the tests tell the schemes apart; on bf16
outputs, where both pass the tolerance, the share of outputs that leave
the plain version's bf16 value tells split p from a single rounding.
"""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jfa = importlib.import_module("analytics_zoo_tpu.ops.flash_attention")

NEG_INF = np.float32(-1e30)
BK = 64                                   # the kernel's key tile
F32_TOL = (2e-5, 1e-4)
BF16_TOL = (8e-3, 8e-3)
LSE_TOL = (2e-5, 1e-5)
# The largest share of bf16 outputs that may leave the plain version's
# bf16 value on the card (chip_smoke.py, tests/test_torch_port_cuda.py)
BF16_MISMATCH_LIMIT = 0.02

CASES = [
    # (b, h, lq, lk, d, causal)
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
    """Round f32 to bf16, nearest even, as the kernel's conversions."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return t.to(torch.bfloat16).float().numpy()


def _exact_dot(a, b):
    """a @ b^T of f32 operands whose products are exact in f64, summed in
    f64 and rounded once to f32 (the tensor core's f32 sum, up to
    order)."""
    return np.matmul(a.astype(np.float64),
                     np.swapaxes(b, -1, -2).astype(np.float64))


def _split_dot(a, b, terms):
    """a @ b^T from TF32 splits: 3 terms (split-TF32) or 1 (plain)."""
    ah, bh = tf32(a), tf32(b)
    if terms == 1:
        return _exact_dot(ah, bh).astype(np.float32)
    al, bl = tf32(a - ah), tf32(b - bh)
    return (_exact_dot(al, bh) + _exact_dot(ah, bl)
            + _exact_dot(ah, bh)).astype(np.float32)


def emulate(q, k, v, causal, scheme):
    """The kernel's forward on numpy f32 arrays (bf16-valued for the
    bf16 schemes): ``(out f32, lse f32)``.  scheme: "split_tf32",
    "tf32" (one term), "bf16" (split p), "bf16_single_p" (p rounded
    once)."""
    lq, lk, d = q.shape[-2], k.shape[-2], q.shape[-1]
    scale = np.float32(1.0 / np.sqrt(d))
    m = np.full(q.shape[:-1] + (1,), NEG_INF, np.float32)
    l = np.zeros_like(m)
    acc = np.zeros(q.shape, np.float32)
    qs = (q * scale).astype(np.float32)
    qpos = np.arange(lq)[:, None] + (lk - lq)
    for k0 in range(0, lk, BK):
        kt, vt = k[..., k0:k0 + BK, :], v[..., k0:k0 + BK, :]
        if scheme in ("split_tf32", "tf32"):
            s = _split_dot(qs, kt, 3 if scheme == "split_tf32" else 1)
        else:
            s = (_exact_dot(q, kt).astype(np.float32) * scale)
        kpos = np.arange(k0, k0 + kt.shape[-2])[None, :]
        if causal:
            s = np.where(qpos >= kpos, s, NEG_INF)
        m_new = np.maximum(m, s.max(-1, keepdims=True))
        alpha = np.exp(m - m_new)
        p = np.where(s <= NEG_INF / 2, np.float32(0), np.exp(s - m_new))
        l = l * alpha + p.sum(-1, keepdims=True, dtype=np.float32)
        if scheme == "split_tf32":
            pv = _split_dot(p, np.swapaxes(vt, -1, -2), 3)
        elif scheme == "tf32":
            pv = _split_dot(p, np.swapaxes(vt, -1, -2), 1)
        elif scheme == "bf16":
            p_hi = bf16(p)
            pv = (_exact_dot(bf16(p - p_hi), np.swapaxes(vt, -1, -2))
                  + _exact_dot(p_hi, np.swapaxes(vt, -1, -2))
                  ).astype(np.float32)
        else:
            pv = _exact_dot(bf16(p), np.swapaxes(vt, -1, -2)).astype(
                np.float32)
        acc = acc * alpha + pv
        m = m_new
    denom = np.maximum(l, np.float32(1e-20))
    return (acc / denom).astype(np.float32), (m + np.log(denom))[..., 0]


def _inputs(b, h, lq, lk, d, seed, as_bf16=False):
    rs = np.random.RandomState(seed)
    arrays = [rs.randn(b, h, n, d).astype(np.float32) for n in (lq, lk, lk)]
    return [bf16(a) for a in arrays] if as_bf16 else arrays


@functools.lru_cache(maxsize=None)
def _jax(case, dtype):
    """The Pallas forward with lse in interpret mode on the case's inputs
    (bf16-valued inputs for "bf16", passed as bf16 or as f32):
    ``(inputs, out f32, lse)``."""
    b, h, lq, lk, d, causal = case
    xs = _inputs(b, h, lq, lk, d, seed=lq + 7 * lk + d,
                 as_bf16=dtype != "float32")
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    out, lse = jfa._flash_fwd(*(jnp.asarray(x, jdt) for x in xs),
                              1.0 / np.sqrt(d), causal, 128, 128, True,
                              with_lse=True)
    return xs, np.asarray(out, np.float32), np.asarray(lse, np.float32)


def _violation(got, want, tol):
    """max |got - want| / (atol + rtol |want|): above 1 fails."""
    atol, rtol = tol
    return float(np.max(np.abs(got - want) / (atol + rtol * np.abs(want))))


def _check_lse_and_dead_rows(out, lse, want_lse, case):
    b, h, lq, lk, d, causal = case
    live = want_lse > NEG_INF / 2
    assert _violation(lse[live], want_lse[live], LSE_TOL) <= 1
    assert np.all(lse[~live] <= NEG_INF / 2)
    if causal and lq > lk:
        assert not np.any(out[..., :lq - lk, :])
        assert not np.any(live[..., :lq - lk])


@pytest.mark.parametrize("case", CASES)
def test_split_tf32_matches_jax_f32(case):
    """f32 inputs: split-TF32 products with the online softmax over
    64-key tiles agree with the Pallas kernel at the f32 tolerance."""
    (q, k, v), want, want_lse = _jax(case, "float32")
    out, lse = emulate(q, k, v, case[-1], "split_tf32")
    assert _violation(out, want, F32_TOL) <= 1
    _check_lse_and_dead_rows(out, lse, want_lse, case)


@pytest.mark.parametrize("case", CASES)
def test_bf16_split_p_matches_jax_bf16(case):
    """bf16 inputs: exact q.k, f32 scale, p as hi + lo bf16 terms; out
    rounded to bf16 agrees with the Pallas kernel's bf16 out at the bf16
    tolerance, and lse at the lse tolerance."""
    (q, k, v), want, want_lse = _jax(case, "bfloat16")
    out, lse = emulate(q, k, v, case[-1], "bf16")
    assert _violation(bf16(out), want, BF16_TOL) <= 1
    _check_lse_and_dead_rows(out, lse, want_lse, case)


@pytest.mark.parametrize("case", CASES)
def test_bf16_split_p_keeps_the_f32_p_of_the_tpu_kernel(case):
    """Before the output's bf16 rounding, the split-p result matches the
    Pallas kernel run in f32 on the same bf16 values at the f32
    tolerance: p.v is the TPU kernel's f32 p times v."""
    (q, k, v), want, _ = _jax(case, "bf16_values")
    out, _ = emulate(q, k, v, case[-1], "bf16")
    assert _violation(out, want, F32_TOL) <= 1


def test_plain_tf32_and_single_rounded_p_fail_the_f32_tolerance():
    """The schemes are told apart: one TF32 term per product, or p
    rounded once to bf16 (FlashAttention-2's P.V), misses the f32
    tolerance by more than 2x where the kernel's schemes pass."""
    case = (1, 2, 128, 128, 128, False)
    (q, k, v), want, _ = _jax(case, "float32")
    assert _violation(emulate(q, k, v, False, "split_tf32")[0], want,
                      F32_TOL) <= 1
    assert _violation(emulate(q, k, v, False, "tf32")[0], want,
                      F32_TOL) > 2
    (q, k, v), want, _ = _jax(case, "bf16_values")
    assert _violation(emulate(q, k, v, False, "bf16")[0], want,
                      F32_TOL) <= 1
    assert _violation(emulate(q, k, v, False, "bf16_single_p")[0], want,
                      F32_TOL) > 2


@pytest.mark.parametrize("case", [(1, 2, 128, 128, 64, False),
                                  (1, 2, 96, 150, 72, True)])
def test_bf16_mismatch_share_tells_split_p_from_single_p(case):
    """The card's bf16 check holds the share of outputs whose bf16 value
    differs from the plain version's (an f32 result rounded once) to
    BF16_MISMATCH_LIMIT: split p stays far below it, p rounded once goes
    far above it, though both pass the bf16 tolerance."""
    (q, k, v), want, _ = _jax(case, "bf16_values")
    plain = bf16(want)

    def share(scheme):
        got = bf16(emulate(q, k, v, case[-1], scheme)[0])
        assert _violation(got, plain, BF16_TOL) <= 1
        return float(np.mean(got != plain))

    assert share("bf16") < BF16_MISMATCH_LIMIT / 4
    assert share("bf16_single_p") > 4 * BF16_MISMATCH_LIMIT


def test_tf32_rounds_to_nearest_ties_away():
    """``tf32`` is cvt.rna: 13 low bits cleared, halfway cases away from
    zero, carries into the exponent."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    x = np.array([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                  np.float32(2.0) - ulp / 2, 3.0], np.float32)
    assert tf32(x).tolist() == [one + ulp, -(one + ulp), one, 2.0, 3.0]
    assert not np.any(tf32(np.random.RandomState(0).randn(64).astype(
        np.float32)).view(np.uint32) & 0x1FFF)
