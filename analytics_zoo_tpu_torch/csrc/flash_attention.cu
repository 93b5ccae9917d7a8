// Flash-attention forward for Hopper (sm_90a) on the tensor cores, with
// and without the per-row logsumexp.
//
// Replaces the Pallas TPU kernels
// analytics_zoo_tpu/ops/flash_attention.py::_fwd_kernel (LSE = false)
// and ::_fwd_lse_kernel (LSE = true), both launched by _flash_fwd.  For
// each (b, h) and each query row i,
//
//   o[i] = sum_j softmax_j(sm_scale * q[i] . k[j] + mask) * v[j]
//
// and, in the lse instance (the training forward), also
//
//   lse[i] = m[i] + log(max(l[i], 1e-20))
//
// in f32 into a contiguous (B, H, Lq) buffer: the residual the backward
// (flash_attention_bwd.cu) recomputes the probabilities from.  The TPU
// kernel pads that row to 8 sublanes ((BH, 8, Lq), a TPU tile floor);
// here it is one f32 per row.
//
// Numeric contract.  q (B, H, Lq, D) and k, v (B, H, Lk, D) are f32 or
// bf16, out in q's type; the online softmax keeps the running max m, the
// normaliser l and the output accumulator in f32 across key tiles.
//
// - f32 inputs: split-TF32 ("3xTF32", CUTLASS's OpMultiplyAddFastF32, the
//   scheme of aten's f32 memory-efficient attention).  q is scaled by
//   sm_scale in f32 first, as the TPU kernel does; every operand x is
//   split as x_hi = tf32(x), x_lo = tf32(x - x_hi), tf32 being
//   cvt.rna.tf32.f32's rounding (nearest, ties away; done in two integer
//   operations, mma_tiles.cuh), and each product is a_hi.b_hi + a_hi.b_lo
//   + a_lo.b_hi on m16n8k8.tf32 with f32 accumulation: about 21 mantissa
//   bits, within the f32 tolerance (atol 2e-5 + rtol 1e-4) where plain
//   TF32 (11 bits) is not.  P.V uses the same split on the f32
//   probabilities and on v.
// - bf16 inputs: m16n8k16.bf16 with f32 accumulation.  q and k go in as
//   they are, so their products are exact; sm_scale multiplies the f32
//   logits afterwards (exact at D = 64, one f32 rounding otherwise).  The
//   TPU kernel multiplies an f32 p by v, so p goes into P.V as two bf16
//   terms, p_hi = bf16(p) and p_lo = bf16(p - p_hi), against the exact
//   bf16 v: 16 bits of p, where one bf16 rounding (FlashAttention-2's)
//   would keep 8.
// - exp is the hardware's ex2 (relative error about 2^-22), as __expf
//   computes it; exp(x - m) is taken as ex2(x log2e - m log2e).
// - The TPU kernel's constants and rules: masked logits are -1e30 (never
//   -inf, so exp(m_prev - m_new) never sees inf - inf), p is forced to 0
//   where a logit is <= -5e29, l is clamped at 1e-20, and the causal mask
//   is bottom-right aligned (row i sees key j iff i + Lk - Lq >= j).  A
//   row with no live key (causal with Lq > Lk) keeps m = -1e30 and l = 0:
//   it comes out exactly 0, with lse -1e30.
//
// Bound.  Per (b, h) the work is 4 * Lq * Lk * D operations (two
// products; causal: live pairs only) against (2 Lq + 2 Lk) * D elements
// read and written.  For f32 the operations run at the card's f32-accurate
// tensor rate, three TF32 products per product: 495 / 3 = 165 TFLOP/s
// dense; for bf16 at 989 TFLOP/s (this kernel does 1.5x the bf16 work of
// a single-P kernel, for the split P).  At BERT's L = 128, D = 64 the f32
// bytes bound it (32 operations per byte against the card's 49); from
// L = 512 the operations do.  mma.sync reaches a fraction of those rates
// (wgmma with a TMA producer warp is the route to all of it).
//
// Design, and what each choice addresses:
//
// - A block of NW warps per (b*h, query tile); each warp owns MT m-tiles
//   of 16 query rows.  The logits S, the probabilities P and the output
//   accumulator stay in mma fragments in registers: a row's max and sum
//   are two xor shuffles within the lane quad, no P tile goes to shared
//   memory, and no block barrier sits between the softmax and P.V.  The
//   normaliser is summed per lane and reduced once at the end.  Each K or
//   V fragment is loaded (and in f32 split) once for all of a warp's
//   m-tiles.
// - Asynchronous copies: Q is loaded once; K and V tiles go through a ring
//   of two shared stages with 16-byte cp.async.cg, so the next tile is in
//   flight while one is computed, with one block barrier per tile (it
//   also frees the stage the next copy overwrites).  bf16 stays bf16 in
//   shared memory, half the bytes of f32.  Narrower copies (8 or 4 bytes,
//   or plain 2-byte loads for bf16) take strided views whose rows do not
//   start on 16 bytes; the width is chosen per launch from the pointers
//   and strides.
// - Conflict-free fragment reads from padded rows: bf16 rows are DMAX + 8
//   elements (a 16-byte pad), read with ldmatrix (.trans for V); f32 rows
//   are DMAX + 4 floats (4 mod 32 banks), read with scalar loads, since
//   there is no 32-bit ldmatrix.trans.  The f32 P.V needs P as an A
//   fragment, whose layout is not the accumulator's (a lane holds columns
//   2t, 2t+1 of S but t, t+4 of A).  Rather than re-lay P, the kernel
//   permutes the 8 keys of each k-step: A column t is key 2t, column t + 4
//   key 2t + 1, and V's B fragment is read from the same keys, so P.V sums
//   the same terms with no shuffle (the padded stride keeps those V reads
//   conflict-free too).  In bf16 two adjacent n8 accumulator tiles are the
//   A fragment of m16n8k16 as they stand.
// - Straight-line products: the fragment loops have compile-time bounds
//   only (DMAX and the tile's keys), so the compiler schedules loads,
//   splits and mma across the whole tile.  A run-time bound per k-step
//   would cut the loop into blocks it cannot overlap, and both types ran
//   markedly slower so.
// - Registers: Q stays in shared memory in f32 and is split as it is
//   read (its hi and lo fragments would take 128 registers at D = 128);
//   bf16 Q fragments (32 registers at D = 128) are held.
// - D from 1 to 128: DMAX is 64 or 128; the columns from D to DMAX are
//   zeroed once in shared memory (cp.async never writes them) and take
//   part in the products as zeros.  Rows past Lq or Lk are zero-filled by
//   cp.async's src-size, and keys past Lk are masked.
// - Causal: query tiles are scheduled heaviest first (tile index
//   reversed), the key loop ends at the tile's last live key, a warp skips
//   key tiles wholly above its rows, and the mask is evaluated only on key
//   tiles that cross the diagonal or the end of the keys.
// - The block shape (Shape below) was timed against others on the card:
//   f32 at DMAX 64 runs 4 warps x 2 m-tiles with 64-key tiles, and 8 warps
//   x 1 m-tile with 32-key tiles when there are at most 256 keys (the
//   first tile lands sooner); f32 at DMAX 128 8 warps x 1, bf16 4 warps x
//   1, both with 64-key tiles (a third ring stage cost occupancy and
//   gained nothing).  Shared memory, dynamic: 102, 68 and
//   198 KB for those f32 shapes, 45 and 85 KB in bf16, opted in above
//   48 KB once per instance and device.
//
// q, k and v may be strided views (the heads split of MultiHeadAttention
// is a transpose): the (b, h, l) strides are arguments and D must be
// contiguous; out is contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tiles.cuh"

namespace {

using namespace zoo_mma;

constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;   // the TPU kernel's NEG_INF
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

// 2^x, the hardware's approximation (relative error about 2^-22; results
// below 2^-126 flush to 0), as __expf uses it.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Shared row padding, in elements: f32 rows of DMAX + 4 floats sit 4 banks
// apart; bf16 rows of DMAX + 8 put ldmatrix's 8 rows on distinct banks.
template <typename T>
constexpr int kPad = std::is_same<T, float>::value ? 4 : 8;

constexpr int kStages = 2;          // K/V ring stages

// NW warps of MT m-tiles (16 query rows each), K/V tiles of 8 * KN keys
template <typename T, int DMAX, int NW, int MT, int KN>
constexpr size_t smem_bytes() {
  return sizeof(T) * (size_t)(16 * MT * NW + 2 * kStages * 8 * KN) *
         (DMAX + kPad<T>);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

template <typename T>
__device__ __forceinline__ void store_pair(T* p, float a, float b);
template <>
__device__ __forceinline__ void store_pair<float>(float* p, float a,
                                                  float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* p,
                                                          float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// S = (sm_scale * q) . k^T for the warp's MT m-tiles of 16 rows and the
// tile's 8 * KN keys (KN accumulator tiles of 8 keys), split-TF32.  qw: the
// warp's first Q row; kt: the K tile.  Each K fragment is split once and
// used by every m-tile.  The loops have no run-time bounds, so the whole
// product is straight-line code the compiler can schedule: columns past D
// are zero in shared memory, and keys past the end are masked.
template <int DMAX, int MT, int KN>
__device__ __forceinline__ void logits_tf32(float (&s)[MT][KN][4],
                                            const float* qw,
                                            const float* kt, float sm_scale,
                                            int g, int t4) {
  constexpr int S = DMAX + kPad<float>;
#pragma unroll
  for (int kk = 0; kk < DMAX / 8; ++kk) {
    const int c = kk * 8 + t4;
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* qr = qw + (16 * mt + g) * S + c;
      split_tf32(qr[0] * sm_scale, ah[mt][0], al[mt][0]);
      split_tf32(qr[8 * S] * sm_scale, ah[mt][1], al[mt][1]);
      split_tf32(qr[4] * sm_scale, ah[mt][2], al[mt][2]);
      split_tf32(qr[8 * S + 4] * sm_scale, ah[mt][3], al[mt][3]);
    }
#pragma unroll
    for (int n = 0; n < KN; ++n) {
      const float* kr = kt + (n * 8 + g) * S + c;
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(kr[0], bh0, bl0);
      split_tf32(kr[4], bh1, bl1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        mma_3xtf32(s[mt][n], ah[mt], al[mt], bh0, bh1, bl0, bl1);
    }
  }
}

// The same for bf16: q's fragments in registers, K by ldmatrix (one load
// for every m-tile); the exact products are scaled in f32 afterwards.
template <int DMAX, int MT, int KN>
__device__ __forceinline__ void logits_bf16(
    float (&s)[MT][KN][4], const uint32_t (&qf)[MT][DMAX / 16][4],
    const __nv_bfloat16* kt, float sm_scale, int lane) {
  constexpr int S = DMAX + kPad<__nv_bfloat16>;
  const __nv_bfloat16* kl =
      kt + ((lane & 7) + ((lane >> 4) << 3)) * S + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk)
#pragma unroll
    for (int np = 0; np < KN / 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, kl + np * 16 * S + kk * 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(s[mt][2 * np], qf[mt][kk], b[0], b[1]);
        mma_bf16(s[mt][2 * np + 1], qf[mt][kk], b[2], b[3]);
      }
    }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < KN; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[mt][n][c] *= sm_scale;
}

// The online-softmax step of one m-tile on one key tile: masks (MASK: the
// tile crosses the diagonal or the end of the keys), updates the row max m
// and this lane's share of l, rescales the accumulator and turns s into p.
// Lane (g, t) holds rows row_g and row_g + 8, keys kcol + 8 n and
// kcol + 8 n + 1.
template <int DMAX, int KN, bool MASK>
__device__ __forceinline__ void online_softmax(float (&s)[KN][4],
                                               float (&acc)[DMAX / 8][4],
                                               float (&m)[2], float (&l)[2],
                                               int row_g, int kcol, int lk,
                                               int off, int causal) {
  if (MASK) {
#pragma unroll
    for (int n = 0; n < KN; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = kcol + 8 * n + (c & 1);
        const int row = row_g + 8 * (c >> 1);
        if (key >= lk || (causal && row + off < key)) s[n][c] = kNegInf;
      }
  }
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int n = 0; n < KN; ++n) {
    mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
  }
  float alpha[2], ml2[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    alpha[i] = __expf(m[i] - m_new);
    m[i] = m_new;
    ml2[i] = m_new * kLog2e;
  }
#pragma unroll
  for (int n = 0; n < KN; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float x = s[n][c];
      // exp(x - m) as ex2(x log2e - m log2e): one FFMA
      const float e = ex2(fmaf(x, kLog2e, -ml2[c >> 1]));
      const float p = x <= 0.5f * kNegInf ? 0.f : e;
      s[n][c] = p;
      rs[c >> 1] += p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n) {
    acc[n][0] *= alpha[0];
    acc[n][1] *= alpha[0];
    acc[n][2] *= alpha[1];
    acc[n][3] *= alpha[1];
  }
}

// acc += P . V, split-TF32, with the keys of each 8-key step permuted so
// that the accumulator layout of P is its A fragment: A column t is key
// 2t (c0, c2), column t + 4 key 2t + 1 (c1, c3); V's B fragment reads the
// same keys, split once for every m-tile.
template <int DMAX, int MT, int KN>
__device__ __forceinline__ void pv_tf32(float (&acc)[MT][DMAX / 8][4],
                                        const float (&p)[MT][KN][4],
                                        const float* vt, int g, int t4) {
  constexpr int S = DMAX + kPad<float>;
#pragma unroll
  for (int j = 0; j < KN; ++j) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      split_tf32(p[mt][j][0], ah[mt][0], al[mt][0]);
      split_tf32(p[mt][j][2], ah[mt][1], al[mt][1]);
      split_tf32(p[mt][j][1], ah[mt][2], al[mt][2]);
      split_tf32(p[mt][j][3], ah[mt][3], al[mt][3]);
    }
    const float* vr = vt + (j * 8 + 2 * t4) * S + g;
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n) {
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(vr[n * 8], bh0, bl0);      // v[8j + 2t][8n + g]
      split_tf32(vr[S + n * 8], bh1, bl1);  // v[8j + 2t + 1][8n + g]
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        mma_3xtf32(acc[mt][n], ah[mt], al[mt], bh0, bh1, bl0, bl1);
    }
  }
}

// acc += P . V in bf16: two adjacent accumulator tiles are an A fragment;
// p enters as p_hi + p_lo against the exact bf16 V (ldmatrix.trans, one
// load for every m-tile).
template <int DMAX, int MT, int KN>
__device__ __forceinline__ void pv_bf16(float (&acc)[MT][DMAX / 8][4],
                                        const float (&p)[MT][KN][4],
                                        const __nv_bfloat16* vt, int lane) {
  constexpr int S = DMAX + kPad<__nv_bfloat16>;
  const __nv_bfloat16* vl =
      vt + ((lane & 7) + ((lane >> 3) & 1) * 8) * S + (lane >> 4) * 8;
#pragma unroll
  for (int j = 0; j < KN / 2; ++j) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      split_bf16x2(p[mt][2 * j][0], p[mt][2 * j][1], ah[mt][0], al[mt][0]);
      split_bf16x2(p[mt][2 * j][2], p[mt][2 * j][3], ah[mt][1], al[mt][1]);
      split_bf16x2(p[mt][2 * j + 1][0], p[mt][2 * j + 1][1], ah[mt][2],
                   al[mt][2]);
      split_bf16x2(p[mt][2 * j + 1][2], p[mt][2 * j + 1][3], ah[mt][3],
                   al[mt][3]);
    }
#pragma unroll
    for (int np = 0; np < DMAX / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vl + j * 16 * S + np * 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(acc[mt][2 * np], al[mt], b[0], b[1]);
        mma_bf16(acc[mt][2 * np], ah[mt], b[0], b[1]);
        mma_bf16(acc[mt][2 * np + 1], al[mt], b[2], b[3]);
        mma_bf16(acc[mt][2 * np + 1], ah[mt], b[2], b[3]);
      }
    }
  }
}

// DMAX: 64 or 128, the padded head width; NW: warps; MT: m-tiles of 16
// query rows per warp; KN: key tiles of 8 * KN keys; LSE: also write lse.
template <typename T, int DMAX, int NW, int MT, int KN, bool LSE>
__global__ void __launch_bounds__(32 * NW, 1)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o,
          float* __restrict__ lse, int heads, int lq, int lk, int d,
          int64_t sqb, int64_t sqh, int64_t sql, int64_t skb, int64_t skh,
          int64_t skl, int64_t svb, int64_t svh, int64_t svl,
          float sm_scale, int causal, int vec) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int NT = 32 * NW;
  constexpr int ST = kStages;
  constexpr int WR = 16 * MT;         // query rows per warp
  constexpr int BQ = WR * NW;         // query rows per block
  constexpr int kBK = 8 * KN;         // keys per tile
  constexpr int S = DMAX + kPad<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [BQ][S]
  T* ks = qs + BQ * S;                     // [ST][kBK][S]
  T* vs = ks + ST * kBK * S;               // [ST][kBK][S]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int bh = blockIdx.x;
  // causal: the heaviest query tiles (the last) go first
  const int qt = causal ? (int)(gridDim.y - 1 - blockIdx.y) : (int)blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = qt * BQ;
  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh;

  // keys past kend are masked for every row of this tile
  const int off = lk - lq;
  int kend = lk;
  if (causal) kend = min(lk, min(q0 + BQ, lq) + off);
  const int ntiles = kend > 0 ? (kend + kBK - 1) / kBK : 0;

  // K and V tile t into ring stage t % ST, as one cp.async group
  auto load_kv = [&](int t) {
    if (t < ntiles) {
      const int k0 = t * kBK;
      const int at = (t % ST) * kBK * S;
      load_tile<T, S, kBK, NT, DMAX>(ks + at, kb + (int64_t)k0 * skl, skl,
                                     lk - k0, d, vec, tid);
      load_tile<T, S, kBK, NT, DMAX>(vs + at, vb + (int64_t)k0 * svl, svl,
                                     lk - k0, d, vec, tid);
    }
    cp_async_commit();
  };
  zero_pad_columns<T, S, DMAX, NT>(qs, BQ + 2 * ST * kBK, d, tid);
  load_tile<T, S, BQ, NT, DMAX>(qs, q + b * sqb + h * sqh + (int64_t)q0 * sql,
                                sql, lq - q0, d, vec, tid);
  for (int t = 0; t < ST - 1; ++t) load_kv(t);  // Q rides with tile 0

  const int r0 = q0 + WR * warp;      // the warp's first row
  const int row_g = r0 + g;           // m-tile mt: rows row_g + 16 mt (+ 8)
  const bool rows_live = r0 < lq;
  // the end of the keys any of the warp's rows sees
  const int kwarp = causal ? min(lk, r0 + WR + off) : lk;

  float m[MT][2], l[MT][2], acc[MT][DMAX / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][n][c] = 0.f;
  }
  uint32_t qf[MT][kF32 ? 1 : DMAX / 16][4];

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kBK;
    cp_async_wait<ST - 2>();  // tile it landed; later tiles may be in flight
    __syncthreads();  // ... for every thread; all are done with tile it - 1
    load_kv(it + ST - 1);     // into the stage tile it - 1 held
    if constexpr (!kF32) {
      if (it == 0) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int kk = 0; kk < DMAX / 16; ++kk)
            ldmatrix_x4(qf[mt][kk], qs + (WR * warp + 16 * mt +
                                          (lane & 15)) * S +
                                         kk * 16 + (lane >> 4) * 8);
      }
    }
    if (!rows_live || k0 >= kwarp) continue;  // nothing live for this warp
    const bool masked =
        k0 + kBK > lk || (causal && k0 + kBK - 1 > r0 + off);
    const T* kt = ks + (it % ST) * kBK * S;
    const T* vt = vs + (it % ST) * kBK * S;
    float s[MT][KN][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < KN; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[mt][n][c] = 0.f;
    if constexpr (kF32)
      logits_tf32<DMAX, MT, KN>(s, qs + WR * warp * S, kt, sm_scale, g, t4);
    else
      logits_bf16<DMAX, MT, KN>(s, qf, kt, sm_scale, lane);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (masked)
        online_softmax<DMAX, KN, true>(
            s[mt], acc[mt], m[mt], l[mt], row_g + 16 * mt, k0 + 2 * t4, lk,
            off, causal);
      else
        online_softmax<DMAX, KN, false>(
            s[mt], acc[mt], m[mt], l[mt], row_g + 16 * mt, k0 + 2 * t4, lk,
            off, causal);
    }
    if constexpr (kF32)
      pv_tf32<DMAX, MT, KN>(acc, s, vt, g, t4);
    else
      pv_bf16<DMAX, MT, KN>(acc, s, vt, lane);
  }
  cp_async_wait<0>();  // no copy outlives the block

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[mt][i] += __shfl_xor_sync(kFull, l[mt][i], 1);
      l[mt][i] += __shfl_xor_sync(kFull, l[mt][i], 2);
    }
  if (!rows_live) return;
  T* ob = o + (int64_t)bh * lq * d;   // out is contiguous (B, H, Lq, D)
  const bool pairs = (d & 1) == 0;    // (col, col + 1) as one store
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_g + 16 * mt + 8 * i;
      if (row >= lq) continue;
      const float denom = fmaxf(l[mt][i], 1e-20f);
      // m and l are the same in the row's quad: its first lane writes lse
      if (LSE && t4 == 0)
        lse[(int64_t)bh * lq + row] = m[mt][i] + logf(denom);
      T* orow = ob + (int64_t)row * d;
#pragma unroll
      for (int n = 0; n < DMAX / 8; ++n) {
        const int col = n * 8 + 2 * t4;
        if (col >= d) continue;
        const float x0 = acc[mt][n][2 * i] / denom;
        const float x1 = acc[mt][n][2 * i + 1] / denom;
        if (pairs) {
          store_pair<T>(orow + col, x0, x1);
        } else {
          orow[col] = from_f32<T>(x0);
          if (col + 1 < d) orow[col + 1] = from_f32<T>(x1);
        }
      }
    }
  }
}

// Lets a kernel instance use more than 48 KB of dynamic shared memory, once
// per instance and device (before any launch, so outside graph capture).
template <typename T, int DMAX, int NW, int MT, int KN, bool LSE>
cudaError_t allow_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_fwd<T, DMAX, NW, MT, KN, LSE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes<T, DMAX, NW, MT, KN>());
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <typename T, int DMAX, int NW, int MT, int KN, bool LSE>
int launch_shape(const void* q, const void* k, const void* v, void* o,
                 float* lse, int batch, int heads, int lq, int lk, int d,
                 const int64_t* st, float sm_scale, int causal, int vec,
                 cudaStream_t stream) {
  constexpr size_t kSmem = smem_bytes<T, DMAX, NW, MT, KN>();
  constexpr int kBQ = 16 * MT * NW;
  if (kSmem > 232448) return (int)cudaErrorInvalidConfiguration;
  if ((int64_t)batch * heads > 2147483647LL || (lq + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const cudaError_t err = allow_smem<T, DMAX, NW, MT, KN, LSE>();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(batch * heads), (unsigned)((lq + kBQ - 1) / kBQ));
  flash_fwd<T, DMAX, NW, MT, KN, LSE><<<grid, 32 * NW, kSmem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, heads, lq, lk, d,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      sm_scale, causal, vec);
  return (int)cudaGetLastError();
}

// A block shape: warps, m-tiles of 16 query rows per warp, keys per tile.
struct Cfg {
  int warps, mtiles, keys;
};

constexpr bool operator==(Cfg a, Cfg b) {
  return a.warps == b.warps && a.mtiles == b.mtiles && a.keys == b.keys;
}

// The block shape of each input type and padded width, timed against
// the other shapes on the card: kShort where there are at most 256 keys,
// kLong otherwise.
template <typename T, int DMAX>
struct Shape {  // bf16, and f32 at DMAX = 128
  static constexpr Cfg kLong = std::is_same<T, float>::value
                                   ? Cfg{8, 1, 64}
                                   : Cfg{4, 1, 64};
  static constexpr Cfg kShort = kLong;
};

template <>
struct Shape<float, 64> {
  static constexpr Cfg kLong = {4, 2, 64};
  static constexpr Cfg kShort = {8, 1, 32};
};

template <typename T, int DMAX, bool LSE>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int batch, int heads, int lq, int lk, int d, const int64_t* st,
           float sm_scale, int causal, int vec, cudaStream_t stream) {
  constexpr Cfg kL = Shape<T, DMAX>::kLong;
  constexpr Cfg kS = Shape<T, DMAX>::kShort;
  if constexpr (!(kS == kL)) {
    if (lk <= 256)
      return launch_shape<T, DMAX, kS.warps, kS.mtiles, kS.keys / 8, LSE>(
          q, k, v, o, lse, batch, heads, lq, lk, d, st, sm_scale, causal, vec,
          stream);
  }
  return launch_shape<T, DMAX, kL.warps, kL.mtiles, kL.keys / 8, LSE>(
      q, k, v, o, lse, batch, heads, lq, lk, d, st, sm_scale, causal, vec,
      stream);
}

// The widest copy (16, 8, 4 or 2 bytes, not below the element) that every
// row start and the row's d elements allow.
int copy_width(const void* q, const void* k, const void* v, const int64_t* st,
               int d, int elt) {
  uint64_t bits = (uint64_t)(uintptr_t)q | (uint64_t)(uintptr_t)k |
                  (uint64_t)(uintptr_t)v | (uint64_t)d * elt;
  for (int i = 0; i < 9; ++i) bits |= (uint64_t)st[i] * elt;
  int w = 16;
  while (w > elt && (bits & (uint64_t)(w - 1))) w >>= 1;
  return w;
}

template <bool LSE>
int dispatch_fwd(const void* q, const void* k, const void* v, void* o,
                 float* lse, int dtype, int batch, int heads, int lq, int lk,
                 int d, const int64_t* st, float sm_scale, int causal,
                 void* stream) {
  if (d < 1 || d > kMaxD || lq < 1 || lk < 1 || batch < 1 || heads < 1 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    const int vec = copy_width(q, k, v, st, d, 4);
    return d <= 64 ? launch<float, 64, LSE>(q, k, v, o, lse, batch, heads, lq,
                                            lk, d, st, sm_scale, causal, vec,
                                            s)
                   : launch<float, 128, LSE>(q, k, v, o, lse, batch, heads,
                                             lq, lk, d, st, sm_scale, causal,
                                             vec, s);
  }
  const int vec = copy_width(q, k, v, st, d, 2);
  return d <= 64 ? launch<__nv_bfloat16, 64, LSE>(q, k, v, o, lse, batch,
                                                  heads, lq, lk, d, st,
                                                  sm_scale, causal, vec, s)
                 : launch<__nv_bfloat16, 128, LSE>(q, k, v, o, lse, batch,
                                                   heads, lq, lk, d, st,
                                                   sm_scale, causal, vec, s);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and o alike).  Strides are in
// elements, (b, h, l) for each of q, k, v; D is contiguous in all three,
// and o is a contiguous (B, H, Lq, D) buffer.  Returns, without launching,
// cudaErrorInvalidValue for D outside [1, 128], an unknown dtype or an
// empty length, and cudaErrorInvalidConfiguration when B * H or the number
// of query tiles passes the grid's limits; else cudaGetLastError() after
// the launch (0 = launched).
extern "C" int zoo_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int batch, int heads, int lq, int lk, int d, int64_t sqb, int64_t sqh,
    int64_t sql, int64_t skb, int64_t skh, int64_t skl, int64_t svb,
    int64_t svh, int64_t svl, float sm_scale, int causal, void* stream) {
  const int64_t st[9] = {sqb, sqh, sql, skb, skh, skl, svb, svh, svl};
  return dispatch_fwd<false>(q, k, v, o, nullptr, dtype, batch, heads, lq,
                             lk, d, st, sm_scale, causal, stream);
}

// The training forward: as zoo_flash_attention_fwd, plus lse, a
// contiguous (B, H, Lq) f32 buffer that receives each row's logsumexp.
// The same checks and return codes.
extern "C" int zoo_flash_attention_fwd_lse(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int dtype, int batch, int heads, int lq, int lk, int d, int64_t sqb,
    int64_t sqh, int64_t sql, int64_t skb, int64_t skh, int64_t skl,
    int64_t svb, int64_t svh, int64_t svl, float sm_scale, int causal,
    void* stream) {
  const int64_t st[9] = {sqb, sqh, sql, skb, skh, skl, svb, svh, svl};
  return dispatch_fwd<true>(q, k, v, o, lse, dtype, batch, heads, lq, lk, d,
                            st, sm_scale, causal, stream);
}

extern "C" const char* zoo_flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
