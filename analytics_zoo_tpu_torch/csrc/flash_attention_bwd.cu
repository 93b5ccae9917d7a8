// Flash-attention backward for Hopper (sm_90a) on the tensor cores: dQ,
// and dK with dV.
//
// Replaces the Pallas TPU kernels
// analytics_zoo_tpu/ops/flash_attention.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel (both launched by _flash_bwd), the FlashAttention-2
// backward.  With s = (sm_scale * q) . k and the forward's per-row
// logsumexp lse (flash_attention.cu, LSE instance), the probabilities are
// recomputed tile by tile,
//
//   p[i][j]  = exp(s[i][j] - lse[i])         (0 where masked)
//   dp[i][j] = dO[i] . v[j]
//   ds[i][j] = p[i][j] * (dp[i][j] - delta[i]),  delta[i] = dO[i] . o[i]
//
//   dQ[i] = sm_scale * sum_j ds[i][j] k[j]      (flash_bwd_dq)
//   dK[j] = sm_scale * sum_i ds[i][j] q[i]      (flash_bwd_dkv)
//   dV[j] =            sum_i p[i][j] dO[i]      (flash_bwd_dkv)
//
// so no (Lq, Lk) matrix reaches device memory.  delta is computed by the
// caller (one elementwise product and row sum in PyTorch, as the JAX
// package leaves it to XLA) and passed in with lse, both contiguous
// (B, H, Lq) f32.  The TPU kernels' constants and rules hold: masked
// logits are -1e30 and p is forced to 0 where a logit is <= -5e29, so a
// query row with no live key (lse = -1e30) has p = 0 and an exactly zero
// dQ; the causal mask is bottom-right aligned (row i sees key j iff
// i + Lk - Lq >= j).
//
// Numeric contract (the forward's, flash_attention.cu):
// - f32 inputs: every product is split-TF32 on m16n8k8.tf32 (x_hi =
//   tf32(x), x_lo = tf32(x - x_hi); a.b ~ a_hi.b_hi + a_hi.b_lo +
//   a_lo.b_hi, mma_tiles.cuh), f32 accumulation: about 21 mantissa bits,
//   within the f32 tolerance where plain TF32 is not.  q is scaled by
//   sm_scale in f32 before its split in s; dK sums ds against the unscaled
//   q and is scaled at the end, as the TPU kernel does.
// - bf16 inputs: q.k and dO.v are exact m16n8k16.bf16 products (sm_scale
//   multiplies the f32 logits afterwards).  p and ds are f32 in the TPU
//   kernel, so they enter P^T.dO, dS.K and dS^T.Q as two bf16 terms,
//   x_hi = bf16(x) and x_lo = bf16(x - x_hi), against the exact bf16 dO,
//   K or Q: 16 bits of p and ds where one bf16 rounding would keep 8.
// - exp is the hardware's ex2 (relative error about 2^-22):
//   exp(s - lse) = ex2(s log2e - lse log2e), one FFMA.
//
// Bound.  flash_bwd_dq does three products per live (query, key) pair (S,
// dP, dS.K) and flash_bwd_dkv four (S, dP, P^T.dO, dS^T.Q): 6 and 8 * D
// operations per pair against about 4 * (Lq + Lk) * D elements of
// traffic, so from BERT's L = 128 up the operations bound them: f32 at the
// card's f32-accurate tensor rate (three TF32 products per product, 495 /
// 3 = 165 TFLOP/s), bf16 at 989 TFLOP/s.  mma.sync reaches a fraction of
// those rates; wgmma with a TMA producer warp is the route to all of it.
//
// Design, and what each choice addresses:
//
// - dQ (flash_bwd_dq): a block of NW warps per (b*h, query tile); each
//   warp owns MT m-tiles of 16 query rows, whose lse and delta sit in
//   registers.  It walks the key tiles up to the tile's last live key
//   (causal), computes S = Q.K^T and dP = dO.V^T into accumulators, turns
//   them into dS in registers, and adds dS.K to the dQ accumulator, with
//   dS's accumulator used as the A fragment (below).  Causal query tiles
//   run heaviest first (tile index reversed).
// - dK/dV (flash_bwd_dkv): a block of NW warps per (b*h, key tile); each
//   warp owns MT m-tiles of 16 keys.  It walks the query tiles from the
//   first that reaches its keys (causal), computes S^T = K.Q^T and dP^T =
//   V.dO^T, turns them into P^T and dS^T in registers (lse and delta of
//   the tile's queries from shared memory), and adds P^T.dO and dS^T.Q to
//   the dV and dK accumulators.  Causal key tiles are heaviest first as
//   they stand (tile 0 sees every query).
// - Accumulators as A fragments: S^T/dP^T (and S/dP) come out of the
//   tensor cores in the C layout, which is not the A layout of the next
//   product.  In f32 the 8 rows of B in each k-step are permuted (A column
//   t is row 2t, column t + 4 row 2t + 1) so the accumulator is the A
//   fragment as it stands; in bf16 two adjacent n8 accumulators are an
//   m16n8k16 A fragment.  No P or dS tile goes through shared memory and
//   no block barrier sits between the four products.
// - Asynchronous copies: the block's own tile (Q and dO, or K and V) is
//   loaded once; the other operand's tiles (K and V, or Q, dO and their lse
//   and delta rows) go through a ring of two shared stages with 16-byte
//   cp.async.cg, so the next tile is in flight while one is computed, with
//   one block barrier per tile.  bf16 stays bf16 in shared memory.  Rows
//   whose start is not on 16 bytes (strided views) take 8- or 4-byte
//   copies, or plain 2-byte loads for bf16, the width chosen per launch.
// - Conflict-free fragment reads from padded rows: f32 rows of DMAX + 4
//   floats (scalar loads, split as read), bf16 rows of DMAX + 8 (ldmatrix,
//   .trans for the pn products' B).  The A operand of the nt products
//   (the warp's own rows) is re-read per tile, in f32 split as it is read:
//   its hi and lo fragments would take 64-128 registers the accumulators
//   need.  In bf16 the Cfg's `hold` keeps the A fragments in registers for
//   the whole loop where they fit.
// - Straight-line products: every fragment loop has compile-time bounds
//   (DMAX and the tile's rows), so the compiler schedules loads, splits and
//   mma across a whole tile; the mask is applied only on tiles that cross
//   the diagonal or an edge.
// - D from 1 to 128: DMAX is 64 or 128; the columns from D to DMAX are
//   zeroed once in shared memory and take part as zeros.  Rows past Lq or
//   Lk are zero-filled by cp.async's src-size and masked.
// - Reproducible: each block owns its output tile and sums in a fixed
//   order in registers; there are no atomics, so two runs give the same
//   bits.
//
// q, k, v and dO may be strided views (the (b, h, l) strides are
// arguments, D contiguous); dq, dk and dv are contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tiles.cuh"

namespace {

using namespace zoo_mma;

constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;   // the TPU kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kStages = 2;          // ring stages

// f32 rows of DMAX + 4 floats sit 4 banks apart; bf16 rows of DMAX + 8 put
// ldmatrix's 8 rows on distinct banks
template <typename T>
constexpr int kPad = std::is_same<T, float>::value ? 4 : 8;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

// Writes the warp's MT m-tiles of 16 rows from row `row_g` (lane rows
// row_g + 16 mt and + 8) of acc * scale into the contiguous (n, d) rows of
// out; rows at or past n are skipped.
template <typename T, int DMAX, int MT>
__device__ __forceinline__ void store_rows(T* out,
                                           const float (&acc)[MT][DMAX / 8][4],
                                           float scale, int row_g, int n,
                                           int d, int t4) {
  const bool pairs = (d & 1) == 0;    // (col, col + 1) as one store
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_g + 16 * mt + 8 * i;
      if (row >= n) continue;
      T* orow = out + (int64_t)row * d;
#pragma unroll
      for (int c = 0; c < DMAX / 8; ++c) {
        const int col = c * 8 + 2 * t4;
        if (col >= d) continue;
        const float x0 = acc[mt][c][2 * i] * scale;
        const float x1 = acc[mt][c][2 * i + 1] * scale;
        if (pairs) {
          store_pair<T>(orow + col, x0, x1);
        } else {
          orow[col] = from_f32<T>(x0);
          if (col + 1 < d) orow[col + 1] = from_f32<T>(x1);
        }
      }
    }
}

struct Args {
  int heads, lq, lk, d;
  int64_t sqb, sqh, sql, skb, skh, skl, svb, svh, svl, sob, soh, sol;
  float sm_scale;
  int causal, vec;
};

// A block shape: warps, m-tiles of 16 rows per warp, rows per ring tile
// (keys for dQ, queries for dK/dV), bf16 A fragments held in registers.
struct Cfg {
  int warps, mtiles, rows;
  bool hold;
};

// dQ.  s, dp: the warp's S and dP accumulators on a key tile (lane rows
// row_g + 16 mt (+ 8), keys kcol + 8 n (+ 1)); on return s holds dS.
// lse2: each lane row's lse * log2e.
template <int MT, int KN, bool MASK>
__device__ __forceinline__ void ds_rows(float (&s)[MT][KN][4],
                                        const float (&dp)[MT][KN][4],
                                        const float (&lse2)[MT][2],
                                        const float (&del)[MT][2], int row_g,
                                        int kcol, int lk, int off,
                                        int causal) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < KN; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[mt][n][c];
        if (MASK) {
          const int key = kcol + 8 * n + (c & 1);
          const int row = row_g + 16 * mt + 8 * (c >> 1);
          if (key >= lk || (causal && row + off < key)) x = kNegInf;
        }
        const float e = ex2(fmaf(x, kLog2e, -lse2[mt][c >> 1]));
        const float p = x <= 0.5f * kNegInf ? 0.f : e;
        s[mt][n][c] = p * (dp[mt][n][c] - del[mt][c >> 1]);
      }
}

// dK/dV.  s, dp: the warp's S^T and dP^T accumulators on a query tile
// (lane rows = keys key_g + 16 mt (+ 8), columns = queries qcol + 8 n
// (+ 1)); on return s holds P^T and dp holds dS^T.  lse_t, del_t: the
// tile's lse and delta, indexed by query - qcol + 2 t4.
template <int MT, int KN, bool MASK>
__device__ __forceinline__ void p_ds_cols(float (&s)[MT][KN][4],
                                          float (&dp)[MT][KN][4],
                                          const float* lse_t,
                                          const float* del_t, int key_g,
                                          int qcol, int t4, int lq, int lk,
                                          int off, int causal) {
#pragma unroll
  for (int n = 0; n < KN; ++n) {
    const float2 l = *reinterpret_cast<const float2*>(lse_t + 8 * n + 2 * t4);
    const float2 dl = *reinterpret_cast<const float2*>(del_t + 8 * n + 2 * t4);
    const float l2[2] = {l.x * kLog2e, l.y * kLog2e};
    const float dd[2] = {dl.x, dl.y};
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[mt][n][c];
        if (MASK) {
          const int query = qcol + 8 * n + (c & 1);
          const int key = key_g + 16 * mt + 8 * (c >> 1);
          if (query >= lq || key >= lk || (causal && query + off < key))
            x = kNegInf;
        }
        const float e = ex2(fmaf(x, kLog2e, -l2[c & 1]));
        const float p = x <= 0.5f * kNegInf ? 0.f : e;
        s[mt][n][c] = p;
        dp[mt][n][c] = p * (dp[mt][n][c] - dd[c & 1]);
      }
  }
}

template <int MT, int KN>
__device__ __forceinline__ void zero_acc(float (&x)[MT][KN][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < KN; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) x[mt][n][c] = 0.f;
}

template <typename T, int DMAX, int NW, int MT, int KN>
constexpr size_t dq_smem() {  // Q, dO [BQ][S]; K, V [stage][BK][S]
  return sizeof(T) * (size_t)(2 * 16 * MT * NW + 2 * kStages * 8 * KN) *
         (DMAX + kPad<T>);
}

template <typename T, int DMAX, int NW, int MT, int KN>
constexpr size_t dkv_smem() {  // K, V [BK][S]; Q, dO [stage][BQ][S]; lse, delta
  return sizeof(T) * (size_t)(2 * 16 * MT * NW + 2 * kStages * 8 * KN) *
             (DMAX + kPad<T>) +
         sizeof(float) * (size_t)(2 * kStages * 8 * KN);
}

// DMAX: 64 or 128, the padded head width; NW warps of MT m-tiles (16 query
// rows each); key tiles of 8 * KN keys; HOLD: bf16 Q and dO fragments
// loaded once.
template <typename T, int DMAX, int NW, int MT, int KN, bool HOLD>
__global__ void __launch_bounds__(32 * NW, 1)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, Args a) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int NT = 32 * NW;
  constexpr int WR = 16 * MT;         // query rows per warp
  constexpr int BQ = WR * NW;         // query rows per block
  constexpr int BK = 8 * KN;          // keys per tile
  constexpr int S = DMAX + kPad<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [BQ][S]
  T* dos = qs + BQ * S;                    // [BQ][S]
  T* ks = dos + BQ * S;                    // [ST][BK][S]
  T* vs = ks + kStages * BK * S;           // [ST][BK][S]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int bh = blockIdx.x;
  // causal: the heaviest query tiles (the last) go first
  const int qt =
      a.causal ? (int)(gridDim.y - 1 - blockIdx.y) : (int)blockIdx.y;
  const int b = bh / a.heads;
  const int h = bh - b * a.heads;
  const int q0 = qt * BQ;
  const int lq = a.lq, lk = a.lk, d = a.d;
  const T* kb = k + b * a.skb + h * a.skh;
  const T* vb = v + b * a.svb + h * a.svh;

  // keys past kend are masked for every row of this tile
  const int off = lk - lq;
  int kend = lk;
  if (a.causal) kend = min(lk, min(q0 + BQ, lq) + off);
  const int ntiles = kend > 0 ? (kend + BK - 1) / BK : 0;

  // K and V tile t into ring stage t % ST, as one cp.async group
  auto load_kv = [&](int t) {
    if (t < ntiles) {
      const int k0 = t * BK;
      const int at = (t % kStages) * BK * S;
      load_tile<T, S, BK, NT, DMAX>(ks + at, kb + (int64_t)k0 * a.skl, a.skl,
                                    lk - k0, d, a.vec, tid);
      load_tile<T, S, BK, NT, DMAX>(vs + at, vb + (int64_t)k0 * a.svl, a.svl,
                                    lk - k0, d, a.vec, tid);
    }
    cp_async_commit();
  };
  zero_pad_columns<T, S, DMAX, NT>(qs, 2 * BQ + 2 * kStages * BK, d, tid);
  load_tile<T, S, BQ, NT, DMAX>(
      qs, q + b * a.sqb + h * a.sqh + (int64_t)q0 * a.sql, a.sql, lq - q0, d,
      a.vec, tid);
  load_tile<T, S, BQ, NT, DMAX>(
      dos, dout + b * a.sob + h * a.soh + (int64_t)q0 * a.sol, a.sol,
      lq - q0, d, a.vec, tid);
  load_kv(0);                         // Q and dO ride with tile 0

  const int r0 = q0 + WR * warp;      // the warp's first row
  const int row_g = r0 + g;           // m-tile mt: rows row_g + 16 mt (+ 8)
  const bool rows_live = r0 < lq;
  // the end of the keys any of the warp's rows sees
  const int kwarp = a.causal ? min(lk, r0 + WR + off) : lk;

  float lse2[MT][2], del[MT][2], acc[MT][DMAX / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_g + 16 * mt + 8 * i;
      const bool in = row < lq;
      lse2[mt][i] = in ? lse[(int64_t)bh * lq + row] * kLog2e : 0.f;
      del[mt][i] = in ? delta[(int64_t)bh * lq + row] : 0.f;
    }
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][n][c] = 0.f;
  }
  uint32_t qf[MT][kF32 ? 1 : DMAX / 16][4], of[MT][kF32 ? 1 : DMAX / 16][4];
  const T* qw = qs + WR * warp * S;   // the warp's rows of Q and dO
  const T* ow = dos + WR * warp * S;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * BK;
    cp_async_wait<0>();       // tile it landed (and Q, dO with tile 0)
    __syncthreads();          // ... for every thread; tile it - 1 is done
    load_kv(it + 1);          // into the stage tile it - 1 held
    if constexpr (!kF32 && HOLD) {
      if (it == 0) {
        load_a_bf16<DMAX, S, MT>(qf, qw, lane);
        load_a_bf16<DMAX, S, MT>(of, ow, lane);
      }
    }
    if (!rows_live || k0 >= kwarp) continue;  // nothing live for this warp
    const bool masked =
        k0 + BK > lk || (a.causal && k0 + BK - 1 > r0 + off);
    const T* kt = ks + (it % kStages) * BK * S;
    const T* vt = vs + (it % kStages) * BK * S;
    float s[MT][KN][4], dp[MT][KN][4];
    zero_acc<MT, KN>(s);
    zero_acc<MT, KN>(dp);
    if constexpr (kF32) {
      mma_nt_3xtf32<DMAX, S, MT, KN>(s, qw, a.sm_scale, kt, 1.f, g, t4);
      mma_nt_3xtf32<DMAX, S, MT, KN>(dp, ow, 1.f, vt, 1.f, g, t4);
    } else {
      if constexpr (!HOLD) load_a_bf16<DMAX, S, MT>(qf, qw, lane);
      mma_nt_bf16<DMAX, S, MT, KN>(s, qf, kt, lane);
      if constexpr (!HOLD) load_a_bf16<DMAX, S, MT>(of, ow, lane);
      mma_nt_bf16<DMAX, S, MT, KN>(dp, of, vt, lane);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < KN; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[mt][n][c] *= a.sm_scale;
    }
    if (masked)
      ds_rows<MT, KN, true>(s, dp, lse2, del, row_g, k0 + 2 * t4, lk, off,
                            a.causal);
    else
      ds_rows<MT, KN, false>(s, dp, lse2, del, row_g, k0 + 2 * t4, lk, off,
                             a.causal);
    if constexpr (kF32)
      mma_pn_3xtf32<DMAX, S, MT, KN>(acc, s, kt, g, t4);
    else
      mma_pn_bf16<DMAX, S, MT, KN>(acc, s, kt, lane);
  }
  cp_async_wait<0>();  // no copy outlives the block
  if (!rows_live) return;
  // dq is contiguous (B, H, Lq, D)
  store_rows<T, DMAX, MT>(dq + (int64_t)bh * lq * d, acc, a.sm_scale, row_g,
                          lq, d, t4);
}

// NW warps of MT m-tiles (16 keys each); query tiles of 8 * KN rows;
// HOLD: bf16 K and V fragments loaded once.
template <typename T, int DMAX, int NW, int MT, int KN, bool HOLD>
__global__ void __launch_bounds__(32 * NW, 1)
flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dk, T* __restrict__ dv, Args a) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int NT = 32 * NW;
  constexpr int WK = 16 * MT;         // keys per warp
  constexpr int BK = WK * NW;         // keys per block
  constexpr int BQ = 8 * KN;          // queries per tile
  constexpr int S = DMAX + kPad<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // [BK][S]
  T* vs = ks + BK * S;                     // [BK][S]
  T* qs = vs + BK * S;                     // [ST][BQ][S]
  T* dos = qs + kStages * BQ * S;          // [ST][BQ][S]
  float* ls = reinterpret_cast<float*>(dos + kStages * BQ * S);  // [ST][BQ]
  float* dls = ls + kStages * BQ;                                // [ST][BQ]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / a.heads;
  const int h = bh - b * a.heads;
  const int k0 = blockIdx.y * BK;
  const int lq = a.lq, lk = a.lk, d = a.d;
  const T* qb = q + b * a.sqb + h * a.sqh;
  const T* ob = dout + b * a.sob + h * a.soh;
  const float* lse_b = lse + (int64_t)bh * lq;
  const float* del_b = delta + (int64_t)bh * lq;

  // causal: query i sees key j iff i + off >= j, so the block's keys are
  // seen from query k0 - off on
  const int off = lk - lq;
  const int qstart = a.causal ? max(0, k0 - off) : 0;
  const int ntiles = qstart < lq ? (lq - qstart + BQ - 1) / BQ : 0;

  // query tile t (Q, dO, lse, delta) into ring stage t % ST, one group
  auto load_q = [&](int t) {
    if (t < ntiles) {
      const int q0 = qstart + t * BQ;
      const int st = t % kStages;
      load_tile<T, S, BQ, NT, DMAX>(qs + st * BQ * S,
                                    qb + (int64_t)q0 * a.sql, a.sql, lq - q0,
                                    d, a.vec, tid);
      load_tile<T, S, BQ, NT, DMAX>(dos + st * BQ * S,
                                    ob + (int64_t)q0 * a.sol, a.sol, lq - q0,
                                    d, a.vec, tid);
      for (int i = tid; i < 2 * BQ; i += NT) {
        const int r = i % BQ;
        const bool ok = q0 + r < lq;
        const float* src = (i < BQ ? lse_b : del_b) + (ok ? q0 + r : 0);
        cp_async<4>(smem_u32((i < BQ ? ls : dls) + st * BQ + r), src,
                    ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };
  zero_pad_columns<T, S, DMAX, NT>(ks, 2 * BK + 2 * kStages * BQ, d, tid);
  load_tile<T, S, BK, NT, DMAX>(
      ks, k + b * a.skb + h * a.skh + (int64_t)k0 * a.skl, a.skl, lk - k0, d,
      a.vec, tid);
  load_tile<T, S, BK, NT, DMAX>(
      vs, v + b * a.svb + h * a.svh + (int64_t)k0 * a.svl, a.svl, lk - k0, d,
      a.vec, tid);
  load_q(0);                          // K and V ride with tile 0

  const int kw0 = k0 + WK * warp;     // the warp's first key
  const int key_g = kw0 + g;          // m-tile mt: keys key_g + 16 mt (+ 8)
  const bool keys_live = kw0 < lk;

  float acc_k[MT][DMAX / 8][4], acc_v[MT][DMAX / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc_k[mt][n][c] = acc_v[mt][n][c] = 0.f;
  uint32_t kf[MT][kF32 ? 1 : DMAX / 16][4], vf[MT][kF32 ? 1 : DMAX / 16][4];
  const T* kw = ks + WK * warp * S;   // the warp's rows of K and V
  const T* vw = vs + WK * warp * S;

  for (int it = 0; it < ntiles; ++it) {
    const int q0 = qstart + it * BQ;
    cp_async_wait<0>();       // tile it landed (and K, V with tile 0)
    __syncthreads();          // ... for every thread; tile it - 1 is done
    load_q(it + 1);           // into the stage tile it - 1 held
    if constexpr (!kF32 && HOLD) {
      if (it == 0) {
        load_a_bf16<DMAX, S, MT>(kf, kw, lane);
        load_a_bf16<DMAX, S, MT>(vf, vw, lane);
      }
    }
    // nothing live for this warp: no key, or no query of the tile that
    // sees one of its keys
    if (!keys_live || (a.causal && q0 + BQ - 1 + off < kw0)) continue;
    const bool masked = q0 + BQ > lq || kw0 + WK > lk ||
                        (a.causal && q0 + off < kw0 + WK - 1);
    const int st = it % kStages;
    const T* qt = qs + st * BQ * S;
    const T* ot = dos + st * BQ * S;
    float s[MT][KN][4], dp[MT][KN][4];
    zero_acc<MT, KN>(s);
    zero_acc<MT, KN>(dp);
    if constexpr (kF32) {
      mma_nt_3xtf32<DMAX, S, MT, KN>(s, kw, 1.f, qt, a.sm_scale, g, t4);
      mma_nt_3xtf32<DMAX, S, MT, KN>(dp, vw, 1.f, ot, 1.f, g, t4);
    } else {
      if constexpr (!HOLD) load_a_bf16<DMAX, S, MT>(kf, kw, lane);
      mma_nt_bf16<DMAX, S, MT, KN>(s, kf, qt, lane);
      if constexpr (!HOLD) load_a_bf16<DMAX, S, MT>(vf, vw, lane);
      mma_nt_bf16<DMAX, S, MT, KN>(dp, vf, ot, lane);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < KN; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[mt][n][c] *= a.sm_scale;
    }
    if (masked)
      p_ds_cols<MT, KN, true>(s, dp, ls + st * BQ, dls + st * BQ, key_g,
                              q0 + 2 * t4, t4, lq, lk, off, a.causal);
    else
      p_ds_cols<MT, KN, false>(s, dp, ls + st * BQ, dls + st * BQ, key_g,
                               q0 + 2 * t4, t4, lq, lk, off, a.causal);
    if constexpr (kF32) {
      mma_pn_3xtf32<DMAX, S, MT, KN>(acc_v, s, ot, g, t4);
      mma_pn_3xtf32<DMAX, S, MT, KN>(acc_k, dp, qt, g, t4);
    } else {
      mma_pn_bf16<DMAX, S, MT, KN>(acc_v, s, ot, lane);
      mma_pn_bf16<DMAX, S, MT, KN>(acc_k, dp, qt, lane);
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
  if (!keys_live) return;
  // dk and dv are contiguous (B, H, Lk, D)
  store_rows<T, DMAX, MT>(dk + (int64_t)bh * lk * d, acc_k, a.sm_scale,
                          key_g, lk, d, t4);
  store_rows<T, DMAX, MT>(dv + (int64_t)bh * lk * d, acc_v, 1.f, key_g, lk, d,
                          t4);
}

// The block shapes of each input type and padded width, timed against
// other shapes on the card by flash_bwd_shapes.py (PERF.md §6).
template <typename T, int DMAX>
struct DqShape;
template <>
struct DqShape<float, 64> {
  static constexpr Cfg k = {4, 2, 32, false};
};
template <>
struct DqShape<float, 128> {
  static constexpr Cfg k = {8, 1, 32, false};
};
template <>
struct DqShape<__nv_bfloat16, 64> {
  static constexpr Cfg k = {4, 1, 64, true};
};
template <>
struct DqShape<__nv_bfloat16, 128> {
  static constexpr Cfg k = {4, 1, 64, false};
};

template <typename T, int DMAX>
struct DkvShape;
template <>
struct DkvShape<float, 64> {
  static constexpr Cfg k = {4, 2, 16, false};
};
template <>
struct DkvShape<float, 128> {
  static constexpr Cfg k = {8, 1, 32, false};
};
template <>
struct DkvShape<__nv_bfloat16, 64> {
  static constexpr Cfg k = {4, 1, 64, true};
};
template <>
struct DkvShape<__nv_bfloat16, 128> {
  static constexpr Cfg k = {8, 1, 16, false};
};

// Lets a kernel instance use more than 48 KB of dynamic shared memory, once
// per instance and device (before any launch, so outside graph capture).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

// One output tile per block: (B * H, tiles of `tile` rows of n).
cudaError_t grid_for(int batch, const Args& a, int n, int tile, dim3* grid) {
  if ((int64_t)batch * a.heads > 2147483647LL || (n + tile - 1) / tile > 65535)
    return cudaErrorInvalidConfiguration;
  *grid = dim3((unsigned)(batch * a.heads), (unsigned)((n + tile - 1) / tile));
  return cudaSuccess;
}

template <typename T, int DMAX>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int batch,
              const Args& a, cudaStream_t stream) {
  constexpr Cfg c = DqShape<T, DMAX>::k;
  constexpr size_t kSmem = dq_smem<T, DMAX, c.warps, c.mtiles, c.rows / 8>();
  static_assert(kSmem <= 232448, "dQ block's shared memory");
  auto kernel = flash_bwd_dq<T, DMAX, c.warps, c.mtiles, c.rows / 8, c.hold>;
  static bool done[64] = {};
  dim3 grid;
  cudaError_t err = grid_for(batch, a, a.lq, 16 * c.mtiles * c.warps, &grid);
  if (err == cudaSuccess) err = allow_smem(kernel, kSmem, done);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, 32 * c.warps, kSmem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, a);
  return (int)cudaGetLastError();
}

template <typename T, int DMAX>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int batch, const Args& a, cudaStream_t stream) {
  constexpr Cfg c = DkvShape<T, DMAX>::k;
  constexpr size_t kSmem = dkv_smem<T, DMAX, c.warps, c.mtiles, c.rows / 8>();
  static_assert(kSmem <= 232448, "dK/dV block's shared memory");
  auto kernel = flash_bwd_dkv<T, DMAX, c.warps, c.mtiles, c.rows / 8, c.hold>;
  static bool done[64] = {};
  dim3 grid;
  cudaError_t err = grid_for(batch, a, a.lk, 16 * c.mtiles * c.warps, &grid);
  if (err == cudaSuccess) err = allow_smem(kernel, kSmem, done);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, 32 * c.warps, kSmem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, a);
  return (int)cudaGetLastError();
}

// The widest copy (16, 8, 4 or 2 bytes, not below the element) that every
// row start of q, k, v and dO and the row's d elements allow.
int copy_width(const void* const (&ptrs)[4], const int64_t* st, int d,
               int elt) {
  uint64_t bits = (uint64_t)d * elt;
  for (const void* p : ptrs) bits |= (uint64_t)(uintptr_t)p;
  for (int i = 0; i < 12; ++i) bits |= (uint64_t)st[i] * elt;
  int w = 16;
  while (w > elt && (bits & (uint64_t)(w - 1))) w >>= 1;
  return w;
}

// 0 with *a filled when the arguments are ones the kernels take, else the
// error code.
int make_args(const void* const (&ptrs)[4], int dtype, int batch, int heads,
              int lq, int lk, int d, const int64_t* st, float sm_scale,
              int causal, Args* a) {
  if (d < 1 || d > kMaxD || lq < 1 || lk < 1 || batch < 1 || heads < 1 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  *a = Args{heads,  lq,     lk,     d,      st[0], st[1], st[2],
            st[3],  st[4],  st[5],  st[6],  st[7], st[8], st[9],
            st[10], st[11], sm_scale, causal,
            copy_width(ptrs, st, d, dtype == 0 ? 4 : 2)};
  return 0;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v, dout and the gradients alike).
// st: the (b, h, l) strides in elements of q, k, v and dout, in that
// order (12 values); D is contiguous in all four.  lse and delta are
// contiguous (B, H, Lq) f32.  dq is a contiguous (B, H, Lq, D) buffer.
// Returns, without launching, cudaErrorInvalidValue for D outside
// [1, 128], an unknown dtype or an empty length, and
// cudaErrorInvalidConfiguration when B * H or a tile count passes the
// grid's limits; else cudaGetLastError() after the launch (0 = launched).
extern "C" int zoo_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int dtype, int batch,
    int heads, int lq, int lk, int d, const int64_t* st, float sm_scale,
    int causal, void* stream) {
  const void* const ptrs[4] = {q, k, v, dout};
  Args a;
  const int bad = make_args(ptrs, dtype, batch, heads, lq, lk, d, st,
                            sm_scale, causal, &a);
  if (bad) return bad;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return d <= 64 ? launch_dq<float, 64>(q, k, v, dout, lse, delta, dq,
                                          batch, a, s)
                   : launch_dq<float, 128>(q, k, v, dout, lse, delta, dq,
                                           batch, a, s);
  return d <= 64 ? launch_dq<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dq,
                                                batch, a, s)
                 : launch_dq<__nv_bfloat16, 128>(q, k, v, dout, lse, delta,
                                                 dq, batch, a, s);
}

// As zoo_flash_attention_bwd_dq; dk and dv are contiguous (B, H, Lk, D)
// buffers.
extern "C" int zoo_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int dtype,
    int batch, int heads, int lq, int lk, int d, const int64_t* st,
    float sm_scale, int causal, void* stream) {
  const void* const ptrs[4] = {q, k, v, dout};
  Args a;
  const int bad = make_args(ptrs, dtype, batch, heads, lq, lk, d, st,
                            sm_scale, causal, &a);
  if (bad) return bad;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return d <= 64 ? launch_dkv<float, 64>(q, k, v, dout, lse, delta, dk, dv,
                                           batch, a, s)
                   : launch_dkv<float, 128>(q, k, v, dout, lse, delta, dk,
                                            dv, batch, a, s);
  return d <= 64 ? launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, lse, delta,
                                                 dk, dv, batch, a, s)
                 : launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, lse, delta,
                                                  dk, dv, batch, a, s);
}

extern "C" const char* zoo_flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
