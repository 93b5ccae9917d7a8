// Flash-attention backward for Hopper (sm_90a): dQ, and dK with dV.
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
// query row with no live key (lse = -1e30) has p = 0 and a zero dQ; the
// causal mask is bottom-right aligned (row i sees key j iff
// i + Lk - Lq >= j).
//
// Bound: flash_bwd_dq does three products per (query, key) pair (S, dP,
// dS.K) and flash_bwd_dkv four (S, dP, P^T.dO, dS^T.Q): 6 and 8 * Lq * Lk
// * D operations per (b, h) against about 4 * (Lq + Lk) * D elements of
// traffic, so at every shape the port trains (D = 64, L = 128 and up) the
// f32 operations bound them.  This first version, like the forward, does
// the products with FMA on the CUDA cores (tensor cores, TMA and causal
// tile order are later work) and keeps the tiles in shared memory.
//
// Layout: one block of 256 threads (16 x 16) per (b*h, 64-row tile): a
// query tile for dQ, a key tile for dK/dV; the grid's x is b*h, its y
// the tile.  Each block owns its output tile and loops over the other
// operand's tiles in order, summing in f32 registers, so there are no
// atomics and the result is the same bits on every run.  dQ's loop stops
// at the tile's last live key (causal), as the forward's does; dK/dV's
// starts at the first query tile whose last row reaches the key tile.
// Every product is a 4 x 4 micro-tile per thread over operands stored
// transposed in shared memory with a row stride of 65 floats (the
// conflict-free broadcasts of the forward); the probability and dS tiles
// sit row-major, stride 65.  q, k, v and dO may be strided views (the
// (b, h, l) strides are arguments, D contiguous); dq, dk and dv are
// contiguous.  Shared memory, dynamic: dQ (4 * D * 65 + 64 * 65) floats,
// 81 KB at D = 64 and 146 KB at D = 128; dK/dV (4 * D * 65 + 2 * 64 * 65)
// floats, 98 KB and 163 KB, under the 227 KB a block may opt in to.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;           // query rows and keys per tile
constexpr int kPad = kTile + 1;     // shared row stride, in floats
constexpr int kThreads = 256;       // 16 x 16
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;   // the TPU kernel's NEG_INF

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

size_t dq_smem(int d) {
  return sizeof(float) * (size_t)(4 * d * kPad + kTile * kPad);
}

size_t dkv_smem(int d) {
  return sizeof(float) * (size_t)(4 * d * kPad + 2 * kTile * kPad);
}

// Rows [r0, r0 + 64) of x (row stride sl, D contiguous) times scale, into
// dst[c * kPad + r] (transposed); rows at or past n are 0.
template <typename T>
__device__ __forceinline__ void load_t(float* dst, const T* __restrict__ x,
                                       int r0, int n, int d, int64_t sl,
                                       float scale) {
  for (int idx = threadIdx.x; idx < kTile * d; idx += kThreads) {
    const int r = idx / d;
    const int c = idx - r * d;
    float val = 0.f;
    if (r0 + r < n) val = to_f32(x[(int64_t)(r0 + r) * sl + c]) * scale;
    dst[c * kPad + r] = val;
  }
}

// s[i][j] = sum_c a[c][ty + 16 i] * b[c][tx + 16 j] over transposed tiles.
__device__ __forceinline__ void tile_dot(float (&s)[4][4],
                                         const float* __restrict__ a,
                                         const float* __restrict__ b, int d,
                                         int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < d; ++c) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[c * kPad + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[c * kPad + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

struct Args {
  int heads, lq, lk, d;
  int64_t sqb, sqh, sql, skb, skh, skl, svb, svh, svl, sob, soh, sol;
  float sm_scale;
  int causal;
};

// NC = columns of D per thread (D <= 16 * NC).  Threads: ty over query
// rows (ty + 16 i), tx over keys (logits) and over D (dQ).
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, Args a) {
  extern __shared__ float smem[];
  const int d = a.d;
  float* qs = smem;                   // [d][kPad]  q * sm_scale
  float* dos = qs + d * kPad;         // [d][kPad]  dO
  float* ks = dos + d * kPad;         // [d][kPad]
  float* vs = ks + d * kPad;          // [d][kPad]
  float* dss = vs + d * kPad;         // [kTile][kPad]  dS, row-major

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.x;
  const int b = bh / a.heads;
  const int h = bh - b * a.heads;
  const int q0 = blockIdx.y * kTile;
  const T* kb = k + b * a.skb + h * a.skh;
  const T* vb = v + b * a.svb + h * a.svh;

  load_t(qs, q + b * a.sqb + h * a.sqh, q0, a.lq, d, a.sql, a.sm_scale);
  load_t(dos, dout + b * a.sob + h * a.soh, q0, a.lq, d, a.sol, 1.f);
  float lse_r[4], del_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    lse_r[i] = r < a.lq ? lse[(int64_t)bh * a.lq + r] : 0.f;
    del_r[i] = r < a.lq ? delta[(int64_t)bh * a.lq + r] : 0.f;
  }

  // keys past kend are masked for every row of this tile
  const int off = a.lk - a.lq;
  int kend = a.lk;
  if (a.causal) {
    const int q_last = min(q0 + kTile, a.lq) - 1;
    kend = min(a.lk, q_last + off + 1);
  }

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < kend; k0 += kTile) {
    __syncthreads();  // the last tile's reads of ks / vs / dss are done
    load_t(ks, kb, k0, a.lk, d, a.skl, 1.f);
    load_t(vs, vb, k0, a.lk, d, a.svl, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot(s, qs, ks, d, ty, tx);
    tile_dot(dp, dos, vs, d, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i + off;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool dead = kpos >= a.lk || (a.causal && qpos < kpos) ||
                          s[i][j] <= 0.5f * kNegInf;
        const float p = dead ? 0.f : expf(s[i][j] - lse_r[i]);
        dss[(ty + 16 * i) * kPad + tx + 16 * j] = p * (dp[i][j] - del_r[i]);
      }
    }
    __syncthreads();

    // keys at or past kend have dS == 0 in every row: skip them
    const int jn = min(kTile, kend - k0);
    for (int j = 0; j < jn; ++j) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(ty + 16 * i) * kPad + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        const float kv = col < d ? ks[col * kPad + j] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(dsv[i], kv, acc[i][c]);
      }
    }
  }

  T* dqb = dq + (int64_t)bh * a.lq * d;   // dq is contiguous (B, H, Lq, D)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= a.lq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < d)
        dqb[(int64_t)r * d + col] = from_f32<T>(acc[i][c] * a.sm_scale);
    }
  }
}

// Threads: ty over keys (ty + 16 i), tx over query rows (logits) and
// over D (dK, dV).  dK sums dS^T against q * sm_scale, which carries
// dK's factor sm_scale.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dk, T* __restrict__ dv, Args a) {
  extern __shared__ float smem[];
  const int d = a.d;
  float* kts = smem;                  // [d][kPad]  this block's keys
  float* vts = kts + d * kPad;        // [d][kPad]  this block's values
  float* qts = vts + d * kPad;        // [d][kPad]  q * sm_scale, query tile
  float* dots = qts + d * kPad;       // [d][kPad]  dO, query tile
  float* ps = dots + d * kPad;        // [kTile][kPad]  P^T, row-major
  float* dss = ps + kTile * kPad;     // [kTile][kPad]  dS^T, row-major

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.x;
  const int b = bh / a.heads;
  const int h = bh - b * a.heads;
  const int k0 = blockIdx.y * kTile;
  const T* qb = q + b * a.sqb + h * a.sqh;
  const T* ob = dout + b * a.sob + h * a.soh;
  const float* lse_b = lse + (int64_t)bh * a.lq;
  const float* del_b = delta + (int64_t)bh * a.lq;

  load_t(kts, k + b * a.skb + h * a.skh, k0, a.lk, d, a.skl, 1.f);
  load_t(vts, v + b * a.svb + h * a.svh, k0, a.lk, d, a.svl, 1.f);

  // causal: the first query tile whose last row reaches key k0
  const int off = a.lk - a.lq;
  int qstart = 0;
  if (a.causal) {
    const int need = k0 - off - (kTile - 1);
    if (need > 0) qstart = (need + kTile - 1) / kTile * kTile;
  }

  float acc_k[4][NC], acc_v[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int q0 = qstart; q0 < a.lq; q0 += kTile) {
    __syncthreads();  // the last tile's reads of qts / dots / ps / dss
    load_t(qts, qb, q0, a.lq, d, a.sql, a.sm_scale);
    load_t(dots, ob, q0, a.lq, d, a.sol, 1.f);
    __syncthreads();

    float lse_c[4], del_c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = q0 + tx + 16 * j;
      lse_c[j] = r < a.lq ? lse_b[r] : 0.f;
      del_c[j] = r < a.lq ? del_b[r] : 0.f;
    }
    float s[4][4], dp[4][4];
    tile_dot(s, kts, qts, d, ty, tx);     // s[i][j]: key ty+16i, row tx+16j
    tile_dot(dp, vts, dots, d, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kpos = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + tx + 16 * j;
        const bool dead = kpos >= a.lk || row >= a.lq ||
                          (a.causal && row + off < kpos) ||
                          s[i][j] <= 0.5f * kNegInf;
        const float p = dead ? 0.f : expf(s[i][j] - lse_c[j]);
        ps[(ty + 16 * i) * kPad + tx + 16 * j] = p;
        dss[(ty + 16 * i) * kPad + tx + 16 * j] = p * (dp[i][j] - del_c[j]);
      }
    }
    __syncthreads();

    // rows at or past Lq have p == dS == 0: skip them
    const int rn = min(kTile, a.lq - q0);
    for (int r = 0; r < rn; ++r) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = ps[(ty + 16 * i) * kPad + r];
        dsv[i] = dss[(ty + 16 * i) * kPad + r];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        const float ov = col < d ? dots[col * kPad + r] : 0.f;
        const float qv = col < d ? qts[col * kPad + r] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc_v[i][c] = fmaf(pv[i], ov, acc_v[i][c]);
          acc_k[i][c] = fmaf(dsv[i], qv, acc_k[i][c]);
        }
      }
    }
  }

  // dk and dv are contiguous (B, H, Lk, D)
  T* dkb = dk + (int64_t)bh * a.lk * d;
  T* dvb = dv + (int64_t)bh * a.lk * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r >= a.lk) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) {
        dkb[(int64_t)r * d + col] = from_f32<T>(acc_k[i][c]);
        dvb[(int64_t)r * d + col] = from_f32<T>(acc_v[i][c]);
      }
    }
  }
}

// Lets a kernel use more than 48 KB of dynamic shared memory, once per
// kernel instance and device (before any launch, so outside graph
// capture).
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

template <typename T, int NC>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int batch,
              const Args& a, cudaStream_t stream) {
  static bool done[64] = {};
  const cudaError_t err =
      allow_smem(flash_bwd_dq<T, NC>, dq_smem(kMaxD), done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(batch * a.heads),
                  (unsigned)((a.lq + kTile - 1) / kTile));
  flash_bwd_dq<T, NC><<<grid, kThreads, dq_smem(a.d), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, a);
  return (int)cudaGetLastError();
}

template <typename T, int NC>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int batch, const Args& a, cudaStream_t stream) {
  static bool done[64] = {};
  const cudaError_t err =
      allow_smem(flash_bwd_dkv<T, NC>, dkv_smem(kMaxD), done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(batch * a.heads),
                  (unsigned)((a.lk + kTile - 1) / kTile));
  flash_bwd_dkv<T, NC><<<grid, kThreads, dkv_smem(a.d), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, a);
  return (int)cudaGetLastError();
}

// 0 when the arguments are ones the kernels take, else the error code.
int check(int dtype, int batch, int heads, int lq, int lk, int d) {
  if (d < 1 || d > kMaxD || lq < 1 || lk < 1 || batch < 1 || heads < 1 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if ((int64_t)batch * heads > 2147483647LL ||
      (lq + kTile - 1) / kTile > 65535 || (lk + kTile - 1) / kTile > 65535)
    return (int)cudaErrorInvalidConfiguration;
  return 0;
}

Args make_args(int heads, int lq, int lk, int d, const int64_t* st,
               float sm_scale, int causal) {
  return Args{heads, lq, lk, d, st[0], st[1], st[2], st[3], st[4], st[5],
              st[6], st[7], st[8], st[9], st[10], st[11], sm_scale, causal};
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
  const int bad = check(dtype, batch, heads, lq, lk, d);
  if (bad) return bad;
  const Args a = make_args(heads, lq, lk, d, st, sm_scale, causal);
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return d <= 64 ? launch_dq<float, 4>(q, k, v, dout, lse, delta, dq,
                                         batch, a, s)
                   : launch_dq<float, 8>(q, k, v, dout, lse, delta, dq,
                                         batch, a, s);
  return d <= 64 ? launch_dq<__nv_bfloat16, 4>(q, k, v, dout, lse, delta, dq,
                                               batch, a, s)
                 : launch_dq<__nv_bfloat16, 8>(q, k, v, dout, lse, delta, dq,
                                               batch, a, s);
}

// As zoo_flash_attention_bwd_dq; dk and dv are contiguous (B, H, Lk, D)
// buffers.
extern "C" int zoo_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int dtype,
    int batch, int heads, int lq, int lk, int d, const int64_t* st,
    float sm_scale, int causal, void* stream) {
  const int bad = check(dtype, batch, heads, lq, lk, d);
  if (bad) return bad;
  const Args a = make_args(heads, lq, lk, d, st, sm_scale, causal);
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return d <= 64 ? launch_dkv<float, 4>(q, k, v, dout, lse, delta, dk, dv,
                                          batch, a, s)
                   : launch_dkv<float, 8>(q, k, v, dout, lse, delta, dk, dv,
                                          batch, a, s);
  return d <= 64 ? launch_dkv<__nv_bfloat16, 4>(q, k, v, dout, lse, delta,
                                                dk, dv, batch, a, s)
                 : launch_dkv<__nv_bfloat16, 8>(q, k, v, dout, lse, delta,
                                                dk, dv, batch, a, s);
}

extern "C" const char* zoo_flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
