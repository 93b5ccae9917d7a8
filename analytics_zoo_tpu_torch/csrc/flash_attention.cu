// Flash-attention forward for Hopper (sm_90a), with and without the
// per-row logsumexp.
//
// Replaces the Pallas TPU kernels
// analytics_zoo_tpu/ops/flash_attention.py::_fwd_kernel and
// ::_fwd_lse_kernel (both launched by _flash_fwd).  For each (b, h) and
// each query row i,
//
//   o[i] = sum_j softmax_j(sm_scale * q[i] . k[j] + mask) * v[j]
//
// and, in the lse instance (LSE = true, the training forward), also
//
//   lse[i] = m[i] + log(max(l[i], 1e-20))
//
// in f32 into a contiguous (B, H, Lq) buffer: the residual the backward
// (flash_attention_bwd.cu) recomputes the probabilities from.  The TPU
// kernel pads that row to 8 sublanes ((BH, 8, Lq), a TPU tile floor);
// here it is one f32 per row.  A row with no live key keeps m = -1e30
// and l = 0, so its lse is -1e30 (log(1e-20) is lost in the f32 sum)
// and the backward's mask test gives its probabilities exactly 0.
//
// over q (B, H, Lq, D) and k, v (B, H, Lk, D), f32 or bf16, out in q's
// type.  q is scaled in f32 before the dot, as the TPU kernel does; the
// online softmax keeps the running max m, normaliser l and the (64 x D)
// accumulator in f32 across the key tiles.  The constants are the TPU
// kernel's: masked logits are -1e30 (never -inf, so exp(m_prev - m_new)
// never sees inf - inf), p is forced to 0 where a logit is <= -5e29, and
// l is clamped at 1e-20, so a query row with no live key (causal with
// Lq > Lk) comes out exactly 0.  The causal mask is bottom-right aligned:
// row i sees key j iff i + (Lk - Lq) >= j; key tiles wholly above the
// diagonal are skipped.
//
// Bound: at the BERT shapes (L = 128/512, D = 64) the work is about
// 4 * Lq * Lk * D operations against 4 * (Lq + 2 Lk) * D bytes per
// (b, h), so the f32 operations bound it, not the bytes.  This first
// version does the two products with FMA on the CUDA cores (no tensor
// cores: wgmma, TMA and a producer warp are later work) and keeps what
// the TPU kernel keeps out of device memory out of it: the (Lq, Lk)
// logits and probabilities live in registers and one (64 x 64) shared
// tile.  Each thread computes a 4 x 4 micro-tile of the logits and a
// 4 x ceil(D/16) tile of the output, so each shared load feeds 2 FMAs.
//
// Layout: one block of 256 threads per (b*h, 64-row query tile); the
// grid's x is b*h, its y the query tile.  Threads form a 16 x 16 grid:
// tx strides over keys (logits) and over D (output), ty over query rows
// (rows ty + 16 i).  A row's 64 logits sit in the 16 lanes of one half
// warp, so its max and sum are xor shuffles within it.  Q and K tiles sit
// transposed in shared memory with a padded stride (D x 65 floats), so
// the micro-tile loads are conflict-free broadcasts; V sits row-major.
// Lengths that are not multiples of 64 are masked here (keys past Lk
// take the -1e30 logit and zero V rows; rows past Lq are not stored),
// where the TPU version picks a block that divides the length.  q, k
// and v may be strided views (the heads split of MultiHeadAttention is
// a transpose): the (b, h, l) strides are arguments and D must be
// contiguous.  Shared memory is dynamic: (2 * D * 65 + 64 * D + 64 * 65)
// floats, 66 KB at D = 64 and 113 KB at D = 128, above the 48 KB that
// needs cudaFuncSetAttribute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;             // query rows per block
constexpr int kBK = 64;             // keys per tile
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

size_t smem_bytes(int d) {
  return sizeof(float) *
         (size_t)(d * (kBQ + 1) + d * (kBK + 1) + kBK * d + kBQ * (kBK + 1));
}

// NC = columns of D per thread (D <= 16 * NC); LSE: also write lse.
template <typename T, int NC, bool LSE>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o,
          float* __restrict__ lse, int heads, int lq,
          int lk, int d, int64_t sqb, int64_t sqh, int64_t sql, int64_t skb,
          int64_t skh, int64_t skl, int64_t svb, int64_t svh, int64_t svl,
          float sm_scale, int causal) {
  extern __shared__ float smem[];
  float* qs = smem;                   // [d][kBQ + 1]  q * sm_scale, transposed
  float* ks = qs + d * (kBQ + 1);     // [d][kBK + 1]  transposed
  float* vs = ks + d * (kBK + 1);     // [kBK][d]
  float* ps = vs + kBK * d;           // [kBQ][kBK + 1] probabilities

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = blockIdx.y * kBQ;
  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh;
  T* ob = o + (int64_t)bh * lq * d;   // out is contiguous (B, H, Lq, D)

  for (int idx = tid; idx < kBQ * d; idx += kThreads) {
    const int r = idx / d;
    const int c = idx - r * d;
    float x = 0.f;
    if (q0 + r < lq) x = to_f32(qb[(int64_t)(q0 + r) * sql + c]) * sm_scale;
    qs[c * (kBQ + 1) + r] = x;
  }

  // keys past kend are masked for every row of this tile
  const int off = lk - lq;
  int kend = lk;
  if (causal) {
    const int q_last = min(q0 + kBQ, lq) - 1;
    kend = min(lk, q_last + off + 1);
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();  // the last tile's reads of ks / vs / ps are done
    for (int idx = tid; idx < kBK * d; idx += kThreads) {
      const int r = idx / d;
      const int c = idx - r * d;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < lk) {
        kx = to_f32(kb[(int64_t)(k0 + r) * skl + c]);
        vx = to_f32(vb[(int64_t)(k0 + r) * svl + c]);
      }
      ks[c * (kBK + 1) + r] = kx;
      vs[r * d + c] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[c * (kBQ + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = ks[c * (kBK + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i + off;
      float mloc = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        if (kpos >= lk || (causal && qpos < kpos)) s[i][j] = kNegInf;
        mloc = fmaxf(mloc, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)  // the row's 16 lanes: a half warp
        mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, w));
      const float m_new = fmaxf(m[i], mloc);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p =
            s[i][j] <= 0.5f * kNegInf ? 0.f : expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = p;
        rsum += p;
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, w);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // keys at or past kend have p == 0 in every row: skip them
    const int jn = min(kBK, kend - k0);
    for (int j = 0; j < jn; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * (kBK + 1) + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        const float vv = col < d ? vs[j * d + col] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= lq) continue;
    const float denom = fmaxf(l[i], 1e-20f);
    // m and l are the same in the row's 16 lanes: one of them writes
    if (LSE && tx == 0) lse[(int64_t)bh * lq + r] = m[i] + logf(denom);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) ob[(int64_t)r * d + col] = from_f32<T>(acc[i][c] / denom);
    }
  }
}

// Lets a kernel instance use more than 48 KB of dynamic shared memory, once
// per instance and device (before any launch, so outside graph capture).
template <typename T, int NC, bool LSE>
cudaError_t allow_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_fwd<T, NC, LSE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes(kMaxD));
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <typename T, int NC, bool LSE>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int batch, int heads, int lq, int lk, int d, const int64_t* st,
           float sm_scale, int causal, cudaStream_t stream) {
  const cudaError_t err = allow_smem<T, NC, LSE>();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(batch * heads), (unsigned)((lq + kBQ - 1) / kBQ));
  flash_fwd<T, NC, LSE><<<grid, kThreads, smem_bytes(d), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, heads, lq, lk, d,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      sm_scale, causal);
  return (int)cudaGetLastError();
}

template <bool LSE>
int dispatch_fwd(const void* q, const void* k, const void* v, void* o,
                 float* lse, int dtype, int batch, int heads, int lq, int lk,
                 int d, const int64_t* st, float sm_scale, int causal,
                 void* stream) {
  if (d < 1 || d > kMaxD || lq < 1 || lk < 1 || batch < 1 || heads < 1 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if ((int64_t)batch * heads > 2147483647LL || (lq + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return d <= 64 ? launch<float, 4, LSE>(q, k, v, o, lse, batch, heads, lq,
                                           lk, d, st, sm_scale, causal, s)
                   : launch<float, 8, LSE>(q, k, v, o, lse, batch, heads, lq,
                                           lk, d, st, sm_scale, causal, s);
  return d <= 64 ? launch<__nv_bfloat16, 4, LSE>(q, k, v, o, lse, batch,
                                                 heads, lq, lk, d, st,
                                                 sm_scale, causal, s)
                 : launch<__nv_bfloat16, 8, LSE>(q, k, v, o, lse, batch,
                                                 heads, lq, lk, d, st,
                                                 sm_scale, causal, s);
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
