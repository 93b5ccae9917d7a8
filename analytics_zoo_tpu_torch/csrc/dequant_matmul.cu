// Dequantize-matmul for Hopper (sm_90a): y = (x @ unpack(q)) * scale.
//
// Replaces the Pallas TPU kernel analytics_zoo_tpu/ops/dequant_matmul.py
// ::_dq_kernel.  x is (M, K) f32 row-major; q is int8 (K, N), or int4
// packed two to a byte along K ((K+1)/2, N): the low nibble is row 2k,
// the high nibble row 2k+1, both two's complement.  scale is (N,) f32,
// applied once after the K loop.  f32 accumulate, f32 out.
//
// Bound: at serving shapes (M <= 256, K = N = 40) the work is a few
// hundred kFLOP and the kernel is bound by its launch; at large M it is
// bound by f32 operations on the CUDA cores.  The design keeps the point
// of the TPU kernel — the f32 weight never exists in device memory:
// weight tiles travel as int8 bytes (or nibbles), are widened to f32 as
// they are staged into shared memory, and a 64x64 output tile per block
// accumulates in registers (4x4 per thread) over 32-deep K slices.
// Ragged M, N and K edges are masked.  wgmma, TMA and the int8 tensor
// cores are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int TM = 4, TN = 4;                       // outputs per thread
constexpr int kThreads = (BM / TM) * (BN / TN);     // 256

__device__ __forceinline__ int nibble(int byte, int hi) {
  // byte is the sign-extended int8; the high nibble is an arithmetic
  // shift, the low one is sign-extended from bit 3
  return hi ? (byte >> 4) : (((byte & 0xF) ^ 8) - 8);
}

__global__ void __launch_bounds__(kThreads)
dq_matmul_f32(const float* __restrict__ x, const int8_t* __restrict__ q,
              const float* __restrict__ scale, float* __restrict__ y,
              int M, int K, int N, int bits) {
  __shared__ float xs[BK][BM];
  __shared__ float ws[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile (BM x BK): consecutive threads read consecutive k; a
    // constant trip count, unrolled, so each thread's loads are in flight
    // together
#pragma unroll
    for (int r = 0; r < BM * BK / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int m = e / BK, k = e % BK;
      const int gm = m0 + m, gk = k0 + k;
      xs[k][m] = (gm < M && gk < K) ? x[(int64_t)gm * K + gk] : 0.f;
    }
    // weight tile (BK x BN): consecutive threads read consecutive bytes,
    // widened to f32 here
#pragma unroll
    for (int r = 0; r < BK * BN / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int k = e / BN, n = e % BN;
      const int gk = k0 + k, gn = n0 + n;
      float w = 0.f;
      if (gk < K && gn < N) {
        if (bits == 8) {
          w = (float)q[(int64_t)gk * N + gn];
        } else {
          w = (float)nibble((int)q[(int64_t)(gk >> 1) * N + gn], gk & 1);
        }
      }
      ws[k][n] = w;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[k][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[k][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < N) y[(int64_t)gm * N + gn] = acc[i][j] * scale[gn];
    }
  }
}

}  // namespace

// bits: 8 or 4.  Returns cudaGetLastError() after the launch (0 =
// launched), or cudaErrorInvalidConfiguration without launching when M
// needs more row tiles than the grid's y limit.  The caller does not call
// with M == 0 or N == 0.
extern "C" int zoo_dequant_matmul_f32(const void* x, const void* q,
                                      const void* scale, void* y, int M,
                                      int K, int N, int bits, void* stream) {
  constexpr int kGridYMax = 65535;
  if ((M + BM - 1) / BM > kGridYMax)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  dq_matmul_f32<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const int8_t*)q, (const float*)scale, (float*)y, M,
      K, N, bits);
  return (int)cudaGetLastError();
}

extern "C" const char* zoo_dequant_matmul_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
