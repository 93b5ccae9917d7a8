// Embedding-bag forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel analytics_zoo_tpu/ops/embedding_bag.py
// ::_fwd_kernel.  Computes, per bag b of a (B, N) id block,
//
//   out[b] = scale_b * sum_j mask[b,j] * table[clip(ids[b,j], 0, V-1)]
//
// with mask = (ids != pad_id) (every slot when has_pad == 0) and scale_b
// 1 (sum), 1/max(cnt,1) (mean) or 1/sqrt(max(cnt,1)) (sqrtn).  f32 in,
// f32 accumulate, f32 out.
//
// Bound: memory.  The work is one read of each live row, the ids and one
// write of the output; the adds are negligible.  The design keeps the
// (B, N, D) gathered rows out of device memory, which is the point of
// the TPU kernel: one warp owns one bag, its lanes stride over D so each
// row read is coalesced, and the sum lives in registers.  Each warp
// reads its own ids (no scalar prefetch on this card).  D need not be a
// multiple of 4 or 32 (NCF has D = 20): lanes past D are masked.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kVec = 4;  // columns per lane per pass: 128 per warp pass

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
bag_fwd_f32(const float* __restrict__ table,
            const int32_t* __restrict__ ids, float* __restrict__ out,
            int64_t vocab, int dim, int64_t bags, int nnz, int has_pad,
            int32_t pad_id, int combiner) {
  const int lane = threadIdx.x & 31;
  const int64_t bag =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (bag >= bags) return;  // whole warp: one bag per warp
  const int32_t* bag_ids = ids + bag * (int64_t)nnz;

  float scale = 1.f;
  if (combiner != 0) {
    int cnt = 0;
    for (int j = lane; j < nnz; j += 32)
      cnt += (!has_pad || bag_ids[j] != pad_id) ? 1 : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
    const float n = fmaxf((float)cnt, 1.f);
    scale = 1.f / (combiner == 1 ? n : sqrtf(n));
  }

  float* out_row = out + bag * (int64_t)dim;
  for (int d0 = 0; d0 < dim; d0 += 32 * kVec) {
    float acc[kVec];
#pragma unroll
    for (int v = 0; v < kVec; ++v) acc[v] = 0.f;
    // unrolled so several slots' row loads are in flight at once
#pragma unroll 4
    for (int j = 0; j < nnz; ++j) {
      const int32_t raw = __ldg(bag_ids + j);
      if (has_pad && raw == pad_id) continue;
      const int64_t row = raw < 0 ? 0 : (raw >= vocab ? vocab - 1 : raw);
      const float* src = table + row * (int64_t)dim;
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        const int d = d0 + lane + 32 * v;
        if (d < dim) acc[v] += __ldg(src + d);
      }
    }
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      const int d = d0 + lane + 32 * v;
      if (d < dim) out_row[d] = acc[v] * scale;
    }
  }
}

}  // namespace

// combiner: 0 sum, 1 mean, 2 sqrtn.  Returns cudaGetLastError() after the
// launch (0 = launched).  The caller does not call with bags == 0.
extern "C" int zoo_embedding_bag_fwd_f32(const void* table, const void* ids,
                                         void* out, int64_t vocab, int dim,
                                         int64_t bags, int nnz, int has_pad,
                                         int pad_id, int combiner,
                                         void* stream) {
  const int64_t blocks = (bags + kWarpsPerBlock - 1) / kWarpsPerBlock;
  bag_fwd_f32<<<(unsigned)blocks, 32 * kWarpsPerBlock, 0,
                (cudaStream_t)stream>>>(
      (const float*)table, (const int32_t*)ids, (float*)out, vocab, dim,
      bags, nnz, has_pad, (int32_t)pad_id, combiner);
  return (int)cudaGetLastError();
}

extern "C" const char* zoo_embedding_bag_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
