// Embedding-bag forward and backward for Hopper (sm_90a).
//
// Forward: replaces the Pallas TPU kernel
// analytics_zoo_tpu/ops/embedding_bag.py::_fwd_kernel.  Computes, per bag
// b of a (B, N) id block,
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

// Embedding-bag backward (dTable scatter).
//
// Replaces the Pallas TPU kernel analytics_zoo_tpu/ops/embedding_bag.py
// ::_bwd_kernel.  For every live slot (b, j) of the (B, N) id block,
//
//   dtab[clip(ids[b,j], 0, V-1)] += scale_b * g[b]
//
// into a (V, D) f32 buffer the C entry point zero-fills first.  Liveness
// and scale_b are the forward's (the gradient of this file's forward):
// a slot is live unless has_pad and ids == pad_id, and scale_b is
// recomputed here from the live count, so no (B, 1) scale tensor exists.
//
// Bound: memory.  The (V, D) zero-fill writes V*D*4 bytes, and the
// scatter reads g (B*D*4) and the ids (B*N*4); for NCF and the bench
// shapes the fill is the larger term.  The TPU kernel serialises the
// read-modify-write of each row so duplicate ids stay exact; blocks on
// this card run in parallel in no order, so the adds are f32 atomics
// (with the result unused they compile to `red`) and duplicate ids sum in
// a run-dependent order.  One warp owns one bag, its lanes stride over D
// holding scale_b * g[b] in registers across the bag's slots; lanes past
// D are masked (NCF has D = 20).  A sort-and-segment deterministic
// version is later work.
//
// Tables of 2^31 elements or more (8 GiB in f32: V = 2^25 rows of 64) are
// taken: every offset is 64-bit -- the bag's ids (bag * nnz), its g row
// (bag * dim), each table row (row * dim) here and in bag_fwd_f32, and the
// zero-fill's byte count in the entry point.
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
bag_bwd_f32(const int32_t* __restrict__ ids, const float* __restrict__ g,
            float* __restrict__ dtab, int64_t vocab, int dim, int64_t bags,
            int nnz, int has_pad, int32_t pad_id, int combiner) {
  const int lane = threadIdx.x & 31;
  const int64_t bag =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (bag >= bags) return;  // whole warp: one bag per warp
  const int32_t* bag_ids = ids + bag * (int64_t)nnz;

  float scale = 1.f;  // the forward's rule, bit for bit
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

  const float* g_row = g + bag * (int64_t)dim;
  for (int d0 = 0; d0 < dim; d0 += 32 * kVec) {
    float gv[kVec];
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      const int d = d0 + lane + 32 * v;
      gv[v] = d < dim ? __ldg(g_row + d) * scale : 0.f;
    }
    for (int j = 0; j < nnz; ++j) {
      const int32_t raw = __ldg(bag_ids + j);
      if (has_pad && raw == pad_id) continue;
      const int64_t row = raw < 0 ? 0 : (raw >= vocab ? vocab - 1 : raw);
      float* dst = dtab + row * (int64_t)dim;
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        const int d = d0 + lane + 32 * v;
        if (d < dim) atomicAdd(dst + d, gv[v]);
      }
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

// dtab (V, D) f32 is zero-filled on `stream` (cudaMemsetAsync), then the
// scatter runs on the same stream; V * D may pass 2^31.  Returns, without
// touching dtab, cudaErrorInvalidValue when V or D is not positive and
// cudaErrorInvalidConfiguration when B needs more blocks than the grid's
// x limit; else cudaGetLastError() after the launch (0 = launched).  The
// caller does not call with bags == 0.
extern "C" int zoo_embedding_bag_bwd_f32(const void* ids, const void* g,
                                         void* dtab, int64_t vocab, int dim,
                                         int64_t bags, int nnz, int has_pad,
                                         int pad_id, int combiner,
                                         void* stream) {
  if (vocab <= 0 || dim <= 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (bags + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  const cudaError_t fill = cudaMemsetAsync(
      dtab, 0, (size_t)(vocab * (int64_t)dim) * sizeof(float),
      (cudaStream_t)stream);
  if (fill != cudaSuccess) return (int)fill;
  bag_bwd_f32<<<(unsigned)blocks, 32 * kWarpsPerBlock, 0,
                (cudaStream_t)stream>>>(
      (const int32_t*)ids, (const float*)g, (float*)dtab, vocab, dim, bags,
      nnz, has_pad, (int32_t)pad_id, combiner);
  return (int)cudaGetLastError();
}

extern "C" const char* zoo_embedding_bag_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
