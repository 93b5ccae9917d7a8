// Embedding-bag forward and backward for Hopper (sm_90a).
//
// Forward (bag_fwd): replaces the Pallas TPU kernel
// analytics_zoo_tpu/ops/embedding_bag.py::_fwd_kernel.  Computes, per bag
// b of a (B, N) id block,
//
//   out[b] = scale_b * sum_j mask[b,j] * table[clip(ids[b,j], 0, V-1)]
//
// with mask = (ids != pad_id) (every slot when has_pad == 0) and scale_b
// 1 (sum), 1/max(cnt,1) (mean) or 1/sqrt(max(cnt,1)) (sqrtn).  Tables of
// f32, bf16 and f16 sum in f32 and round once into the table's type (the
// JAX kernel's rule); f64 tables sum in f64.
//
// Bound: memory.  The work is one read of each distinct live row, the
// ids and one write of the output; the adds are negligible.  At the
// bench shape (V = 2^20, B = 4096, N = 32, D = 64 f32) that is about
// 33 MB, 0.0099 ms at 3.35 TB/s.  The TPU kernel hides the row latency by
// double-buffering row DMAs across bags.  Here a warp does the same with
// many 16-byte loads in flight:
//
// - Ids once, coalesced.  Lane t loads slot t of a 32-slot window of
//   ids, clips it and marks it live; __ballot_sync/__popc give the live
//   count (no second pass for mean and sqrtn), and each row index reaches
//   the loading lanes by __shfl_sync, so no row load waits on an id load
//   of its own.
// - 16-byte pieces, every lane busy.  A row is `pieces` pieces of P bytes
//   (16 unless the row's byte width or the table's address is off 16
//   bytes; then 8, 4 or 2).  The warp's lanes form `groups` slot groups
//   of `width` lanes, lane (group, piece): D = 64 f32 is 2 groups of 16
//   lanes, bf16 4 of 8, D = 20 f32 6 of 5 (2 lanes idle).  Where a bag has
//   fewer slots than groups (N = 1: NCF and every gather), the groups span
//   `bags_per_round` neighbouring bags, one slot each, and each lane reads
//   its slot's id itself (the window's ballot and shuffle would only add
//   latency before the one row load: 0.2 us at NCF's shapes on an H100);
//   rows wider than 32 pieces are taken 32 pieces at a time.  The host
//   computes this layout (ops/embedding_bag.py::bag_layout) and passes it
//   in.
// - Many rows in flight.  Each lane issues kFwd.depth piece loads into
//   registers before its first add; with the bench's 4096 bags all warps
//   are resident at once, so every row is in flight together.  (A
//   cp.async ring in shared memory across a warp's bags, the TPU
//   kernel's double buffer, timed level cold and slower warm.)
// - Reduce and store.  Each group sums its slots in f32 in slot order;
//   a bag's groups are summed by a shuffle tree (group s takes s + o for
//   o = 1, 2, 4, ... where s % 2o == 0), and its first group scales the
//   sum, rounds it once into the table's type and stores each piece with
//   one P-byte store.
//
// The grid runs along x over warps, each taking bags_per_round bags; bag,
// slot and row offsets are 64-bit (B up to 2^31 - 1 bags, V * D past 2^31
// elements).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

// The forward's knobs, timed by bag_shapes.py: piece loads in flight per
// lane, warps per block.
struct FwdShape {
  int depth, warps;
};
constexpr FwdShape kFwd = {4, 8};

constexpr unsigned kFull = 0xffffffffu;

// The lane layout of a row (see the file note); from the host.
struct BagLayout {
  int pieces;          // P-byte pieces per row
  int width;           // lanes per slot group: min(pieces, 32)
  int groups;          // slot groups per warp: 32 / width
  int per_bag;         // groups per bag: min(groups, max(N, 1))
  int bags_per_round;  // bags a warp takes: groups / per_bag
};

template <int P> struct PieceT;
template <> struct PieceT<16> { using type = uint4; };
template <> struct PieceT<8> { using type = uint2; };
template <> struct PieceT<4> { using type = uint32_t; };
template <> struct PieceT<2> { using type = uint16_t; };

template <typename T> struct AccT { using type = float; };
template <> struct AccT<double> { using type = double; };

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }
__device__ __forceinline__ double widen(double x) { return x; }

template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half narrow<__half>(float x) {
  return __float2half_rn(x);
}
template <typename T> __device__ __forceinline__ T narrow(double x) {
  return x;
}

// n / d for 0 <= n < 64 and 1 <= d <= 32 in float: (n + 0.5) / d sits at
// least 1/64 from an integer, far past __fdividef's error, so the
// truncation is exact (a runtime integer division is some 20 dependent
// instructions, on the path to a bag's first load).
__device__ __forceinline__ int small_div(int n, int d) {
  return (int)__fdividef((float)n + 0.5f, (float)d);
}

__device__ __forceinline__ float root(float x) { return sqrtf(x); }
__device__ __forceinline__ double root(double x) { return sqrt(x); }

template <typename T, int P, typename A>
__device__ __forceinline__ void add_piece(A (&acc)[P / sizeof(T)],
                                          const typename PieceT<P>::type& v) {
  T x[P / sizeof(T)];
  memcpy(x, &v, P);
#pragma unroll
  for (int e = 0; e < (int)(P / sizeof(T)); ++e) acc[e] += widen(x[e]);
}

// Loads the id window win[0, len): lane t's clipped row and the live
// mask; adds the live slots of bag bl's (of bags of nnz slots where the
// window holds several) to cnt.
__device__ __forceinline__ unsigned load_window(
    const int32_t* __restrict__ win, int len, int lane, int bl, int nnz,
    bool several, int64_t vocab, int has_pad, int32_t pad_id, int32_t& row,
    int& cnt) {
  bool live = false;
  row = 0;
  if (lane < len) {
    const int32_t raw = __ldg(win + lane);
    live = !has_pad || raw != pad_id;
    row = raw < 0 ? 0 : (raw >= vocab ? (int32_t)(vocab - 1) : raw);
  }
  const unsigned lm = __ballot_sync(kFull, live);
  cnt += __popc(several ? lm & (((1u << nnz) - 1u) << ((bl * nnz) & 31))
                        : lm);
  return lm;
}

// Sums a bag's groups onto its first group, scales, rounds and stores.
template <typename T, int P, typename A>
__device__ __forceinline__ void reduce_store(A (&acc)[P / sizeof(T)],
                                             const BagLayout& L, int sl,
                                             bool writes, int cnt,
                                             int combiner, T* dst) {
  constexpr int K = P / sizeof(T);
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    if (o >= L.per_bag) break;
#pragma unroll
    for (int e = 0; e < K; ++e) {
      const A v = __shfl_down_sync(kFull, acc[e], o * L.width);
      if ((sl & (2 * o - 1)) == 0 && sl + o < L.per_bag) acc[e] += v;
    }
  }
  if (!writes) return;
  A scale = 1;
  if (combiner != 0) {
    const A n = cnt > 1 ? (A)cnt : (A)1;
    scale = (A)1 / (combiner == 1 ? n : root(n));
  }
  T y[K];
#pragma unroll
  for (int e = 0; e < K; ++e) y[e] = narrow<T>(acc[e] * scale);
  typename PieceT<P>::type v;
  memcpy(&v, y, P);
  *reinterpret_cast<typename PieceT<P>::type*>(dst) = v;
}

// Two blocks per SM at least: without a minimum ptxas spills a few bytes
// at 48 registers in some instances.
template <typename T, int P>
__global__ void __launch_bounds__(32 * kFwd.warps, 2)
bag_fwd(const T* __restrict__ table, const int32_t* __restrict__ ids,
        T* __restrict__ out, int64_t vocab, int dim, int64_t bags, int nnz,
        int has_pad, int32_t pad_id, int combiner, BagLayout L) {
  using A = typename AccT<T>::type;
  using V = typename PieceT<P>::type;
  constexpr int K = P / sizeof(T);
  constexpr int kDepth = kFwd.depth;
  const int lane = threadIdx.x & 31;
  const int grp = small_div(lane, L.width), p = lane - grp * L.width;
  const int bl = small_div(grp, L.per_bag), sl = grp - bl * L.per_bag;
  // the warp's bags: b0 .. b0 + nb - 1, their ids one window of slots
  const int64_t b0 =
      ((int64_t)blockIdx.x * kFwd.warps + (threadIdx.x >> 5)) *
      L.bags_per_round;
  if (b0 >= bags) return;  // whole warp
  const int nb = (int)(bags - b0 < L.bags_per_round ? bags - b0
                                                     : L.bags_per_round);
  const int64_t slots = (int64_t)nb * nnz;
  const int32_t* win = ids + b0 * nnz;
  const bool mine = grp < L.groups && bl < nb;  // the lane has a bag
  T* dst = out + (b0 + bl) * (int64_t)dim + (int64_t)p * K;

  if (L.bags_per_round > 1) {
    // A bag has fewer slots than the warp has groups, so each group reads
    // one slot: its lanes load that slot's id themselves, since a window,
    // ballot and shuffle would only add latency before the one row load
    // (the window still counts live slots for mean and sqrtn).
    const int t = bl * nnz + sl;
    const bool in = mine && t < slots;
    const int32_t raw = in ? __ldg(win + t) : 0;
    const int32_t row =
        raw < 0 ? 0 : (raw >= vocab ? (int32_t)(vocab - 1) : raw);
    int cnt = 0;
    if (combiner != 0) {
      int32_t unused;
      load_window(win, (int)slots, lane, bl, nnz, true, vocab, has_pad,
                  pad_id, unused, cnt);
    }
    A acc[K] = {};
    if (in && (!has_pad || raw != pad_id))
      add_piece<T, P>(acc, __ldg(reinterpret_cast<const V*>(
                               table + (int64_t)row * dim + p * K)));
    reduce_store<T, P>(acc, L, sl, mine && sl == 0, cnt, combiner, dst);
    return;
  }
  // One bag (per_bag groups share its slots), 32 pieces of its rows at a
  // time; kDepth pieces per lane in registers, all issued before the
  // first add.
  for (int c0 = 0; c0 < L.pieces; c0 += L.width) {
    const bool on = mine && c0 + p < L.pieces;
    A acc[K] = {};
    int cnt = 0;
    int64_t s0 = 0;
    do {  // the 32-slot id windows; a bag of no slots has one
      const int len = (int)(slots - s0 < 32 ? slots - s0 : 32);
      int32_t row;
      const unsigned lm = load_window(win + s0, len, lane, 0, nnz, false,
                                      vocab, has_pad, pad_id, row, cnt);
      const int steps = max(1, small_div(len + L.per_bag - 1, L.per_bag));
      for (int k0 = 0; k0 < steps; k0 += kDepth) {
        V buf[kDepth];
#pragma unroll
        for (int u = 0; u < kDepth; ++u) {
          if (k0 + u >= steps) break;
          const int t = sl + L.per_bag * (k0 + u);
          const int32_t r = __shfl_sync(kFull, row, t & 31);
          const bool ok = on && t < len && ((lm >> t) & 1u);
          buf[u] = ok ? __ldg(reinterpret_cast<const V*>(
                            table + (int64_t)r * dim + (int64_t)(c0 + p) * K))
                      : V{};
        }
#pragma unroll
        for (int u = 0; u < kDepth; ++u) {
          if (k0 + u >= steps) break;
          add_piece<T, P>(acc, buf[u]);
        }
      }
    } while ((s0 += 32) < slots);
    reduce_store<T, P>(acc, L, sl, on && sl == 0, cnt, combiner,
                       dst + (int64_t)c0 * K);
  }
}

constexpr int kWarpsPerBlock = 8;
constexpr int kVec = 4;  // columns per lane per pass: 128 per warp pass

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
// g is f32 whatever the table's type (the JAX rule: g.astype(f32)).
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
// (bag * dim), each table row (row * dim) here and in bag_fwd, and the
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

template <typename T, int P>
int launch_fwd(const void* table, const void* ids, void* out, int64_t vocab,
               int dim, int64_t bags, int nnz, int has_pad, int pad_id,
               int combiner, const BagLayout& L, cudaStream_t stream) {
  const int64_t warps = (bags + L.bags_per_round - 1) / L.bags_per_round;
  const int64_t blocks = (warps + kFwd.warps - 1) / kFwd.warps;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  bag_fwd<T, P><<<(unsigned)blocks, 32 * kFwd.warps, 0, stream>>>(
      (const T*)table, (const int32_t*)ids, (T*)out, vocab, dim, bags, nnz,
      has_pad, (int32_t)pad_id, combiner, L);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd_piece(int piece, const void* table, const void* ids,
                     void* out, int64_t vocab, int dim, int64_t bags,
                     int nnz, int has_pad, int pad_id, int combiner,
                     const BagLayout& L, cudaStream_t stream) {
  switch (piece) {
    case 16:
      return launch_fwd<T, 16>(table, ids, out, vocab, dim, bags, nnz,
                               has_pad, pad_id, combiner, L, stream);
    case 8:
      return launch_fwd<T, 8>(table, ids, out, vocab, dim, bags, nnz,
                              has_pad, pad_id, combiner, L, stream);
    case 4:
      if constexpr (sizeof(T) <= 4)
        return launch_fwd<T, 4>(table, ids, out, vocab, dim, bags, nnz,
                                has_pad, pad_id, combiner, L, stream);
      break;
    case 2:
      if constexpr (sizeof(T) <= 2)
        return launch_fwd<T, 2>(table, ids, out, vocab, dim, bags, nnz,
                                has_pad, pad_id, combiner, L, stream);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 f32, 1 bf16, 2 f16, 3 f64.  combiner: 0 sum, 1 mean, 2 sqrtn.
// piece and the layout come from ops/embedding_bag.py (piece_bytes,
// bag_layout); returns cudaErrorInvalidValue, launching nothing, when
// they do not fit the table (a piece that does not divide the row's
// bytes or the table's address, a layout that is not the row's), and
// cudaErrorInvalidConfiguration when B needs more blocks than the grid's
// x limit; else cudaGetLastError() after the launch (0 = launched).  The
// caller does not call with bags == 0 or dim == 0.
extern "C" int zoo_embedding_bag_fwd(const void* table, const void* ids,
                                     void* out, int64_t vocab, int dim,
                                     int64_t bags, int nnz, int has_pad,
                                     int pad_id, int combiner, int dtype,
                                     int piece, int pieces, int width,
                                     int groups, int per_bag,
                                     int bags_per_round, void* stream) {
  static const int kElem[4] = {4, 2, 2, 8};
  if (dtype < 0 || dtype > 3 || vocab <= 0 || dim <= 0 || nnz < 0)
    return (int)cudaErrorInvalidValue;
  const int elem = kElem[dtype];
  const BagLayout L{pieces, width, groups, per_bag, bags_per_round};
  const bool fits =
      piece >= elem && piece <= 16 && (piece & (piece - 1)) == 0 &&
      ((uintptr_t)table % piece) == 0 && (int64_t)pieces * piece ==
      (int64_t)dim * elem && width == (pieces < 32 ? pieces : 32) &&
      groups == 32 / width && per_bag >= 1 && bags_per_round >= 1 &&
      per_bag * bags_per_round <= groups &&
      (bags_per_round == 1 || per_bag == nnz);
  if (!fits) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch_fwd_piece<float>(piece, table, ids, out, vocab, dim,
                                     bags, nnz, has_pad, pad_id, combiner, L,
                                     s);
    case 1:
      return launch_fwd_piece<__nv_bfloat16>(piece, table, ids, out, vocab,
                                             dim, bags, nnz, has_pad, pad_id,
                                             combiner, L, s);
    case 2:
      return launch_fwd_piece<__half>(piece, table, ids, out, vocab, dim,
                                      bags, nnz, has_pad, pad_id, combiner,
                                      L, s);
    default:
      return launch_fwd_piece<double>(piece, table, ids, out, vocab, dim,
                                      bags, nnz, has_pad, pad_id, combiner,
                                      L, s);
  }
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
