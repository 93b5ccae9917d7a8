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

// Embedding-bag backward (dTable), deterministic.
//
// Replaces the Pallas TPU kernel analytics_zoo_tpu/ops/embedding_bag.py
// ::_bwd_kernel.  For every live slot s = (b, j) of the (B, N) id block,
//
//   dtab[clip(ids[b,j], 0, V-1)] += scale_b * g[b]
//
// into a fresh (V, D) f32 gradient.  Liveness and scale_b are the
// forward's (the gradient of this file's forward): a slot is live unless
// has_pad and ids == pad_id, and scale_b is recomputed from the live
// count, bit for bit as bag_fwd computes it.  g is f32 whatever the
// table's type (the JAX rule: g.astype(f32)).
//
// The TPU kernel walks the slots in order on one core, so duplicate ids
// add in slot order.  Blocks on this card run in no order, and float
// atomics would sum duplicates in an order that changes from run to run
// (graphed and eager training part).  Here every add has a place fixed
// by the ids alone, and no float atomic is used.  Three ways, picked from
// the shapes by ops/embedding_bag.py::bag_bwd_plan:
//
// - tile (B * N at most kTileSlots, rows of at most 32 pieces): one
//   kernel, bag_bwd_tile.  Each block owns a range of rows, keeps the
//   slots that land in it in slot order, groups them by row with a stable
//   counting sort in shared memory and writes each of its rows once, the
//   row's slots added in slot order (the TPU kernel's order).
// - lists (larger problems): a memset of the counters, then
//   (a) bag_bwd_chunk: one block per chunk of kChunk consecutive slots
//       (and split of the columns).  It sorts its (row, slot) keys
//       (bitonic in each warp, then ranks across warps; dead slots last),
//       so each row's slots form one run, and walkers of 16 or 32 lanes
//       walk fixed ranges of the sorted positions in order, lanes over the
//       columns, summing each run in slot order (a run that crosses
//       walkers is finished from their carry-outs, in walker order).  The
//       run's sum is partial p = chunk * kChunk + run, prow[p] its row.  A
//       row takes at most one partial per chunk, so a hot row (the pad
//       row of front-padded text: about 25,000 of 64,000 slots) is
//       pre-summed by every chunk at once.  It counts each row's partials
//       and each scan tile's (integer atomics).
//   (b) bag_bwd_scan turns the counts into row ends (the earlier tiles'
//       sums, then a block scan); bag_bwd_place puts each partial's index
//       in its row's list (atomicSub on the end: the atomics' order).
//   (c) bag_bwd_rows writes the rows of at most two partials (zeros, or
//       0.0f + the partials in chunk order) and queues the others;
//       bag_bwd_heavy sums those in chunk order (a bitmap of the row's
//       chunks in shared memory gives the order), a warp per row of up to
//       kWarpRows partials, a block per longer row.
// - owned (lists, where V lies between B * N and 64 B * N, so most rows
//   take all their slots from one chunk): bag_bwd_count first counts
//   each row's slots; a run that holds all of its row's slots is written
//   straight into dtab by the chunk pass, leaving no partial, and the
//   rows pass leaves that row alone.
//
// Every row of dtab is written once, zeros included (no zero-fill of V *
// D), and the same inputs give the same bits on every run, eager or
// replayed in a graph: a tile row adds its slots in slot order; a lists
// row adds its chunks' run sums in chunk order from 0.0f.

// Bound: memory.  The work reads g (B*D*4) and the ids (B*N*4) and
// writes dtab (V*D*4); in the lists way partials add at most B*N*D*4
// written and read back (as many as distinct (row, chunk) pairs, fewer
// where rows are owned), and the counters 4 (V + tiles) bytes each way.
// The caller sizes every workspace from the shapes alone
// (ops/embedding_bag.py::bag_bwd_plan) and allocates it; nothing here
// allocates, synchronises or copies to the host, so the whole backward
// captures into a graph.
// Offsets of rows and partials are 64-bit: V * D past 2^31 is taken;
// B * N must stay below 2^31.

constexpr int kChunk = 256;                 // slots (= threads) per chunk
constexpr int kChunkWarps = kChunk / 32;
constexpr int kChunkBits = 8;               // log2(kChunk)
constexpr int kColBlock = 256;              // columns per shared tail block
constexpr int kTargetBlocks = 4 * 132;      // chunk blocks to fill the card
constexpr int kTileRowsMax = 256;           // most rows per block, tile way
constexpr int kTileWarps = 16;              // warps per block, tile way
constexpr int kTileSlots = 16384;           // the tile way's most slots
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 8;
constexpr int kScanTile = kScanThreads * kScanItems;  // counters per block
constexpr int kRowWarps = 8;
constexpr int kHeavyBlocks = 2 * 132;       // blocks of the heavy-row pass
constexpr int kWindow = 512;                // chunks per heavy-row window
constexpr int kWarpRows = 32;               // most partials a warp's row
constexpr int kHeavyLoads = 8;              // partial loads in flight
constexpr uint32_t kDead = 0xffffffffu;     // the sort key of a dead slot
constexpr unsigned char kOwned = 1;         // a row's state: the chunk's
constexpr unsigned char kHasPartials = 2;   // ... or the rows pass's

template <int VW>
__device__ __forceinline__ void load_vec(float (&v)[VW], const float* p) {
  if constexpr (VW == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else if constexpr (VW == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  } else {
    v[0] = *p;
  }
}

template <int VW>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[VW]) {
  if constexpr (VW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VW == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// store_vec, marked streaming: the rows are not read again here.
template <int VW>
__device__ __forceinline__ void stream_vec(float* p, const float (&v)[VW]) {
  if constexpr (VW == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (VW == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    __stcs(p, v[0]);
  }
}

__device__ __forceinline__ uint32_t clip_row(int32_t raw, int64_t vocab) {
  return raw < 0 ? 0u : (raw >= vocab ? (uint32_t)(vocab - 1)
                                       : (uint32_t)raw);
}

// Block (chunk, split): the chunk's kChunk slots, column pieces
// [split * per_split, ...).  Split 0 also writes prow and the counts.
template <int VW>
__global__ void __launch_bounds__(kChunk, 4)
bag_bwd_chunk(const int32_t* __restrict__ ids, const float* __restrict__ g,
              int g_vec, float* __restrict__ partials,
              int32_t* __restrict__ prow, int32_t* __restrict__ counts,
              int32_t* __restrict__ tile_sums,
              const int32_t* __restrict__ slotcnt, float* __restrict__ dtab,
              int64_t vocab, int dim, int64_t slots, int nnz, int has_pad,
              int32_t pad_id, int combiner, int per_split) {
  __shared__ unsigned long long skey[kChunk];
  __shared__ uint32_t srow[kChunk];
  __shared__ int sslot[kChunk];
  __shared__ int sowned[kChunk];          // by slot: its row's slot count
  __shared__ int sstart[kChunk];
  __shared__ float sscale[kChunk];
  __shared__ int sheads[kChunkWarps];
  __shared__ int64_t soff[kChunk];        // by position: the g row's offset
  __shared__ float ssc[kChunk];           // ... its scale
  __shared__ int sinfo[kChunk];           // ... run | tail | live | spans
  __shared__ int sopen[2 * kChunkWarps];  // the run ending a span: its info
  __shared__ uint32_t sopen_row[2 * kChunkWarps];  // ... and its row
  __shared__ float stail[2 * kChunkWarps][kColBlock];  // a walker's carry
  __shared__ float shead[2 * kChunkWarps][kColBlock];  // a span's last part
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t s0 = (int64_t)blockIdx.x * kChunk;
  const int64_t b0 = s0 / nnz;
  uint32_t key = kDead;
  if (s0 + t < slots) {
    const int32_t raw = __ldg(ids + s0 + t);
    if (!has_pad || raw != pad_id) key = clip_row(raw, vocab);
  }
  // owned rows: the key's slot count, in flight across the sort (kept by
  // slot, read back through the sorted position's slot)
  if (slotcnt != nullptr)
    sowned[t] = key != kDead ? __ldg(slotcnt + key) : 0;
  if (combiner != 0) {
    // scale of bag b0 + t, for the bags this chunk's slots belong to
    const int64_t b = b0 + t;
    const int64_t last = (s0 + kChunk < slots ? s0 + kChunk : slots) - 1;
    if (b <= last / nnz) {
      const int32_t* bi = ids + b * nnz;
      int cnt = 0;
      for (int j = 0; j < nnz; ++j)
        cnt += (!has_pad || __ldg(bi + j) != pad_id) ? 1 : 0;
      const float n = fmaxf((float)cnt, 1.f);  // the forward's rule
      sscale[t] = 1.f / (combiner == 1 ? n : sqrtf(n));
    }
  }
  // sort the distinct keys (row, slot): a bitonic sort in each warp, then
  // each key's rank in every other warp's sorted keys by binary search
  unsigned long long k64 = ((unsigned long long)key << kChunkBits) | t;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const unsigned long long o = __shfl_xor_sync(kFull, k64, j);
      const bool keep_min = ((lane & j) == 0) == ((lane & k) == 0);
      k64 = keep_min ? (o < k64 ? o : k64) : (o > k64 ? o : k64);
    }
  }
  skey[t] = k64;
  __syncthreads();
  int rank = lane;
#pragma unroll
  for (int w = 0; w < kChunkWarps; ++w) {
    if (w == warp) continue;
    const unsigned long long* sk = skey + w * 32;
    int lo = 0;
#pragma unroll
    for (int step = 16; step > 0; step >>= 1)
      if (sk[lo + step - 1] < k64) lo += step;
    rank += lo + (sk[lo] < k64 ? 1 : 0);
  }
  srow[rank] = (uint32_t)(k64 >> kChunkBits);
  sslot[rank] = (int)(k64 & (kChunk - 1));
  __syncthreads();

  // thread t now holds sorted position t
  const uint32_t row = srow[t];
  const bool live = row != kDead;
  const bool head = t == 0 || srow[t - 1] != row;
  const bool tail = t == kChunk - 1 || srow[t + 1] != row;
  const unsigned heads = __ballot_sync(kFull, head);
  if (lane == 0) sheads[warp] = __popc(heads);
  __syncthreads();
  int before = 0, runs = 0;
#pragma unroll
  for (int w = 0; w < kChunkWarps; ++w) {
    runs += sheads[w];
    before += w < warp ? sheads[w] : 0;
  }
  const int run = before + __popc(heads & (kFull >> (31 - lane))) - 1;
  if (head) sstart[run] = t;
  const int live_runs = runs - (srow[kChunk - 1] == kDead ? 1 : 0);
  // walkers: eight of 32 lanes over 32 positions each, or, for rows of
  // at most 16 pieces, sixteen of 16 lanes over 16 positions
  const int pieces = dim / VW;
  const int walkers = pieces <= 16 ? 2 * kChunkWarps : kChunkWarps;
  const int per = kChunk / walkers, lanes = 32 * kChunkWarps / walkers;
  if (t < 2 * kChunkWarps) sopen[t] = -1;
  __syncthreads();
  {
    const int first = sstart[run] / per, mine_w = t / per;
    const int64_t bag = live ? (s0 + sslot[t]) / nnz : 0;
    soff[t] = bag * (int64_t)dim;
    ssc[t] = (combiner != 0 && live) ? sscale[bag - b0] : 1.f;
    const bool spans = tail && live && first < mine_w;
    // owned: the chunk holds every slot of the row, so the run's sum is
    // the row's gradient and goes straight into dtab
    const bool owned = tail && live && slotcnt != nullptr &&
                       sowned[sslot[t]] == t - sstart[run] + 1;
    sinfo[t] = (run << 8) | (owned ? 128 : 0) | (first << 3) |
               (spans ? 4 : 0) | (live ? 2 : 0) | (tail ? 1 : 0);
    if (spans) {  // one a walker at most
      sopen[mine_w] = sinfo[t];
      sopen_row[mine_w] = row;
    }
  }
  __syncthreads();

  // each walker walks its positions in order, lanes over the columns:
  // each run's slots add in slot order; a run's sum is written at its
  // tail, or, for a run that began in an earlier walker, kept in shead
  // (its part here) beside the earlier walkers' carry-outs in stail
  const int wk = warp * (walkers / kChunkWarps) + lane / lanes;
  const int lw = lane % lanes;
  const int q_begin = blockIdx.y * per_split;
  const int q_end = min(pieces, q_begin + per_split);
  const int pos0 = wk * per;
  for (int c0 = q_begin; c0 < q_end; c0 += kColBlock / VW) {
    const int c1 = min(q_end, c0 + kColBlock / VW);
    for (int qb = c0; qb < c1; qb += lanes) {
      const int q = qb + lw;
      const bool on = q < c1;
      const int col = (q - c0) * VW;
      float acc[VW];
#pragma unroll
      for (int e = 0; e < VW; ++e) acc[e] = 0.f;
#pragma unroll 1
      for (int i0 = 0; i0 < per; i0 += 8) {
        float x[8][VW];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int pos = pos0 + i0 + u;
          const int info = sinfo[pos];
          if (on && (info & 2)) {
            const float* src = g + soff[pos] + q * VW;
            if (g_vec) {
              load_vec<VW>(x[u], src);
            } else {
#pragma unroll
              for (int e = 0; e < VW; ++e) x[u][e] = __ldg(src + e);
            }
            const float sc = ssc[pos];
#pragma unroll
            for (int e = 0; e < VW; ++e) x[u][e] *= sc;
          } else {
#pragma unroll
            for (int e = 0; e < VW; ++e) x[u][e] = 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int info = sinfo[pos0 + i0 + u];
#pragma unroll
          for (int e = 0; e < VW; ++e) acc[e] += x[u][e];
          if (info & 1) {  // a tail: the run, or its part here, is summed
            if (on && (info & 2)) {
              if (info & 4) {
#pragma unroll
                for (int e = 0; e < VW; ++e) shead[wk][col + e] = acc[e];
              } else {
                float* dst =
                    info & 128 ? dtab + (int64_t)srow[pos0 + i0 + u] * dim
                               : partials + (s0 + (info >> 8)) * dim;
                store_vec<VW>(dst + q * VW, acc);
              }
            }
#pragma unroll
            for (int e = 0; e < VW; ++e) acc[e] = 0.f;
          }
        }
      }
      if (on && !(sinfo[pos0 + per - 1] & 1))  // the run goes on past
#pragma unroll
        for (int e = 0; e < VW; ++e) stail[wk][col + e] = acc[e];
    }
    __syncthreads();
    const int open = sopen[wk];
    if (open >= 0) {
      // the run that ends this walker's span: the carry-outs of the
      // walkers it began in and went through, in order, then its part here
      const int fw = (open >> 3) & 15;
      float* dst = open & 128 ? dtab + (int64_t)sopen_row[wk] * dim
                              : partials + (s0 + (open >> 8)) * dim;
      for (int q = c0 + lw; q < c1; q += lanes) {
        const int col = (q - c0) * VW;
        float acc[VW];
#pragma unroll
        for (int e = 0; e < VW; ++e) acc[e] = 0.f;
        for (int w = fw; w < wk; ++w)
#pragma unroll
          for (int e = 0; e < VW; ++e) acc[e] += stail[w][col + e];
#pragma unroll
        for (int e = 0; e < VW; ++e) acc[e] += shead[wk][col + e];
        store_vec<VW>(dst + q * VW, acc);
      }
    }
    __syncthreads();
  }
  if (blockIdx.y != 0) return;
  // the partials (live runs, less owned ones) before each position
  const bool part = tail && live && !(sinfo[t] & 128);
  const unsigned pm = __ballot_sync(kFull, part);
  if (lane == 0) sheads[warp] = __popc(pm);
  __syncthreads();
  int before_p = __popc(pm & ((1u << lane) - 1u));
  for (int w = 0; w < warp; ++w) before_p += sheads[w];
  if (tail && live) {
    prow[s0 + run] = part ? (int32_t)row : -1;  // owned rows: none
    if (part) atomicAdd(counts + row, 1);
    // the chunk's runs of one scan tile are neighbours: the tile's first
    // run subtracts the partials before it, its last adds those up to
    // and with it
    const uint32_t tile = row / kScanTile;
    const int at = sstart[run];
    const bool first = at == 0 || srow[at - 1] / kScanTile != tile;
    const bool last = t == kChunk - 1 || srow[t + 1] == kDead ||
                      srow[t + 1] / kScanTile != tile;
    const int delta = (last ? before_p + (part ? 1 : 0) : 0) -
                      (first ? before_p : 0);
    if ((first || last) && delta != 0) atomicAdd(tile_sums + tile, delta);
  }
  if (t >= live_runs) prow[s0 + t] = -1;
}

// Adds, in order, the n partials whose indices `entry(j)` gives (j < n,
// n the same across the warp) into acc, column piece q of each; L loads
// in flight.  `on` masks the lanes past the row's pieces; every lane
// calls it (entry may shuffle).
template <int VW, int L, typename Entry>
__device__ __forceinline__ void add_partials(float (&acc)[VW], int n,
                                             Entry entry, bool on,
                                             const float* partials, int dim,
                                             int q) {
  for (int j0 = 0; j0 < n; j0 += L) {
    float x[L][VW];
#pragma unroll
    for (int u = 0; u < L; ++u) {
      const int j = j0 + u;
      const int e = j < n ? entry(j) : 0;
      if (on && j < n)
        load_vec<VW>(x[u], partials + (int64_t)e * dim + q * VW);
    }
#pragma unroll
    for (int u = 0; u < L; ++u)
      if (on && j0 + u < n)
#pragma unroll
        for (int e = 0; e < VW; ++e) acc[e] += x[u][e];
  }
}

// Owned rows: each row's live slots, counted (integer atomics, one a
// group of equal rows in a warp).
__global__ void __launch_bounds__(256)
bag_bwd_count(const int32_t* __restrict__ ids, int32_t* __restrict__ slotcnt,
              int64_t slots, int64_t vocab, int has_pad, int32_t pad_id) {
  const int lane = threadIdx.x & 31;
  const int64_t s = (int64_t)blockIdx.x * 256 + threadIdx.x;
  int row = -1;
  if (s < slots) {
    const int32_t raw = __ldg(ids + s);
    if (!has_pad || raw != pad_id) row = (int)clip_row(raw, vocab);
  }
  const unsigned peers = __match_any_sync(kFull, row);
  if (row >= 0 && (peers & ((1u << lane) - 1u)) == 0)
    atomicAdd(slotcnt + row, __popc(peers));
}

// The tile way's load of entry j (< k) of a row's slots: scale_b * g[b]
// at column piece pl, or zeros past k.
template <int VW, bool Comb>
__device__ __forceinline__ void tile_load(
    float (&x)[VW], int j, int k, const int* byrow, const int32_t* ids,
    const float* g, int g_vec, int nnz, int has_pad, int32_t pad_id,
    int combiner, int dim, int pl) {
#pragma unroll
  for (int e = 0; e < VW; ++e) x[e] = 0.f;
  if (j >= k) return;
  const int b = byrow[j] / nnz;
  float sc = 1.f;
  if (Comb) {  // the forward's rule, bit for bit
    int cnt = 0;
    for (int i = 0; i < nnz; ++i)
      cnt += (!has_pad || __ldg(ids + b * nnz + i) != pad_id) ? 1 : 0;
    const float nf = fmaxf((float)cnt, 1.f);
    sc = 1.f / (combiner == 1 ? nf : sqrtf(nf));
  }
  const float* src = g + (int64_t)b * dim + pl * VW;
  if (g_vec) {
    load_vec<VW>(x, src);
  } else {
#pragma unroll
    for (int e = 0; e < VW; ++e) x[e] = __ldg(src + e);
  }
  if (Comb)
#pragma unroll
    for (int e = 0; e < VW; ++e) x[e] *= sc;
}

// The tile way (B * N at most kTileSlots): one kernel.  Block i owns the
// `rows` rows from rows * i (64, or 256 for a large table).  It stages
// every id in shared memory (16-byte loads); each warp walks its part of
// the slots in order, 32 at a time, and keeps (compacting in place, by
// ballot) the live slots whose clipped row is one of the block's, with a
// count per (warp, row); a scan of those counts in (row, warp) order and
// one more pass (ranks among equal rows by __match_any_sync) place the
// kept slots grouped by row, in slot order within a row.  Then lane
// groups of `width` lanes write each row once: zeros, or the sum of
// scale_b * g[b] over its slots in slot order (the TPU kernel's order),
// two rows' first four loads in flight together; a row of one piece takes
// eight lanes, each summing every eighth of its slots in order, added by a
// butterfly.
template <int VW, bool Comb>
__global__ void __launch_bounds__(32 * kTileWarps, Comb ? 1 : 2)
bag_bwd_tile(const int32_t* __restrict__ ids, const float* __restrict__ g,
             int g_vec, float* __restrict__ dtab, int64_t vocab, int dim,
             int slots, int nnz, int has_pad, int32_t pad_id, int combiner,
             int width, int groups, int rows) {
  extern __shared__ int smem[];
  int* kept = smem;           // the ids, then each warp's kept slots
  int* byrow = smem + slots;  // the kept slots grouped by row
  __shared__ int scnt[kTileWarps][kTileRowsMax];  // per (warp, row)
  __shared__ int sstart[kTileRowsMax + 1];       // each row's first
  __shared__ int sw[kTileWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t r0 = (int64_t)blockIdx.x * rows;
  if (((uintptr_t)ids & 15) == 0) {  // every load in flight at once
    const int n4 = slots >> 2;
#pragma unroll
    for (int j = 0; j < kTileSlots / 4 / (32 * kTileWarps); ++j) {
      const int i = j * 32 * kTileWarps + t;
      if (i < n4)
        reinterpret_cast<int4*>(kept)[i] =
            __ldg(reinterpret_cast<const int4*>(ids) + i);
    }
    for (int i = 4 * n4 + t; i < slots; i += 32 * kTileWarps)
      kept[i] = __ldg(ids + i);
  } else {
#pragma unroll 16
    for (int i = t; i < slots; i += 32 * kTileWarps) kept[i] = __ldg(ids + i);
  }
  for (int i = t; i < kTileWarps * kTileRowsMax; i += 32 * kTileWarps)
    (&scnt[0][0])[i] = 0;
  __syncthreads();

  // each warp keeps, in order, its slots' (row - r0) << 16 | slot
  const int per = ((slots + kTileWarps - 1) / kTileWarps + 31) & ~31;
  const int lo = min(slots, warp * per), hi = min(slots, lo + per);
  const unsigned below = (1u << lane) - 1u;
  int n = 0;
  const int top = (int)(vocab - 1), base = (int)r0;  // V < 2^31 here
  for (int b0 = lo; b0 < hi; b0 += 128) {  // four steps of 32 slots
    int d[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int s = b0 + 32 * u + lane;
      d[u] = -1;
      if (s < hi) {
        const int32_t raw = kept[s];
        const int dr = (raw < 0 ? 0 : min(raw, top)) - base;
        if ((!has_pad || raw != pad_id) && (unsigned)dr < (unsigned)rows)
          d[u] = dr;
      }
    }
    __syncwarp();  // every read of the four steps before a write
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const unsigned m = __ballot_sync(kFull, d[u] >= 0);
      if (d[u] >= 0) {
        kept[lo + n + __popc(m & below)] = (d[u] << 16) | (b0 + 32 * u + lane);
        atomicAdd(&scnt[warp][d[u]], 1);
      }
      n += __popc(m);
    }
  }
  if (lane == 0) sw[warp] = n;
  __syncthreads();
  // row starts, then each (warp, row)'s first place, in (row, warp) order
  if (t < rows) {
    int c = 0;
#pragma unroll
    for (int w = 0; w < kTileWarps; ++w) c += scnt[w][t];
    sstart[t] = c;
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the rows' counts, 8 rows a lane
    int c[kTileRowsMax / 32], mine = 0;
#pragma unroll
    for (int i = 0; i < kTileRowsMax / 32; ++i) {
      const int r = lane * (kTileRowsMax / 32) + i;
      c[i] = r < rows ? sstart[r] : 0;
      mine += c[i];
    }
    int x = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    int at = x - mine;
#pragma unroll
    for (int i = 0; i < kTileRowsMax / 32; ++i) {
      const int r = lane * (kTileRowsMax / 32) + i;
      if (r < rows) sstart[r] = at;
      at += c[i];
    }
    if (lane == 31) sstart[rows] = x;
  }
  __syncthreads();
  if (t < rows) {
    int at = sstart[t];
#pragma unroll
    for (int w = 0; w < kTileWarps; ++w) {
      const int c = scnt[w][t];
      scnt[w][t] = at;
      at += c;
    }
  }
  __syncthreads();
  // each warp places its kept slots, in order
  const int nk = sw[warp];
  for (int i0 = 0; i0 < nk; i0 += 32) {
    const bool on = i0 + lane < nk;
    const int v = on ? kept[lo + i0 + lane] : -1;
    const int d = on ? v >> 16 : -1;
    const unsigned peers = __match_any_sync(kFull, d);
    if (on) byrow[scnt[warp][d] + __popc(peers & below)] = v & 0xffff;
    __syncwarp();
    if (on && (peers & below) == 0) scnt[warp][d] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // rows of one piece: eight lanes a row, each over every eighth slot,
  // added by a fixed butterfly; wider rows: `width` lanes, one piece each
  const bool one = width == 1;
  const int lpr = one ? 8 : width;              // lanes a row
  const int rpw = one ? 4 : groups;             // rows a warp
  const int grp = lane / lpr, pl = one ? 0 : lane - grp * lpr;
  const int split = one ? lane & 7 : 0, stride = one ? 8 : 1;
  // two rows a lane group at a time: both rows' first loads in flight
  // together (four each), any further ones row by row
  const int sweep = kTileWarps * rpw;
  for (int rb = warp * rpw; rb < rows; rb += 2 * sweep) {
    int a[2], k[2];
    int64_t rr[2];
    bool act[2];
    float acc[2][VW], x[2][4][VW];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = rb + h * sweep + grp;
      rr[h] = r0 + rl;
      act[h] = grp < rpw && rl < rows && rr[h] < vocab;
      a[h] = act[h] ? sstart[rl] : 0;
      k[h] = act[h] ? sstart[rl + 1] - a[h] : 0;
#pragma unroll
      for (int e = 0; e < VW; ++e) acc[h][e] = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        tile_load<VW, Comb>(x[h][u], split + u * stride, k[h], byrow + a[h],
                            ids, g, g_vec, nnz, has_pad, pad_id, combiner,
                            dim, pl);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (split + u * stride < k[h])
#pragma unroll
          for (int e = 0; e < VW; ++e) acc[h][e] += x[h][u][e];
      for (int j0 = split + 4 * stride; j0 < k[h]; j0 += 4 * stride) {
        float y[4][VW];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          tile_load<VW, Comb>(y[u], j0 + u * stride, k[h], byrow + a[h],
                              ids, g, g_vec, nnz, has_pad, pad_id, combiner,
                              dim, pl);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (j0 + u * stride < k[h])
#pragma unroll
            for (int e = 0; e < VW; ++e) acc[h][e] += y[u][e];
      }
      if (one) {
#pragma unroll
        for (int o = 1; o < 8; o <<= 1)
#pragma unroll
          for (int e = 0; e < VW; ++e)
            acc[h][e] += __shfl_xor_sync(kFull, acc[h][e], o);
      }
      if (act[h] && split == 0 && pl < dim / VW)
        store_vec<VW>(dtab + rr[h] * (int64_t)dim + pl * VW, acc[h]);
    }
  }
}

// counts[0, n) := the inclusive sums of counts, in place (n = V + 1, the
// last counter 0, so it ends as the number of partials).  Each block
// takes a tile of kScanTile counters: the earlier tiles' sums
// (tile_sums, from bag_bwd_chunk), then a block scan.
__global__ void __launch_bounds__(kScanThreads)
bag_bwd_scan(int32_t* __restrict__ counts,
             const int32_t* __restrict__ tile_sums,
             const int32_t* __restrict__ slotcnt, uint8_t* __restrict__ state,
             int64_t n) {
  __shared__ int sw[kScanThreads / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t base = (int64_t)blockIdx.x * kScanTile + t * kScanItems;
  int c[kScanItems];
  if (base + kScanItems <= n) {  // counts sits on 256 bytes: int4 loads
    const int4 a = *reinterpret_cast<const int4*>(counts + base);
    const int4 b = *reinterpret_cast<const int4*>(counts + base + 4);
    c[0] = a.x; c[1] = a.y; c[2] = a.z; c[3] = a.w;
    c[4] = b.x; c[5] = b.y; c[6] = b.z; c[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < kScanItems; ++e)
      c[e] = base + e < n ? counts[base + e] : 0;
  }
  // each row's state for the rows pass: kHasPartials, kOwned (no
  // partial, a slot: the chunk pass wrote it) or 0 (no slot)
  {
    int own[kScanItems] = {};
    if (slotcnt != nullptr) {  // on 16 bytes: int4 loads
      if (base + kScanItems <= n - 1) {
        const int4 a = __ldg(reinterpret_cast<const int4*>(slotcnt + base));
        const int4 b =
            __ldg(reinterpret_cast<const int4*>(slotcnt + base) + 1);
        own[0] = a.x; own[1] = a.y; own[2] = a.z; own[3] = a.w;
        own[4] = b.x; own[5] = b.y; own[6] = b.z; own[7] = b.w;
      } else {
        for (int e = 0; e < kScanItems; ++e)
          own[e] = base + e < n - 1 ? __ldg(slotcnt + base + e) : 0;
      }
    }
    unsigned char st[kScanItems];
#pragma unroll
    for (int e = 0; e < kScanItems; ++e)
      st[e] = c[e] != 0 ? kHasPartials : (own[e] != 0 ? kOwned : 0);
    if (base + kScanItems <= n) {
      uint2 v;
      memcpy(&v, st, sizeof(v));
      *reinterpret_cast<uint2*>(state + base) = v;
    } else {
      for (int e = 0; e < kScanItems; ++e)
        if (base + e < n) state[base + e] = st[e];
    }
  }
  int pre = 0;
  for (int i = t; i < (int)blockIdx.x; i += kScanThreads)
    pre += __ldg(tile_sums + i);
  int mine = 0;
#pragma unroll
  for (int e = 0; e < kScanItems; ++e) mine += c[e];
  // the earlier tiles' sum and the exclusive scan of the threads' sums,
  // in one pass: warp sums and scans, then the warps' totals
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) pre += __shfl_xor_sync(kFull, pre, o);
  int x = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  __shared__ int spre[kScanThreads / 32];
  if (lane == 31) {
    sw[warp] = x;
    spre[warp] = pre;
  }
  __syncthreads();
  int acc = x - mine;
#pragma unroll
  for (int w = 0; w < kScanThreads / 32; ++w)
    acc += spre[w] + (w < warp ? sw[w] : 0);
#pragma unroll
  for (int e = 0; e < kScanItems; ++e) {
    acc += c[e];
    c[e] = acc;
  }
  if (base + kScanItems <= n) {
    reinterpret_cast<int4*>(counts + base)[0] =
        make_int4(c[0], c[1], c[2], c[3]);
    reinterpret_cast<int4*>(counts + base)[1] =
        make_int4(c[4], c[5], c[6], c[7]);
  } else {
#pragma unroll
    for (int e = 0; e < kScanItems; ++e)
      if (base + e < n) counts[base + e] = c[e];
  }
}

// Each partial's index into its row's list: the row's end counts down.
__global__ void __launch_bounds__(256)
bag_bwd_place(const int32_t* __restrict__ prow, int32_t* __restrict__ ends,
              int32_t* __restrict__ list, int64_t cap) {
  const int64_t p = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (p >= cap) return;
  const int32_t r = __ldg(prow + p);
  if (r < 0) return;
  list[atomicSub(ends + r, 1) - 1] = (int32_t)p;
}

// The lists way's light rows: a warp per `tile` rows, 8 or 32 (starts[r]
// .. starts[r + 1] is row r's list; state[r] says whether the row has
// partials, or is owned).  Rows of no slot are written as zeros (a tile
// of them streamed, reading nothing else), owned rows are left to the
// chunk pass, rows of one or two partials are written as 0.0f + them in
// chunk order, `groups` rows at a time (width lanes each), four rounds of
// loads in flight; rows of three or more go to the heavy queues.
template <int VW>
__global__ void __launch_bounds__(32 * kRowWarps)
bag_bwd_rows(const int32_t* __restrict__ starts,
             const int32_t* __restrict__ list,
             const float* __restrict__ partials, float* __restrict__ dtab,
             int32_t* __restrict__ heavy, int32_t* __restrict__ n_heavy,
             const uint8_t* __restrict__ state, int heavy_cap,
             int64_t vocab, int dim, int width, int groups, int tile) {
  const int lane = threadIdx.x & 31;
  const int grp = small_div(lane, width), pl = lane - grp * width;
  const int64_t r0 =
      ((int64_t)blockIdx.x * kRowWarps + (threadIdx.x >> 5)) * tile;
  const int64_t r = r0 + lane;
  const int pieces = dim / VW;
  const int st = lane < tile && r < vocab ? __ldg(state + r) : 0;
  if (r0 + tile <= vocab && __ballot_sync(kFull, st != 0) == 0) {
    // no row of the tile has a slot: stream its zeros, which lie in one
    // piece of dtab, reading nothing else
    const float z[VW] = {};
    float* dst = dtab + r0 * dim;
    for (int i = lane; i < tile * pieces; i += 32)
      stream_vec<VW>(dst + i * VW, z);
    return;
  }
  // e, f: the row's partials in chunk order (-1 none); e = -2: not
  // written here (out of range, or three partials or more: queued)
  int k = 0, e = -2, f = -1;
  if (lane < tile && r < vocab && st != kOwned) {  // owned: written
    int s = 0;
    if (st == kHasPartials) {
      s = __ldg(starts + r);
      k = __ldg(starts + r + 1) - s;
    }
    if (k <= 2) {
      e = k >= 1 ? __ldg(list + s) : -1;
      if (k == 2) {
        const int o = __ldg(list + s + 1);
        f = max(e, o);
        e = min(e, o);
      }
    }
  }
  // rows of 3 .. kWarpRows partials queue at the front of heavy (a warp
  // each), longer ones at its back (a block each)
  const unsigned below = (1u << lane) - 1u;
  const unsigned ha = __ballot_sync(kFull, k >= 3 && k <= kWarpRows);
  const unsigned hb = __ballot_sync(kFull, k > kWarpRows);
  if (ha | hb) {
    int base_a = 0, base_b = 0;
    if (lane == 0) {
      if (ha) base_a = atomicAdd(n_heavy, __popc(ha));
      if (hb) base_b = atomicAdd(n_heavy + 1, __popc(hb));
    }
    base_a = __shfl_sync(kFull, base_a, 0);
    base_b = __shfl_sync(kFull, base_b, 0);
    if ((ha >> lane) & 1u) heavy[base_a + __popc(ha & below)] = (int32_t)r;
    if ((hb >> lane) & 1u)
      heavy[heavy_cap - 1 - base_b - __popc(hb & below)] = (int32_t)r;
  }
  constexpr int kRounds = 4;
  for (int j0 = 0; j0 < tile; j0 += kRounds * groups) {
    for (int qb = 0; qb < pieces; qb += width) {
      const int q = qb + pl;
      float x[kRounds][VW], y[kRounds][VW];
      int ej[kRounds], fj[kRounds];
#pragma unroll
      for (int u = 0; u < kRounds; ++u) {
        const int j = j0 + u * groups + grp;
        ej[u] = __shfl_sync(kFull, e, j & 31);
        fj[u] = __shfl_sync(kFull, f, j & 31);
        if (grp >= groups || j >= tile || q >= pieces) ej[u] = -2;
        if (ej[u] >= 0)
          load_vec<VW>(x[u], partials + (int64_t)ej[u] * dim + q * VW);
        if (ej[u] >= 0 && fj[u] >= 0)
          load_vec<VW>(y[u], partials + (int64_t)fj[u] * dim + q * VW);
      }
#pragma unroll
      for (int u = 0; u < kRounds; ++u) {
        if (ej[u] == -2) continue;
        float acc[VW];
#pragma unroll
        for (int i = 0; i < VW; ++i) acc[i] = 0.f;
        if (ej[u] >= 0)
#pragma unroll
          for (int i = 0; i < VW; ++i) acc[i] += x[u][i];
        if (ej[u] >= 0 && fj[u] >= 0)
#pragma unroll
          for (int i = 0; i < VW; ++i) acc[i] += y[u][i];
        stream_vec<VW>(dtab + (r0 + j0 + u * groups + grp) * dim + q * VW,
                       acc);
      }
    }
  }
}

// Marks the partials of list[s, s + k) whose chunk lies in [w0, w0 +
// kWindow) in bits (one bit per chunk) with each one's run in its chunk
// (run), from `n` threads numbered `me`, and returns nothing; the caller
// syncs, then seq() reads the bits in chunk order.
__device__ __forceinline__ void mark_window(const int32_t* list, int s,
                                            int k, int w0, int me, int n,
                                            unsigned* bits,
                                            unsigned char* run) {
  for (int i = me; i < k; i += n) {
    const int p = __ldg(list + s + i);
    const int c = (p >> kChunkBits) - w0;
    if (c >= 0 && c < kWindow) {
      atomicOr(&bits[c >> 5], 1u << (c & 31));
      run[c] = (unsigned char)(p & (kChunk - 1));
    }
  }
}

// One warp: the marked partials' indices, in chunk order, into seq;
// returns how many (every lane).
__device__ __forceinline__ int window_seq(int w0, const unsigned* bits,
                                          const unsigned char* run,
                                          int* seq) {
  const int lane = threadIdx.x & 31;
  int total = 0;
  for (int wb = 0; wb < kWindow / 32; wb += 32) {
    unsigned m = wb + lane < kWindow / 32 ? bits[wb + lane] : 0u;
    const int cnt = __popc(m);
    int pos = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, pos, o);
      if (lane >= o) pos += y;
    }
    const int here = __shfl_sync(kFull, pos, 31);
    pos += total - cnt;
    while (m) {
      const int c = (wb + lane) * 32 + __ffs(m) - 1;
      m &= m - 1;
      seq[pos++] = ((w0 + c) << kChunkBits) | run[c];
    }
    total += here;
  }
  return total;
}

// The heavy rows: those of more than kWarpRows partials first, a block
// each (its warps sum fixed eighths of the chunk-ordered sequence, and
// warp 0 adds the eighths in order), then those of 3 .. kWarpRows, a
// warp per (row, 32 column pieces).  A row's list holds one partial of
// each of its chunks, in the atomics' order; for each window of kWindow
// chunks the list's chunks are marked in a bitmap in shared memory (with
// each partial's run in its chunk) and read back in chunk order (a
// prefix count of the words' bits), and the partials are added in that
// order, kHeavyLoads loads in flight.
template <int VW>
__global__ void __launch_bounds__(32 * kRowWarps, 1)
bag_bwd_heavy(const int32_t* __restrict__ starts,
              const int32_t* __restrict__ list,
              const float* __restrict__ partials, float* __restrict__ dtab,
              const int32_t* __restrict__ heavy,
              const int32_t* __restrict__ n_heavy, int heavy_cap, int dim,
              int chunks) {
  __shared__ unsigned sbits[kRowWarps][kWindow / 32];
  __shared__ unsigned char srun[kRowWarps][kWindow];
  __shared__ int sseq[kRowWarps][kWindow];
  __shared__ float spart[kRowWarps][32 * VW];
  __shared__ int stotal;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int pieces = dim / VW;
  // block rows: the shared arrays of warp 0 hold the row's window
  const int nb = n_heavy[1];
  for (int i = blockIdx.x; i < nb; i += gridDim.x) {
    const int64_t r = __ldg(heavy + heavy_cap - 1 - i);
    const int s = __ldg(starts + r);
    const int k = __ldg(starts + r + 1) - s;
    float* dst = dtab + r * (int64_t)dim;
    for (int w0 = 0; w0 < chunks; w0 += kWindow) {
      for (int j = t; j < kWindow / 32; j += 32 * kRowWarps)
        sbits[0][j] = 0u;
      __syncthreads();
      mark_window(list, s, k, w0, t, 32 * kRowWarps, sbits[0], srun[0]);
      __syncthreads();
      if (warp == 0) {
        const int n = window_seq(w0, sbits[0], srun[0], sseq[0]);
        if (lane == 0) stotal = n;
      }
      __syncthreads();
      const int total = stotal;
      const int a = (int)((int64_t)total * warp / kRowWarps);
      const int e = (int)((int64_t)total * (warp + 1) / kRowWarps);
      for (int q0 = 0; q0 < pieces; q0 += 32) {
        const int q = q0 + lane;
        float acc[VW];
#pragma unroll
        for (int v = 0; v < VW; ++v) acc[v] = 0.f;
        add_partials<VW, kHeavyLoads>(
            acc, e - a, [&](int j) { return sseq[0][a + j]; }, q < pieces,
            partials, dim, q);
#pragma unroll
        for (int v = 0; v < VW; ++v) spart[warp][lane * VW + v] = acc[v];
        __syncthreads();
        if (warp == 0 && q < pieces) {
          float sum[VW];
          if (w0 == 0) {
#pragma unroll
            for (int v = 0; v < VW; ++v) sum[v] = 0.f;
          } else {
            load_vec<VW>(sum, dst + q * VW);  // the earlier windows' sum
          }
          for (int w = 0; w < kRowWarps; ++w)
#pragma unroll
            for (int v = 0; v < VW; ++v) sum[v] += spart[w][lane * VW + v];
          store_vec<VW>(dst + q * VW, sum);
        }
        __syncthreads();
      }
    }
  }
  // warp rows
  const int passes = (pieces + 31) / 32;
  const int64_t items = (int64_t)n_heavy[0] * passes;
  for (int64_t it = blockIdx.x * kRowWarps + warp; it < items;
       it += gridDim.x * kRowWarps) {
    const int64_t r = __ldg(heavy + it / passes);
    const int q = (int)(it % passes) * 32 + lane;
    const bool on = q < pieces;
    const int s = __ldg(starts + r);
    const int k = __ldg(starts + r + 1) - s;
    float acc[VW];
#pragma unroll
    for (int e = 0; e < VW; ++e) acc[e] = 0.f;
    for (int w0 = 0; w0 < chunks; w0 += kWindow) {
      for (int j = lane; j < kWindow / 32; j += 32) sbits[warp][j] = 0u;
      __syncwarp();
      mark_window(list, s, k, w0, lane, 32, sbits[warp], srun[warp]);
      __syncwarp();
      const int total = window_seq(w0, sbits[warp], srun[warp], sseq[warp]);
      __syncwarp();
      add_partials<VW, kHeavyLoads>(
          acc, total, [&](int j) { return sseq[warp][j]; }, on, partials,
          dim, q);
      __syncwarp();
    }
    if (on) store_vec<VW>(dtab + r * (int64_t)dim + q * VW, acc);
  }
}

template <int VW>
int launch_bwd(const int32_t* ids, const float* g, float* dtab,
               int64_t vocab, int dim, int64_t bags, int nnz, int has_pad,
               int32_t pad_id, int combiner, bool tile, bool owned,
               float* partials, int32_t* prow, int32_t* counters,
               int32_t* list, int32_t* heavy, uint8_t* state,
               cudaStream_t stream) {
  const int64_t slots = bags * nnz;
  const int g_vec = ((uintptr_t)g % (sizeof(float) * VW)) == 0;
  const int pieces = dim / VW;
  const int width = pieces < 32 ? pieces : 32;
  const int groups = 32 / width;
  if (tile) {
    static bool big_shared = false;  // once per instance, not a stream op
    if (!big_shared) {
      cudaError_t set = cudaFuncSetAttribute(
          bag_bwd_tile<VW, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          2 * kTileSlots * (int)sizeof(int));
      if (set == cudaSuccess)
        set = cudaFuncSetAttribute(
            bag_bwd_tile<VW, true>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            2 * kTileSlots * (int)sizeof(int));
      if (set != cudaSuccess) return (int)set;
      big_shared = true;
    }
    // rows a block: 64, or more (up to kTileRowsMax) to keep to about two
    // blocks an SM
    const int64_t want = (vocab + 2 * 132 - 1) / (2 * 132);
    const int rows =
        (int)(want < 64 ? 64 : (want > kTileRowsMax ? kTileRowsMax : want));
    const unsigned blocks = (unsigned)((vocab + rows - 1) / rows);
    const size_t shared = 2 * slots * sizeof(int);
    if (combiner != 0)
      bag_bwd_tile<VW, true><<<blocks, 32 * kTileWarps, shared, stream>>>(
          ids, g, g_vec, dtab, vocab, dim, (int)slots, nnz, has_pad, pad_id,
          combiner, width, groups, rows);
    else
      bag_bwd_tile<VW, false><<<blocks, 32 * kTileWarps, shared, stream>>>(
          ids, g, g_vec, dtab, vocab, dim, (int)slots, nnz, has_pad, pad_id,
          combiner, width, groups, rows);
    return (int)cudaGetLastError();
  }
  const int64_t chunks = (slots + kChunk - 1) / kChunk;
  const int64_t tiles = (vocab + 1 + kScanTile - 1) / kScanTile;
  // counters: the V + 1 row counts, the tiles' sums, the two heavy
  // counts, and for owned rows the V slot counts from the next 16 bytes
  const int64_t lead = vocab + 3 + tiles;       // before slotcnt
  const int64_t slot_at = (lead + 3) / 4 * 4;     // on 16 bytes
  int32_t* counts = counters;
  int32_t* tile_sums = counters + vocab + 1;
  int32_t* n_heavy = tile_sums + tiles;
  int32_t* slotcnt = owned ? counters + slot_at : nullptr;
  const cudaError_t zero = cudaMemsetAsync(
      counters, 0, (size_t)(owned ? slot_at + vocab : lead) * sizeof(int32_t),
      stream);
  if (zero != cudaSuccess) return (int)zero;
  if (owned)
    bag_bwd_count<<<(unsigned)((slots + 255) / 256), 256, 0, stream>>>(
        ids, slotcnt, slots, vocab, has_pad, pad_id);
  // split the columns (passes of 32 pieces) across blocks where the
  // chunks leave SMs idle
  const int passes = (pieces + 31) / 32;
  const int64_t want = (kTargetBlocks + chunks - 1) / chunks;
  const int splits = (int)(want < passes ? want : passes);
  const int per_split = (passes + splits - 1) / splits * 32;
  bag_bwd_chunk<VW><<<dim3((unsigned)chunks, (unsigned)splits), kChunk, 0,
                       stream>>>(
      ids, g, g_vec, partials, prow, counts, tile_sums, slotcnt, dtab, vocab,
      dim, slots, nnz, has_pad, pad_id, combiner, per_split);
  const int64_t cap = chunks * kChunk;
  const int heavy_cap = (int)(vocab < cap / 2 ? vocab : cap / 2);
  bag_bwd_scan<<<(unsigned)tiles, kScanThreads, 0, stream>>>(
      counts, tile_sums, slotcnt, state, vocab + 1);
  bag_bwd_place<<<(unsigned)((cap + 255) / 256), 256, 0, stream>>>(
      prow, counts, list, cap);
  const int rows_tile = vocab >= (1 << 17) ? 32 : 8;  // rows per warp
  const int64_t rows_per_block = (int64_t)rows_tile * kRowWarps;
  const int64_t row_blocks = (vocab + rows_per_block - 1) / rows_per_block;
  bag_bwd_rows<VW><<<(unsigned)row_blocks,
                     32 * kRowWarps, 0, stream>>>(
      counts, list, partials, dtab, heavy, n_heavy, state, heavy_cap, vocab,
      dim, width, groups, rows_tile);
  bag_bwd_heavy<VW><<<kHeavyBlocks, 32 * kRowWarps, 0, stream>>>(
      counts, list, partials, dtab, heavy, n_heavy, heavy_cap, dim,
      (int)chunks);
  return (int)cudaGetLastError();
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

// route: 1 tile, 2 lists, 3 lists with owned rows (ops/embedding_bag.py
// ::bag_bwd_plan picks it from the shapes and sizes the workspace; the
// tile way takes none).  For lists: partials (chunks * kChunk * dim f32),
// prow and list (chunks * kChunk int32 each), counters (V + 3 + tiles
// int32, and for owned rows V more from the next 16 bytes, zeroed here on
// `stream`), heavy
// (min(V, chunks * kChunk / 2) int32) and state (V + 1 bytes).  dtab (V, D)
// f32 is written whole.  Returns cudaErrorInvalidValue, launching
// nothing, when a shape is out of range (V or B * N past 2^31 - 2^8, a
// non-positive size) or the route does not take it; else
// cudaGetLastError() after the launches (0 = launched).
extern "C" int zoo_embedding_bag_bwd(const void* ids, const void* g,
                                     void* dtab, int64_t vocab, int dim,
                                     int64_t bags, int nnz, int has_pad,
                                     int pad_id, int combiner, int route,
                                     void* partials, void* prow,
                                     void* counters, void* list,
                                     void* heavy, void* state,
                                     void* stream) {
  constexpr int64_t kMax = 2147483647LL - kChunk;
  if (vocab <= 0 || vocab > kMax || dim <= 0 || bags <= 0 || nnz <= 0 ||
      bags > kMax / nnz || route < 1 || route > 3)
    return (int)cudaErrorInvalidValue;
  const int vw = dim % 4 == 0 ? 4 : (dim % 2 == 0 ? 2 : 1);
  const bool tile = route == 1;
  if (tile && (bags * nnz > kTileSlots || dim / vw > 32))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define ZOO_BWD_ARGS                                                       \
  (const int32_t*)ids, (const float*)g, (float*)dtab, vocab, dim, bags,    \
      nnz, has_pad, (int32_t)pad_id, combiner, tile, route == 3,           \
      (float*)partials,                                                    \
      (int32_t*)prow, (int32_t*)counters, (int32_t*)list, (int32_t*)heavy, \
      (uint8_t*)state, s
  if (vw == 4) return launch_bwd<4>(ZOO_BWD_ARGS);
  if (vw == 2) return launch_bwd<2>(ZOO_BWD_ARGS);
  return launch_bwd<1>(ZOO_BWD_ARGS);
#undef ZOO_BWD_ARGS
}

extern "C" const char* zoo_embedding_bag_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
