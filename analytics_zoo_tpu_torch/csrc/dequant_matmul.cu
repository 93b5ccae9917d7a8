// Dequantize-matmul for Hopper (sm_90a) on the tensor cores:
// y = (x @ unpack(q)) * scale.
//
// Replaces the Pallas TPU kernel analytics_zoo_tpu/ops/dequant_matmul.py
// ::_dq_kernel (launched by _dq_forward).  x is (M, K) row-major f32,
// bf16 or f16; q is int8 (K, N), or int4 packed two to a byte along K
// ((K+1)/2, N): the low nibble is row 2k, the high nibble row 2k+1, both
// two's complement.  scale is (N,) f32, applied once after the K loop.
// f32 accumulation; y in x's type.  As in the TPU kernel, no widened copy
// of the weight ever exists in device memory: weight tiles travel as
// bytes or nibbles and are widened in registers.
//
// Numeric contract:
// - Every weight is an integer, exact in bf16 and f16 (int8 |v| <= 127,
//   int4 -8..7), widened by integer bit tricks (mma_tiles.cuh).
// - f32 x: x = x0 + x1 + x2, three bf16 pieces (x0 = bf16(x), x1 =
//   bf16(x - x0), x2 = bf16(x - x0 - x1); split_bf16x2_3) that hold all
//   of its 24 bits; each xi . w is an exact product, summed on the tensor
//   cores into the f32 accumulator, small pieces first.  x0 alone misses
//   the f32 tolerance (about 2e-3 of the largest output at K = 4096).
//   Two pieces (16 bits) were 1.15 (wgmma) to 1.4 (mma.sync) times
//   faster at K = 4096, where the tensor cores' own accumulation sets the
//   error against the exact product (about 1e-5 of the largest output,
//   with two pieces or three), but at NCF's K = 40 they left 10 times the
//   error of three and missed the served model's check against the plain
//   path (dq_shapes.py, chip_smoke.py; PERF.md).
// - bf16 x: one exact bf16 product; f16 x: one exact f16 product.  The
//   TPU kernel widens x to f32 and multiplies in f32, which gives the
//   same exact products.
//
// Bound.  2 M N K operations against M K x elements, K N (int8) or K N / 2
// (int4) weight bytes and M N outputs: from M of a few hundred up the
// operations bound it.  f32 x at the rate of its three bf16 products
// per product on the tensor cores, 989 / 3 = 330 TFLOP/s (the CUDA
// cores' f32 rate is 67); bf16 and f16 x at 989 TFLOP/s; bytes at
// 3.35 TB/s.
// At the serving shapes (M <= 256, K = N = 40) a launch bounds it.
//
// Design, and what each choice does about that bound.  Two kernels, both
// on the tensor cores:
// - dq_wgmma, for problems of a wave of 128 x 128 tiles or more with rows
//   of x and q on 16 bytes (the host picks): the warpgroup product wgmma
//   computes y^T = W^T . x^T, so the widened weight is wgmma's register
//   A operand (no widened copy in shared memory either) and x is its
//   K-major B operand, read from shared memory in the 128-byte swizzle.
//   A block of WGS warpgroups (64 output columns each) shares one tile
//   of 128 rows of x; a larger WGS cuts the L2 traffic per product.  f32
//   x is split into its bf16 pieces once per block (not once per warp),
//   into three swizzled tiles.  With in_flight = 1 the products of one K
//   slice run while the next is split and widened.
// - dq_mma, for the rest (the serving shapes, rows off 16 bytes):
//   mma.sync m16n8k16 with a BM x BN tile per block and MT x NT tiles of
//   16 x 8 per warp, the weight widened straight into B fragments.
// - Asynchronous copies: x and q tiles go through a ring of shared
//   stages filled by 16-byte cp.async (dq_mma also 8-, 4-byte or plain
//   copies for rows off 16 bytes), later slices in flight while one
//   multiplies, one block barrier per slice (two for f32 x on wgmma).
//   Weights move at their stored 1 or 1/2 byte per element.
// - Weight fragments without a shuffle: ldmatrix.trans on the byte tile,
//   read as 16-bit pairs of neighbouring columns, hands each thread rows
//   (2t, 2t+1) of columns 2g and 2g+1: for int8 exactly the 16-bit
//   fragment of two 8-column tiles, one of even and one of odd columns
//   (wgmma's A; dq_mma's B).  For int4, dq_mma permutes the tile's k
//   order (mma k 2t, 2t+1, 2t+8, 2t+9 are stored rows 4t, 4t+2, 4t+1,
//   4t+3) and reads x in the same order, so one 16-byte (f32) or 8-byte
//   load of x row g, columns 4t..4t+3, feeds its A fragment; dq_wgmma,
//   whose x order is fixed, has ldmatrix name the packed rows in the order
//   0, 4, 1, 5, 2, 6, 3, 7, so a thread's bytes hold k 2t, 2t+1 and
//   2t+8, 2t+9.  The even/odd column tiles give each thread neighbouring
//   output columns: 16-, 8- or 4-byte stores.
// - Conflict-free shared reads: weight rows of BN + 16 bytes (ldmatrix's
//   8 rows on distinct banks); dq_mma's x rows padded by 8 (int8: 8-byte
//   f32 reads, ldmatrix for 16-bit x) or 16 (int4: 16- or 8-byte reads)
//   elements; dq_wgmma's x in the swizzle.
// - Straight-line products: every fragment loop has compile-time bounds.
// - Ragged M, N and K: copies past the edge are zero-filled (rows of x
//   past M, columns past K; weight rows past K, or past (K+1)/2 packed,
//   columns past N), so the odd-K int4 tile's last nibble meets a zero x
//   column as the TPU kernel's zero padding does; stores are masked.
// - Any M: the tiles are numbered along one grid dimension (2^31 - 1).
// The shapes (WgShape per x type, kMmaShape) were timed against each
// other on the card with dq_shapes.py.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tiles.cuh"

namespace {

using namespace zoo_mma;

// dq_mma's tile: block BM x BN, K slice BK, WM x WN warps, ring stages
struct Cfg {
  int bm, bn, bk, wm, wn, stages;
};
constexpr Cfg kMmaShape = {32, 32, 64, 2, 1, 2};

// dq_wgmma's shape per x type: warpgroups per block (64 output columns
// each), ring stages, and K slices whose products may still run while
// the next slice is prepared (0 or 1)
struct WgCfg {
  int warpgroups, stages, in_flight;
};
template <typename T>
struct WgShape {
  static constexpr WgCfg k = {4, 4, 1};
};
template <>
struct WgShape<float> {
  static constexpr WgCfg k = {4, 3, 0};
};

// bf16 pieces of an f32 x: 3 keep all 24 bits, 2 keep 16 (the note
// above)
constexpr int kPieces = 3;

// The raw element a tile copy moves.
template <int BYTES>
struct Raw;
template <>
struct Raw<1> { using type = uint8_t; };
template <>
struct Raw<2> { using type = uint16_t; };
template <>
struct Raw<4> { using type = uint32_t; };

// Copies a ROWS x COLS tile from global rows src + r * stride into shared
// rows dst + r * S (strides in elements of type E), zero-filling rows at
// or past `rows` and columns at or past `cols`.  vec is the copy width in
// bytes: 16, 8 or 4 through cp.async (it divides cols * sizeof(E), the
// base address and the stride), or anything less for plain element loads
// and stores.  Called by all NTH threads of the block.
template <typename E, int ROWS, int COLS, int S, int NTH>
__device__ __forceinline__ void load_tile_zfill(E* dst, const E* src,
                                                int64_t stride, int rows,
                                                int cols, int vec, int tid) {
  if (vec == 16) {  // the common case: constant chunk count
    constexpr int kCe = 16 / (int)sizeof(E), kCpr = COLS / kCe;
    constexpr int kTotal = ROWS * kCpr;
#pragma unroll
    for (int j = 0; j < (kTotal + NTH - 1) / NTH; ++j) {
      const int i = tid + j * NTH;
      if (kTotal % NTH == 0 || i < kTotal) {
        const int r = i / kCpr, c = (i % kCpr) * kCe;
        const bool ok = r < rows && c < cols;
        cp_async<16>(smem_u32(dst + r * S + c),
                     ok ? src + r * stride + c : src, ok ? 16 : 0);
      }
    }
    return;
  }
  if (vec >= 4) {
    const int ce = vec / (int)sizeof(E), cpr = COLS / ce;
    for (int i = tid; i < ROWS * cpr; i += NTH) {
      const int r = i / cpr, c = (i - r * cpr) * ce;
      const bool ok = r < rows && c < cols;
      const E* g = ok ? src + r * stride + c : src;
      const uint32_t s = smem_u32(dst + r * S + c);
      if (vec == 8)
        cp_async<8>(s, g, ok ? 8 : 0);
      else
        cp_async<4>(s, g, ok ? 4 : 0);
    }
    return;
  }
  for (int i = tid; i < ROWS * COLS; i += NTH) {
    const int r = i / COLS, c = i - r * COLS;
    dst[r * S + c] = (r < rows && c < cols) ? src[r * stride + c] : E(0);
  }
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float a, float b);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float a, float b) {
  return bf16x2_bits(__floats2bfloat162_rn(a, b));
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float a, float b) {
  const __half2 h = __floats2half2_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

template <int BITS, bool F16>
__device__ __forceinline__ void weight_fragments(uint32_t src0, uint32_t src1,
                                                 uint32_t (&b)[2][2]) {
  // b[p][i]: the B fragment register i of the n8 tile of parity p
  if constexpr (BITS == 8) {  // src0: k rows 2t, 2t+1; src1: 8 + those
    const uint32_t u0 = src0 ^ 0x80808080u, u1 = src1 ^ 0x80808080u;
    if constexpr (F16) {
      b[0][0] = u8x2_to_f16x2<0>(u0);
      b[0][1] = u8x2_to_f16x2<0>(u1);
      b[1][0] = u8x2_to_f16x2<1>(u0);
      b[1][1] = u8x2_to_f16x2<1>(u1);
    } else {
      b[0][0] = u8x2_to_bf16x2<0>(u0);
      b[0][1] = u8x2_to_bf16x2<0>(u1);
      b[1][0] = u8x2_to_bf16x2<1>(u0);
      b[1][1] = u8x2_to_bf16x2<1>(u1);
    }
  } else {  // src0: packed rows 2t, 2t+1 = k rows 4t..4t+3
    const uint32_t u = src0 ^ 0x88888888u;
    if constexpr (F16) {
      b[0][0] = u4x2_to_f16x2<0>(u);    // k 4t, 4t+2 of column 2g
      b[0][1] = u4x2_to_f16x2<4>(u);    // k 4t+1, 4t+3
      b[1][0] = u4x2_to_f16x2<8>(u);    // the same of column 2g+1
      b[1][1] = u4x2_to_f16x2<12>(u);
    } else {
      b[0][0] = u4x2_to_bf16x2<0>(u);
      b[0][1] = u4x2_to_bf16x2<4>(u);
      b[1][0] = u4x2_to_bf16x2<8>(u);
      b[1][1] = u4x2_to_bf16x2<12>(u);
    }
  }
}

// x rows are ldx apart; columns K..ldx-1, if any, are zero.
template <typename T, int BITS, int BM, int BN, int BK, int WM, int WN,
          int ST>
__global__ void __launch_bounds__(WM* WN * 32)
dq_mma(const T* __restrict__ x, const int8_t* __restrict__ q,
       const float* __restrict__ scale, T* __restrict__ y, int M, int K,
       int N, int64_t ldx, int xvec, int wvec) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr bool kF16 = std::is_same<T, __half>::value;
  constexpr int NTH = WM * WN * 32;
  constexpr int MT = BM / (WM * 16), NT = BN / (WN * 8);
  static_assert(MT * WM * 16 == BM && NT * WN * 8 == BN, "warp tiles");
  static_assert(NT % 4 == 0 && BK % 32 == 0 && ST >= 2, "tile shape");
  constexpr int SX = BK + (BITS == 8 ? 8 : 16);  // x row stride, elements
  constexpr int SW = BN + 16;                    // weight row stride, bytes
  constexpr int WROWS = BITS == 8 ? BK : BK / 2;
  constexpr int XST = BM * SX, WST = WROWS * SW;  // one stage
  using XRaw = typename Raw<sizeof(T)>::type;

  extern __shared__ __align__(16) unsigned char smem[];
  XRaw* xs = reinterpret_cast<XRaw*>(smem);
  uint8_t* ws = smem + ST * XST * sizeof(T);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm0 = (warp / WN) * MT * 16, wn0 = (warp % WN) * NT * 8;
  const int n_tiles = (N + BN - 1) / BN;
  const int m0 = (int)(blockIdx.x / n_tiles) * BM;
  const int n0 = (int)(blockIdx.x % n_tiles) * BN;
  const int kw = BITS == 8 ? K : (K + 1) / 2;  // weight rows that count
  const int KT = (K + BK - 1) / BK;
  const XRaw* xg = reinterpret_cast<const XRaw*>(x) + m0 * ldx;
  const uint8_t* qg = reinterpret_cast<const uint8_t*>(q) + n0;

  auto load_stage = [&](int s, int kt) {
    const int k0 = kt * BK, r0 = BITS == 8 ? k0 : k0 / 2;
    load_tile_zfill<XRaw, BM, BK, SX, NTH>(xs + s * XST, xg + k0, ldx,
                                           M - m0, K - k0, xvec, tid);
    load_tile_zfill<uint8_t, WROWS, BN, SW, NTH>(
        ws + s * WST, qg + (int64_t)r0 * N, N, kw - r0, N - n0, wvec, tid);
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<ST - 2>();
    __syncthreads();
    if (kt + ST - 1 < KT) load_stage((kt + ST - 1) % ST, kt + ST - 1);
    cp_async_commit();

    const int s = kt % ST;
    const XRaw* xa = xs + s * XST + wm0 * SX;
    const uint8_t* wb = ws + s * WST + wn0;

    // the stage's weight registers: [k16 step][n16 unit][k half]
    uint32_t wsrc[BK / 16][NT / 2][2];
#pragma unroll
    for (int v = 0; v < NT / 4; ++v) {
      const int col = 16 * (2 * v + (lane >> 4));
      if constexpr (BITS == 8) {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          uint32_t r[4];
          const int k = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
          ldmatrix_x4_trans(r, wb + k * SW + col);
          wsrc[kk][2 * v][0] = r[0];
          wsrc[kk][2 * v][1] = r[1];
          wsrc[kk][2 * v + 1][0] = r[2];
          wsrc[kk][2 * v + 1][1] = r[3];
        }
      } else {
#pragma unroll
        for (int kp = 0; kp < BK / 32; ++kp) {
          uint32_t r[4];
          const int k = (2 * kp + ((lane >> 3) & 1)) * 8 + (lane & 7);
          ldmatrix_x4_trans(r, wb + k * SW + col);
          wsrc[2 * kp][2 * v][0] = r[0];
          wsrc[2 * kp + 1][2 * v][0] = r[1];
          wsrc[2 * kp][2 * v + 1][0] = r[2];
          wsrc[2 * kp + 1][2 * v + 1][0] = r[3];
          wsrc[2 * kp][2 * v][1] = wsrc[2 * kp + 1][2 * v][1] = 0u;
          wsrc[2 * kp][2 * v + 1][1] = wsrc[2 * kp + 1][2 * v + 1][1] = 0u;
        }
      }
    }

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t b[NT / 2][2][2];
#pragma unroll
      for (int u = 0; u < NT / 2; ++u)
        weight_fragments<BITS, kF16>(wsrc[kk][u][0], wsrc[kk][u][1], b[u]);

#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const XRaw* xr = xa + (16 * mt) * SX + kk * 16;
        if constexpr (kF32) {  // x0 + x1 (+ x2), split as read
          const float* fr = reinterpret_cast<const float*>(xr);
          float v[2][4];  // rows g, g + 8: A registers (0, 2) and (1, 3)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float* p = fr + (g + 8 * h) * SX;
            if constexpr (BITS == 8) {  // k 2t, 2t+1 and 2t+8, 2t+9
              const float2 lo = *reinterpret_cast<const float2*>(p + 2 * t4);
              const float2 hi =
                  *reinterpret_cast<const float2*>(p + 2 * t4 + 8);
              v[h][0] = lo.x; v[h][1] = lo.y; v[h][2] = hi.x; v[h][3] = hi.y;
            } else {  // stored k 4t, 4t+2 and 4t+1, 4t+3
              const float4 f = *reinterpret_cast<const float4*>(p + 4 * t4);
              v[h][0] = f.x; v[h][1] = f.z; v[h][2] = f.y; v[h][3] = f.w;
            }
          }
          uint32_t a0[4], a1[4], a2[4];
          split_bf16x2_3(v[0][0], v[0][1], a0[0], a1[0], a2[0]);
          split_bf16x2_3(v[1][0], v[1][1], a0[1], a1[1], a2[1]);
          split_bf16x2_3(v[0][2], v[0][3], a0[2], a1[2], a2[2]);
          split_bf16x2_3(v[1][2], v[1][3], a0[3], a1[3], a2[3]);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const uint32_t* bj = b[j / 2][j % 2];
            if constexpr (kPieces == 3) mma_bf16(acc[mt][j], a2, bj[0], bj[1]);
            mma_bf16(acc[mt][j], a1, bj[0], bj[1]);
            mma_bf16(acc[mt][j], a0, bj[0], bj[1]);
          }
        } else {
          uint32_t a[4];
          if constexpr (BITS == 8) {
            ldmatrix_x4(a, xr + (lane & 15) * SX + (lane >> 4) * 8);
          } else {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint2 p = *reinterpret_cast<const uint2*>(
                  xr + (g + 8 * h) * SX + 4 * t4);
              a[h] = __byte_perm(p.x, p.y, 0x5410);      // k 4t, 4t+2
              a[2 + h] = __byte_perm(p.x, p.y, 0x7632);  // k 4t+1, 4t+3
            }
          }
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const uint32_t* bj = b[j / 2][j % 2];
            if constexpr (kF16)
              mma_f16(acc[mt][j], a, bj[0], bj[1]);
            else
              mma_bf16(acc[mt][j], a, bj[0], bj[1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: tiles 2u and 2u+1 hold columns 16u + 4t .. 16u + 4t + 3 of
  // rows g and g + 8
  const bool vec_store = (N & 3) == 0 && ((uintptr_t)scale & 15) == 0 &&
                         ((uintptr_t)y & 15) == 0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm0 + 16 * mt + g + 8 * h;
      if (row >= M) continue;
      T* yr = y + (int64_t)row * N;
#pragma unroll
      for (int u = 0; u < NT / 2; ++u) {
        const int col = n0 + wn0 + 16 * u + 4 * t4;
        if (col >= N) continue;
        const float v[4] = {acc[mt][2 * u][2 * h], acc[mt][2 * u + 1][2 * h],
                            acc[mt][2 * u][2 * h + 1],
                            acc[mt][2 * u + 1][2 * h + 1]};
        if (vec_store) {
          const float4 sc = *reinterpret_cast<const float4*>(scale + col);
          if constexpr (kF32) {
            *reinterpret_cast<float4*>(yr + col) = make_float4(
                v[0] * sc.x, v[1] * sc.y, v[2] * sc.z, v[3] * sc.w);
          } else {
            *reinterpret_cast<uint2*>(yr + col) =
                make_uint2(pack2<T>(v[0] * sc.x, v[1] * sc.y),
                           pack2<T>(v[2] * sc.z, v[3] * sc.w));
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col + e < N) yr[col + e] = from_f32<T>(v[e] * scale[col + e]);
        }
      }
    }
}

// The large-problem kernel on wgmma: a warpgroup computes y^T = W^T . x^T
// for 64 output columns and BM rows of x, so the widened weight is the
// register A operand (one warp's 16 columns, in the layout dq_mma builds
// its B fragments in) and x is the K-major B operand, read by the tensor
// cores from shared memory in the 128-byte swizzle.  WGS warpgroups share
// one x tile.  f32 x is split into its three bf16 pieces once per block,
// into three swizzled tiles, after its f32 tile lands.  With INF = 1 the
// products of slice k run while slice k+1 is split and its weights
// widened (A in two register sets, the pieces in two buffers).  Needs
// rows of x and q on 16 bytes (the host checks) and N a multiple of 16.
template <typename T, int BITS, int BM, int WGS, int ST, int INF>
__global__ void __launch_bounds__(WGS * 128, 1)
dq_wgmma(const T* __restrict__ x, const int8_t* __restrict__ q,
         const float* __restrict__ scale, T* __restrict__ y, int M, int K,
         int N, int64_t ldx) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr bool kF16 = std::is_same<T, __half>::value;
  constexpr int BK = 64;        // one 128-byte swizzled row of 16-bit x
  constexpr int BN = 64 * WGS;  // weight columns, 64 per warpgroup
  constexpr int NTH = WGS * 128;
  constexpr int SW = BN + 16;   // weight row stride, bytes
  constexpr int WROWS = BITS == 8 ? BK : BK / 2;
  constexpr int PIECE = BM * 128;                  // one swizzled x tile
  constexpr int XST = kF32 ? BM * BK * 4 : PIECE;  // one x stage, bytes
  constexpr int WST = WROWS * SW;
  // a slot is refilled once the products that read it are done: INF
  // slices after it was consumed, so loads run DIST slices ahead
  constexpr int DIST = ST - 1 - INF;
  constexpr int PB = kF32 ? INF + 1 : 0;  // buffers of f32 x's pieces
  static_assert(BM == 128, "wgmma n = BM = 128");
  static_assert(PIECE % 1024 == 0 && XST % 1024 == 0, "swizzle atoms");
  static_assert((INF == 0 || INF == 1) && DIST >= 1, "ring distance");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [ST x stages][PB x 3 bf16 pieces of f32 x][ST weight stages],
  // 1024-aligned
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* xs = smem;
  unsigned char* pieces = smem + ST * XST;
  unsigned char* ws = pieces + PB * 3 * PIECE;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wn = (warp >> 2) * 64 + (warp & 3) * 16;  // the warp's columns
  const int n_tiles = (N + BN - 1) / BN;
  const int m0 = (int)(blockIdx.x / n_tiles) * BM;
  const int n0 = (int)(blockIdx.x % n_tiles) * BN;
  const int kw = BITS == 8 ? K : (K + 1) / 2;
  const int KT = (K + BK - 1) / BK;
  const unsigned char* xg = reinterpret_cast<const unsigned char*>(x) +
                            (m0 * ldx) * (int64_t)sizeof(T);
  const uint8_t* qg = reinterpret_cast<const uint8_t*>(q) + n0;

  auto load_stage = [&](int s, int kt) {
    const int k0 = kt * BK;
    unsigned char* xd = xs + s * XST;
    constexpr int kCpr = BK * (int)sizeof(T) / 16;  // 16-byte chunks a row
    constexpr int kCe = 16 / (int)sizeof(T);
#pragma unroll
    for (int j = 0; j < BM * kCpr / NTH; ++j) {
      const int i = tid + j * NTH, r = i / kCpr, c = i % kCpr;
      const bool ok = m0 + r < M && k0 + c * kCe < K;
      // 16-bit x: swizzled for wgmma; f32 x: plain rows for the split
      const int at =
          kF32 ? r * BK * 4 + c * 16 : r * 128 + ((c ^ (r & 7)) << 4);
      const unsigned char* src =
          xg + ((int64_t)r * ldx + k0 + c * kCe) * (int64_t)sizeof(T);
      cp_async<16>(smem_u32(xd + at), ok ? src : xg, ok ? 16 : 0);
    }
    const int r0 = BITS == 8 ? k0 : k0 / 2;
    load_tile_zfill<uint8_t, WROWS, BN, SW, NTH>(
        ws + s * WST, qg + (int64_t)r0 * N, N, kw - r0, N - n0, 16, tid);
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  // one K slice: wait for its tiles, refill the ring, split (f32), widen
  // the weights into `a`, start the products, and wait for the previous
  // slice's, whose A registers (`prev`) are kept live until then so that
  // the compiler does not reuse them while the tensor cores read them
  auto step = [&](int kt, uint32_t(&a)[BK / 16][4],
                  uint32_t(&prev)[BK / 16][4], unsigned char* pc) {
    cp_async_wait<DIST - 1>();
    fence_proxy_async();
    __syncthreads();
    if (kt + DIST < KT) load_stage((kt + DIST) % ST, kt + DIST);
    cp_async_commit();
    const int s = kt % ST;

    if constexpr (kF32) {  // x0, x1, x2 of the f32 tile, swizzled
      const float* raw = reinterpret_cast<const float*>(xs + s * XST);
#pragma unroll
      for (int j = 0; j < BM * 8 / NTH; ++j) {
        const int i = tid + j * NTH, r = i >> 3, c = i & 7;
        const float4 lo =
            *reinterpret_cast<const float4*>(raw + r * BK + 8 * c);
        const float4 hi =
            *reinterpret_cast<const float4*>(raw + r * BK + 8 * c + 4);
        uint4 p0, p1, p2;
        split_bf16x2_3(lo.x, lo.y, p0.x, p1.x, p2.x);
        split_bf16x2_3(lo.z, lo.w, p0.y, p1.y, p2.y);
        split_bf16x2_3(hi.x, hi.y, p0.z, p1.z, p2.z);
        split_bf16x2_3(hi.z, hi.w, p0.w, p1.w, p2.w);
        const int at = r * 128 + ((c ^ (r & 7)) << 4);
        *reinterpret_cast<uint4*>(pc + at) = p0;
        *reinterpret_cast<uint4*>(pc + PIECE + at) = p1;
        *reinterpret_cast<uint4*>(pc + 2 * PIECE + at) = p2;
      }
      fence_proxy_async();
      __syncthreads();
    }

    // a[kk]: the A operand of k16 step kk (rows: columns 2g and 2g+1 of
    // the warp's 16)
    const uint8_t* wb = ws + s * WST + wn;
    if constexpr (BITS == 8) {
#pragma unroll
      for (int kp = 0; kp < BK / 32; ++kp) {
        uint32_t r[4];  // k rows 0-7, 8-15 of step 2kp, then of 2kp+1
        ldmatrix_x4_trans(
            r, wb + (kp * 32 + (lane >> 3) * 8 + (lane & 7)) * SW);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t lo = r[2 * h] ^ 0x80808080u;
          const uint32_t hi = r[2 * h + 1] ^ 0x80808080u;
          uint32_t* f = a[2 * kp + h];
          if constexpr (kF16) {
            f[0] = u8x2_to_f16x2<0>(lo);
            f[1] = u8x2_to_f16x2<1>(lo);
            f[2] = u8x2_to_f16x2<0>(hi);
            f[3] = u8x2_to_f16x2<1>(hi);
          } else {
            f[0] = u8x2_to_bf16x2<0>(lo);
            f[1] = u8x2_to_bf16x2<1>(lo);
            f[2] = u8x2_to_bf16x2<0>(hi);
            f[3] = u8x2_to_bf16x2<1>(hi);
          }
        }
      }
    } else {
      uint32_t r[4];  // packed rows t and t + 4 of step kk, in r[kk]
      const int row = ((lane & 7) >> 1) + 4 * (lane & 1);
      ldmatrix_x4_trans(r, wb + ((lane >> 3) * 8 + row) * SW);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t u = r[kk] ^ 0x88888888u;
        if constexpr (kF16) {
          a[kk][0] = u4pair_to_f16x2<0>(u);
          a[kk][1] = u4pair_to_f16x2<1>(u);
          a[kk][2] = u4pair_to_f16x2<2>(u);
          a[kk][3] = u4pair_to_f16x2<3>(u);
        } else {
          a[kk][0] = u4pair_to_bf16x2<0>(u);
          a[kk][1] = u4pair_to_bf16x2<1>(u);
          a[kk][2] = u4pair_to_bf16x2<2>(u);
          a[kk][3] = u4pair_to_bf16x2<3>(u);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 64; ++i) fence_operand(acc[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if constexpr (kF32) {
#pragma unroll
        for (int p = kPieces - 1; p >= 0; --p)  // small pieces first
          wgmma_m64n128k16_rs<false>(
              acc, a[kk], sw128_desc(smem_u32(pc + p * PIECE) + 32 * kk));
      } else {
        wgmma_m64n128k16_rs<kF16>(
            acc, a[kk], sw128_desc(smem_u32(xs + s * XST) + 32 * kk));
      }
    }
    wgmma_commit();
    wgmma_wait<INF>();
#pragma unroll
    for (int i = 0; i < 64; ++i) fence_operand(acc[i]);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) fence_operand(prev[kk][e]);
  };

#pragma unroll
  for (int s = 0; s < DIST; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  uint32_t a0[BK / 16][4] = {}, a1[BK / 16][4] = {};
  for (int kt = 0; kt < KT; kt += 2) {
    step(kt, a0, a1, pieces);
    if (kt + 1 < KT) step(kt + 1, a1, a0, pieces + (PB == 2 ? 3 * PIECE : 0));
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 64; ++i) fence_operand(acc[i]);
  cp_async_wait<0>();

  // epilogue: acc[4j + {0, 2}] are y[m][n], y[m][n + 1] and acc[4j + {1,
  // 3}] the same of row m + 1, for m = m0 + 8j + 2t and n = n0 + wn + 2g
  const int n = n0 + wn + 2 * g;
  if (n >= N) return;
  const float s0 = scale[n], s1 = scale[n + 1];
#pragma unroll
  for (int j = 0; j < BM / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 8 * j + 2 * t4 + h;
      if (m >= M) continue;
      T* yr = y + (int64_t)m * N + n;
      const float v0 = acc[4 * j + h] * s0, v1 = acc[4 * j + 2 + h] * s1;
      if constexpr (kF32)
        *reinterpret_cast<float2*>(yr) = make_float2(v0, v1);
      else
        *reinterpret_cast<uint32_t*>(yr) = pack2<T>(v0, v1);
    }
}

// The widest copy (16, 8 or 4 bytes; else 1, a plain element copy) that
// divides a row of `bytes` and the base address.
int copy_width(const void* p, int64_t bytes) {
  for (int v = 16; v >= 4; v /= 2)
    if (bytes % v == 0 && (uintptr_t)p % v == 0) return v;
  return 1;
}

template <typename T, int BITS>
int launch_mma(const void* x, const void* q, const void* scale, void* y,
               int M, int K, int N, int64_t ldx, cudaStream_t stream) {
  constexpr Cfg c = kMmaShape;
  constexpr int SX = c.bk + (BITS == 8 ? 8 : 16);
  constexpr int WROWS = BITS == 8 ? c.bk : c.bk / 2;
  constexpr int kSmem =
      c.stages * (c.bm * SX * (int)sizeof(T) + WROWS * (c.bn + 16));
  auto kernel = dq_mma<T, BITS, c.bm, c.bn, c.bk, c.wm, c.wn, c.stages>;
  static bool attribute_set = false;  // once, before any graph capture
  if (kSmem > 48 * 1024 && !attribute_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return (int)e;
    attribute_set = true;
  }
  const int64_t tiles =
      (int64_t)((M + c.bm - 1) / c.bm) * ((N + c.bn - 1) / c.bn);
  if (tiles > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  // 16-bit x rows off 4 bytes take plain 2-byte copies
  const int xvec = copy_width(x, ldx * (int64_t)sizeof(T));
  const int wvec = copy_width(q, N);
  kernel<<<(unsigned)tiles, c.wm * c.wn * 32, kSmem, stream>>>(
      (const T*)x, (const int8_t*)q, (const float*)scale, (T*)y, M, K, N,
      ldx, xvec, wvec);
  return (int)cudaGetLastError();
}

template <typename T, int BITS>
int launch_wgmma(const void* x, const void* q, const void* scale, void* y,
                 int M, int K, int N, int64_t ldx, cudaStream_t stream) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr WgCfg c = WgShape<T>::k;
  constexpr int BM = 128, BK = 64, kPiece = BM * 128;
  constexpr int kSmem =
      c.stages * ((kF32 ? BM * BK * 4 : kPiece) +
                  (BITS == 8 ? BK : BK / 2) * (64 * c.warpgroups + 16)) +
      (kF32 ? (c.in_flight + 1) * 3 * kPiece : 0) +
      1024;  // + 1024: alignment of the tiles
  auto kernel = dq_wgmma<T, BITS, BM, c.warpgroups, c.stages, c.in_flight>;
  static bool attribute_set = false;  // once, before any graph capture
  if (!attribute_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return (int)e;
    attribute_set = true;
  }
  const int bn = 64 * c.warpgroups;
  const int64_t tiles = (int64_t)((M + BM - 1) / BM) * ((N + bn - 1) / bn);
  if (tiles > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)tiles, c.warpgroups * 128, kSmem, stream>>>(
      (const T*)x, (const int8_t*)q, (const float*)scale, (T*)y, M, K, N,
      ldx);
  return (int)cudaGetLastError();
}

template <typename T, int BITS>
int launch_shape(const void* x, const void* q, const void* scale, void* y,
                 int M, int K, int N, int64_t ldx, cudaStream_t stream) {
  // wgmma for problems of a wave of 128 x 128 tiles on 132 SMs or more,
  // N of 128 or more, and rows of x and q on 16 bytes; else dq_mma
  const bool large = N >= 128 && (int64_t)M * N >= (int64_t)128 * 128 * 132;
  if (large && N % 16 == 0 && copy_width(q, N) == 16 &&
      copy_width(x, ldx * (int64_t)sizeof(T)) == 16)
    return launch_wgmma<T, BITS>(x, q, scale, y, M, K, N, ldx, stream);
  return launch_mma<T, BITS>(x, q, scale, y, M, K, N, ldx, stream);
}

template <typename T>
int launch_bits(const void* x, const void* q, const void* scale, void* y,
                int M, int K, int N, int64_t ldx, int bits,
                cudaStream_t stream) {
  return bits == 8
             ? launch_shape<T, 8>(x, q, scale, y, M, K, N, ldx, stream)
             : launch_shape<T, 4>(x, q, scale, y, M, K, N, ldx, stream);
}

}  // namespace

// dtype: 0 f32, 1 bf16, 2 f16 (x and y); bits: 8 or 4; x rows are ldx
// elements apart, and columns K..ldx-1 of x are zero (a caller pads a row
// to 16 bytes so that it is copied 16 bytes at a time).  Returns
// cudaGetLastError() after the launch (0 = launched), or an error code
// without launching for arguments it cannot take.  The caller does not
// call with M, N or K == 0.
extern "C" int zoo_dequant_matmul(const void* x, const void* q,
                                  const void* scale, void* y, int M, int K,
                                  int N, int64_t ldx, int bits, int dtype,
                                  void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || ldx < K || (bits != 8 && bits != 4))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch_bits<float>(x, q, scale, y, M, K, N, ldx, bits, st);
    case 1:
      return launch_bits<__nv_bfloat16>(x, q, scale, y, M, K, N, ldx, bits,
                                         st);
    case 2:
      return launch_bits<__half>(x, q, scale, y, M, K, N, ldx, bits, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* zoo_dequant_matmul_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
