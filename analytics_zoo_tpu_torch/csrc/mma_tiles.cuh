// Tensor-core and asynchronous-copy building blocks for Hopper (sm_90a)
// kernels that use mma.sync: 16-byte cp.async tiles with zero fill, the
// ldmatrix fragment loads, the m16n8k8 TF32 and m16n8k16 bf16 products
// with f32 accumulation, a warp's tile products built from them, and the
// splits that keep an f32 operand's accuracy on the tensor cores:
//
//   split-TF32 ("3xTF32"): x_hi = tf32(x), x_lo = tf32(x - x_hi), tf32
//   being cvt.rna.tf32.f32's rounding; a.b ~ a_hi.b_hi + a_hi.b_lo +
//   a_lo.b_hi, each term an exact TF32 product summed in f32, so about 21
//   of f32's 24 mantissa bits survive (plain TF32 keeps 11);
//
//   split-bf16: x_hi = bf16(x), x_lo = bf16(x - x_hi), 16 mantissa bits;
//   the three-way split_bf16x2_3 adds x_2 = bf16(x - x_hi - x_lo) and
//   keeps all 24 (each piece times an exactly converted weight is an
//   exact product).
//
// It also holds the exact widenings of quantized weights (int8 bytes,
// int4 nibbles) into bf16 or f16 pairs for an m16n8k16 B fragment, and
// the m16n8k16 f16 product.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k8" and
// "m16n8k16"), lane = 4 * g + t:
//
//   C, D (16 x 8, f32):  c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
//   A tf32 (16 x 8):     a0 (g, t)   a1 (g+8, t)   a2 (g, t+4)   a3 (g+8, t+4)
//   B tf32 (8 x 8):      b0 (t, g)   b1 (t+4, g)
//   A bf16 (16 x 16):    a0 (g, 2t..2t+1)   a1 (g+8, 2t..)  a2 (g, 2t+8..)
//                        a3 (g+8, 2t+8..)
//   B bf16 (16 x 8):     b0 (2t..2t+1, g)   b1 (2t+8..2t+9, g)

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace zoo_mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// cp.async of BYTES (4, 8 or 16) from global src to shared dst; the
// bytes past src_bytes (0 for a row outside the tensor) are zero-filled.
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int src_bytes) {
  static_assert(BYTES == 4 || BYTES == 8 || BYTES == 16, "cp.async size");
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(BYTES), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's cp.async groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Copies rows [0, ROWS) of a tile, each of d elements, from global rows
// src + r * row_stride into shared rows dst + r * S; rows at or past
// nvalid are zero-filled, and columns d..S are not touched.  vec is the
// copy width in bytes (16, 8 or 4 through cp.async; anything narrower,
// a bf16 row that starts on 2 bytes, by plain loads and stores), and
// divides d * sizeof(T), the base address and every stride.  The
// cp.async copies land after cp_async_wait; the plain stores are
// done when this returns.  Called by all NT threads of the block.
template <typename T, int S, int ROWS, int NT, int DMAX>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          int64_t row_stride, int nvalid,
                                          int d, int vec, int tid) {
  if (vec == 16 && d == DMAX) {  // the common case: constant chunk count
    constexpr int kCe = 16 / (int)sizeof(T);
    constexpr int kCpr = DMAX / kCe;
    static_assert((ROWS * kCpr) % NT == 0, "tile chunks per thread");
#pragma unroll
    for (int j = 0; j < ROWS * kCpr / NT; ++j) {
      const int i = tid + j * NT;
      const int r = i / kCpr;
      const int c = (i % kCpr) * kCe;
      const bool ok = r < nvalid;
      cp_async<16>(smem_u32(dst + r * S + c),
                   ok ? src + r * row_stride + c : src, ok ? 16 : 0);
    }
    return;
  }
  if (vec >= 4) {
    const int ce = vec / (int)sizeof(T);
    const int cpr = d / ce;
    for (int i = tid; i < ROWS * cpr; i += NT) {
      const int r = i / cpr;
      const int c = (i - r * cpr) * ce;
      const bool ok = r < nvalid;
      const T* g = ok ? src + r * row_stride + c : src;
      const uint32_t s = smem_u32(dst + r * S + c);
      if (vec == 16)
        cp_async<16>(s, g, ok ? 16 : 0);
      else if (vec == 8)
        cp_async<8>(s, g, ok ? 8 : 0);
      else
        cp_async<4>(s, g, ok ? 4 : 0);
    }
    return;
  }
  for (int i = tid; i < ROWS * d; i += NT) {
    const int r = i / d;
    const int c = i - r * d;
    dst[r * S + c] = r < nvalid ? src[r * row_stride + c] : zero<T>();
  }
}

// Zeroes columns [d, DMAX) of `rows` shared rows of stride S: the padding
// up to the mma's k that cp.async never writes.
template <typename T, int S, int DMAX, int NT>
__device__ __forceinline__ void zero_pad_columns(T* base, int rows, int d,
                                                 int tid) {
  const int w = DMAX - d;
  if (w <= 0) return;
  for (int i = tid; i < rows * w; i += NT) {
    const int r = i / w;
    base[r * S + d + (i - r * w)] = zero<T>();
  }
}

// --- fragment loads (bf16) ---------------------------------------------

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// --- products ----------------------------------------------------------

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_f16(float (&c)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a.b ~ a_hi.b_hi + a_hi.b_lo + a_lo.b_hi, small terms first.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4],
                                           uint32_t bhi0, uint32_t bhi1,
                                           uint32_t blo0, uint32_t blo1) {
  mma_tf32(c, alo, bhi0, bhi1);
  mma_tf32(c, ahi, blo0, blo1);
  mma_tf32(c, ahi, bhi0, bhi1);
}

// --- splits ------------------------------------------------------------

// cvt.rna.tf32.f32 (nearest, ties away from zero, low 13 bits cleared)
// in two full-rate integer operations: the same value for every finite x
// and infinity, where the conversion instruction runs at a fraction of
// the rate.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) -> hi = bf16x2(x0, x1) and lo = bf16x2 of the residuals; x0
// in the low half (the lower column of an A fragment register).
__device__ __forceinline__ void split_bf16x2(float x0, float x1,
                                             uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// (x0, x1) -> three bf16x2 pieces p0 + p1 + p2 = (x0, x1) to f32's 24
// bits: p0 = bf16(x), p1 = bf16(x - p0), p2 = bf16(x - p0 - p1); each
// difference is exact in f32.  x0 in the low halves.
__device__ __forceinline__ void split_bf16x2_3(float x0, float x1,
                                               uint32_t& p0, uint32_t& p1,
                                               uint32_t& p2) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  p0 = bf16x2_bits(h);
  p1 = bf16x2_bits(m);
  p2 = bf16x2_bits(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
}

// --- exact widening of quantized weights -------------------------------
//
// Every int8 weight (|v| <= 127) and int4 nibble (-8..7) is exact in bf16
// and f16, so a converted weight times a 16-bit x is an exact product.
// The conversions are integer bit tricks on four packed values at once,
// no I2F: a value biased to unsigned (u = v + 128 or n + 8, by one XOR
// of the whole register) is written into the mantissa of a power of two,
// and one subtraction of that power plus the bias leaves v exactly.

// u: four int8 bytes XORed with 0x80808080 (u = v + 128).  Bytes SEL and
// SEL + 2 -> bf16x2, byte SEL in the low half: through f32 2^23 + u.
template <int SEL>
__device__ __forceinline__ uint32_t u8x2_to_bf16x2(uint32_t u) {
  const float lo = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + SEL));
  const float hi =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442 + SEL));
  return bf16x2_bits(
      __floats2bfloat162_rn(lo - 8388736.f, hi - 8388736.f));
}

// The same into f16x2: f16 1024 + u (0x6400 | u) minus 1152 (0x6480).
template <int SEL>
__device__ __forceinline__ uint32_t u8x2_to_f16x2(uint32_t u) {
  const uint32_t h = __byte_perm(u, 0x64646464u, 0x4240 + SEL * 0x101);
  uint32_t out;
  asm("sub.rn.f16x2 %0, %1, %2;\n" : "=r"(out) : "r"(h), "r"(0x64806480u));
  return out;
}

// u: eight int4 nibbles XORed with 0x88888888 (u = n + 8).  The nibbles
// at bits SH and SH + 16 -> bf16x2 (SH's in the low half): bf16 128 + u
// (0x4300 | u) minus 136 (0x4308), as one fma.
template <int SH>
__device__ __forceinline__ uint32_t u4x2_to_bf16x2(uint32_t u) {
  const uint32_t h = ((u >> SH) & 0x000F000Fu) | 0x43004300u;
  uint32_t out;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(out)
      : "r"(h), "r"(0x3F803F80u), "r"(0xC308C308u));
  return out;
}

// The same into f16x2: f16 1024 + u (0x6400 | u) minus 1032 (0x6408).
template <int SH>
__device__ __forceinline__ uint32_t u4x2_to_f16x2(uint32_t u) {
  const uint32_t h = ((u >> SH) & 0x000F000Fu) | 0x64006400u;
  uint32_t out;
  asm("sub.rn.f16x2 %0, %1, %2;\n" : "=r"(out) : "r"(h), "r"(0x64086408u));
  return out;
}

// int4 nibble pairs for a k-major fragment: u holds four bytes of eight
// nibbles XORed with 0x88888888; byte B's low and high nibbles (rows 2k
// and 2k+1 of one column) -> bf16x2 (f16x2), the low nibble in the low
// half, as u4x2_to_bf16x2 does.
template <int B>
__device__ __forceinline__ uint32_t u4pair_to_bf16x2(uint32_t u) {
  const uint32_t x = __byte_perm(u, 0u, 0x4040 | B | (B << 8));  // b, 0, b, 0
  const uint32_t h =
      (x & 0x0000000Fu) | ((x >> 4) & 0x000F0000u) | 0x43004300u;
  uint32_t out;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(out)
      : "r"(h), "r"(0x3F803F80u), "r"(0xC308C308u));
  return out;
}

template <int B>
__device__ __forceinline__ uint32_t u4pair_to_f16x2(uint32_t u) {
  const uint32_t x = __byte_perm(u, 0u, 0x4040 | B | (B << 8));
  const uint32_t h =
      (x & 0x0000000Fu) | ((x >> 4) & 0x000F0000u) | 0x64006400u;
  uint32_t out;
  asm("sub.rn.f16x2 %0, %1, %2;\n" : "=r"(out) : "r"(h), "r"(0x64086408u));
  return out;
}

// --- wgmma (sm_90a) ----------------------------------------------------
//
// A warpgroup's (4 warps') asynchronous product: D (64 x N, f32 in
// registers) += A (64 x 16, 16-bit, in registers: each warp's 16 rows in
// the m16n8k16 A layout) . B (16 x N, 16-bit, K-major in shared memory
// behind a descriptor).  D's layout: warp w, lane 4g + t holds rows
// 16w + g and 16w + g + 8, columns 8j + 2t and 8j + 2t + 1, as
// d[4j + 0..3] = (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Orders this thread's generic-proxy writes to shared memory (plain
// stores, cp.async) before async-proxy reads of it (wgmma operands).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from moving a register's reads or writes across
// this point (around wgmma's asynchronous use of it).
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void fence_operand(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// Descriptor of a K-major operand in shared memory with the 128-byte
// swizzle: rows of 64 16-bit elements (128 bytes), 16-byte chunk c of row
// r stored at chunk c ^ (r % 8), atoms of 8 rows (1024 bytes, 1024-byte
// aligned) one after another.  saddr: the tile's shared address plus 32
// bytes per k16 step.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// D (64 x 128) += A . B, A from registers; F16 picks f16 over bf16.
template <bool F16>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t desc_b) {
  if constexpr (F16)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// --- warp tile products ------------------------------------------------
//
// A warp's products over tiles in shared memory, rows of stride S with
// DMAX columns (zero past the real width).  "nt": acc (16 MT x 8 KN) +=
// A . B^T, A the warp's MT m-tiles of 16 rows, B a tile of 8 KN rows, the
// sum over DMAX.  "pn": acc (16 MT x DMAX) += P . B, P an accumulator of
// the nt shape and B a tile of 8 KN rows, the sum over those rows.  The
// loops have compile-time bounds only, so each product is straight-line
// code the compiler can schedule whole.  (The flash forward keeps its own
// copies of these shapes, with the softmax's scaling folded in.)

// nt, split-TF32: f32 A (at `a`) and B (at `b`) are scaled by a_scale and
// b_scale in f32 and split as they are read; each B fragment is split once
// for all MT m-tiles.
template <int DMAX, int S, int MT, int KN>
__device__ __forceinline__ void mma_nt_3xtf32(float (&acc)[MT][KN][4],
                                              const float* a, float a_scale,
                                              const float* b, float b_scale,
                                              int g, int t4) {
#pragma unroll
  for (int kk = 0; kk < DMAX / 8; ++kk) {
    const int c = kk * 8 + t4;
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* ar = a + (16 * mt + g) * S + c;
      split_tf32(ar[0] * a_scale, ah[mt][0], al[mt][0]);
      split_tf32(ar[8 * S] * a_scale, ah[mt][1], al[mt][1]);
      split_tf32(ar[4] * a_scale, ah[mt][2], al[mt][2]);
      split_tf32(ar[8 * S + 4] * a_scale, ah[mt][3], al[mt][3]);
    }
#pragma unroll
    for (int n = 0; n < KN; ++n) {
      const float* br = b + (n * 8 + g) * S + c;
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(br[0] * b_scale, bh0, bl0);
      split_tf32(br[4] * b_scale, bh1, bl1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        mma_3xtf32(acc[mt][n], ah[mt], al[mt], bh0, bh1, bl0, bl1);
    }
  }
}

// pn, split-TF32.  P's accumulator is its A fragment once the 8 rows of B
// in each k-step are permuted: A column t is B row 2t (c0, c2), column
// t + 4 row 2t + 1 (c1, c3), and B's fragment is read from those rows
// (conflict-free at S = DMAX + 4), split once for all m-tiles.
template <int DMAX, int S, int MT, int KN>
__device__ __forceinline__ void mma_pn_3xtf32(float (&acc)[MT][DMAX / 8][4],
                                              const float (&p)[MT][KN][4],
                                              const float* b, int g, int t4) {
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
    const float* br = b + (j * 8 + 2 * t4) * S + g;
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n) {
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(br[n * 8], bh0, bl0);      // b[8j + 2t][8n + g]
      split_tf32(br[S + n * 8], bh1, bl1);  // b[8j + 2t + 1][8n + g]
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        mma_3xtf32(acc[mt][n], ah[mt], al[mt], bh0, bh1, bl0, bl1);
    }
  }
}

// The bf16 A fragments of the warp's MT m-tiles of 16 rows at `a`.
template <int DMAX, int S, int MT>
__device__ __forceinline__ void load_a_bf16(uint32_t (&af)[MT][DMAX / 16][4],
                                            const __nv_bfloat16* a,
                                            int lane) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk)
      ldmatrix_x4(af[mt][kk], a + (16 * mt + (lane & 15)) * S + kk * 16 +
                                  (lane >> 4) * 8);
}

// nt in bf16, exact products: A fragments from load_a_bf16, B by ldmatrix
// (one load for every m-tile).  KN even.
template <int DMAX, int S, int MT, int KN>
__device__ __forceinline__ void mma_nt_bf16(
    float (&acc)[MT][KN][4], const uint32_t (&af)[MT][DMAX / 16][4],
    const __nv_bfloat16* b, int lane) {
  const __nv_bfloat16* bl =
      b + ((lane & 7) + ((lane >> 4) << 3)) * S + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk)
#pragma unroll
    for (int np = 0; np < KN / 2; ++np) {
      uint32_t r[4];
      ldmatrix_x4(r, bl + np * 16 * S + kk * 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(acc[mt][2 * np], af[mt][kk], r[0], r[1]);
        mma_bf16(acc[mt][2 * np + 1], af[mt][kk], r[2], r[3]);
      }
    }
}

// pn in bf16: two adjacent accumulator tiles of P are an m16n8k16 A
// fragment as they stand; P enters as p_hi + p_lo (split_bf16x2) against
// the exact bf16 B (ldmatrix.trans, one load for every m-tile).  KN even.
template <int DMAX, int S, int MT, int KN>
__device__ __forceinline__ void mma_pn_bf16(float (&acc)[MT][DMAX / 8][4],
                                            const float (&p)[MT][KN][4],
                                            const __nv_bfloat16* b,
                                            int lane) {
  const __nv_bfloat16* bl =
      b + ((lane & 7) + ((lane >> 3) & 1) * 8) * S + (lane >> 4) * 8;
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
      uint32_t r[4];
      ldmatrix_x4_trans(r, bl + j * 16 * S + np * 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(acc[mt][2 * np], al[mt], r[0], r[1]);
        mma_bf16(acc[mt][2 * np], ah[mt], r[0], r[1]);
        mma_bf16(acc[mt][2 * np + 1], al[mt], r[2], r[3]);
        mma_bf16(acc[mt][2 * np + 1], ah[mt], r[2], r[3]);
      }
    }
  }
}

}  // namespace zoo_mma
