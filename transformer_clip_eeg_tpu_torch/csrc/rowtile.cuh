// Row products Y = A W^T of the fused block's forward (fused_block.cu) on the
// tensor cores, in split TF32: f32-grade results from three TF32 products;
// or, in the block's bf16 mode, one bf16 product (mma.sync m16n8k16) on
// operands rounded to bf16 (nearest even), f32 sums.
//
// What bounds such a product on an H100 outside the tensor cores is not the
// FMAs but the instructions around them: an outer-product register tile of
// 4 x 8 sums a thread (one 16-byte shared-memory load per 10.7 FMAs, weight
// panels padded against bank conflicts) measured 21-23 TFLOP/s of the 67 in
// this kernel, where every product is only 64 deep and sits between barriers.
// mma.sync m16n8k8 does 1,024 multiply-adds an instruction.  TF32 keeps 11
// bits of mantissa, so each operand is split as x = hi + lo (hi = x cut to
// TF32, lo = x - hi) and the product taken as lo*hi + hi*lo + hi*hi, summed
// in f32 by the tensor core, small terms first: what is dropped (lo*lo, and
// lo's bits below TF32) is 2^-20 of a term, so the result agrees with an f32
// FMA chain to about 1e-6 of the sum's terms.
//
// Layout.  A warp owns MB x NB blocks of 16 rows x 8 columns.  Both operands
// lie in shared memory along the reduction axis with rows of K + 4 floats (K a
// multiple of 32): the fragment loads of m16n8k8 (lane = 4 g + t reads row g,
// or g + 8, at column t, or t + 4, of its block) then hit 32 different banks,
// 4 g + t.  Weight rows arrive by 16-byte cp.async straight from torch's
// [out, in] matrix, activation rows likewise, while the CTA normalises.
//
// bf16 mode.  The operands stay float rows in shared memory (the layout of
// the f32 mode), and each pair a lane needs is rounded as it is loaded into
// its fragment register (cvt.rn.bf16x2.f32): the same numbers as rounding on
// staging, for one conversion a pair where split TF32 spends two splits and
// three products.  An m16n8k16 fragment (lane 4 g + t) holds row g, or g + 8,
// at columns 2 t, 2 t + 1, or + 8: float2 loads, which conflict two ways in
// rows of K + 4 floats (the forward's row kernels keep that layout; the bf16
// attentions and the backward's bf16 row kernels stage bf16 rows, below).
//
// bf16 rows in shared memory.  Operands staged as bf16, each row padded by
// BPAD values (16 bytes), are read by ldmatrix: lane l gives the address of
// row l % 8 of matrix l / 8, and the 8 rows of a matrix then lie in 8
// different 16-byte bank groups (rows of 64 or 256 values, 128 or 512 bytes,
// would put all 8 in one).  ldmatrix.trans gives the B fragment of a product
// whose B is stored [k][n] (Y = A W with W as torch stores it), movmatrix the
// transpose of a fragment a warp already holds.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace rowtile {
namespace {

constexpr int PAD = 4;  // floats added to every row in shared memory: 4 banks

// Start the copies of `rows` rows of K floats (row n at src + n ld; rows from
// `valid` on are zero-filled) into dst[rows][K + PAD]; all nt threads call it
template <int K>
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src, int ld,
                                           int rows, int valid, int tid, int nt) {
  constexpr int C4 = K / 4;
  for (int c = tid; c < rows * C4; c += nt) {
    const int n = c / C4, k = (c % C4) * 4;
    const bool in = n < valid;
    cp_async16(dst + n * (K + PAD) + k, in ? src + (size_t)n * ld + k : src, in);
  }
}

// x = hi + lo exactly: hi is x with the 13 low bits of its mantissa cleared,
// which is what the tensor core reads of x; of lo it reads the top 11 bits
// (cvt.rna.tf32.f32 would round both, but costs more than the products do)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a b for one block: a 16 x 8 (row major), b 8 x 8 (column major), f32 sums
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two floats rounded to bf16 (nearest even) and packed as one operand
// register of mma.sync: `lo`, the lower index along k, in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// the two floats at p (8-byte aligned) as a bf16x2 operand register
__device__ __forceinline__ uint32_t ld_bf16x2(const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  return pack_bf16(v.x, v.y);
}

// c += a b for one block: a 16 x 16 (row major), b 16 x 8 (column major), bf16
// operands, f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[mi][ni] += bf16(A) bf16(W)^T over k < K (a multiple of 16): the bf16
// mode of mma_tile, with its arguments and accumulator layout
template <int MB, int NB, int K, int LDA, int LDW>
__device__ __forceinline__ void mma_tile_bf16(const float* a, const float* w,
                                              float (&acc)[MB][NB][4], int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* ap = a + g * LDA + 2 * t;
  const float* wp = w + g * LDW + 2 * t;
#pragma unroll 1  // one k-step's fragments in flight: three CTAs an SM in ln_qkv_kernel
  for (int k = 0; k < K; k += 16) {
    uint32_t af[MB][4];
#pragma unroll
    for (int mi = 0; mi < MB; ++mi) {
      const float* p = ap + 16 * mi * LDA + k;
      af[mi][0] = ld_bf16x2(p);
      af[mi][1] = ld_bf16x2(p + 8 * LDA);
      af[mi][2] = ld_bf16x2(p + 8);
      af[mi][3] = ld_bf16x2(p + 8 * LDA + 8);
    }
#pragma unroll
    for (int ni = 0; ni < NB; ++ni) {
      const float* p = wp + 8 * ni * LDW + k;
      const uint32_t bf[2] = {ld_bf16x2(p), ld_bf16x2(p + 8)};
#pragma unroll
      for (int mi = 0; mi < MB; ++mi) mma_bf16(acc[mi][ni], af[mi], bf);
    }
  }
}

// acc[mi][ni] += A W^T over k < K for the warp's MB x NB blocks.
//   a: the warp's first row of A (rows LDA floats apart), w: its first row of
//   W, i.e. its first output column (rows LDW floats apart); both offset alike
//   along the reduction axis when only a part of it is taken.
// Lane 4 g + t holds of block (mi, ni): acc[..][0], [1] at row 16 mi + g,
// columns 8 ni + 2 t and + 1; acc[..][2], [3] at row 16 mi + g + 8 (frag_row,
// frag_col).
template <int MB, int NB, int K, int LDA, int LDW>
__device__ __forceinline__ void mma_tile(const float* a, const float* w,
                                         float (&acc)[MB][NB][4], int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* ap = a + g * LDA + t;
  const float* wp = w + g * LDW + t;
#pragma unroll 2
  for (int k = 0; k < K; k += 8) {
    uint32_t ah[MB][4], al[MB][4];
#pragma unroll
    for (int mi = 0; mi < MB; ++mi) {
      const float* p = ap + 16 * mi * LDA + k;
      split_tf32(p[0], ah[mi][0], al[mi][0]);
      split_tf32(p[8 * LDA], ah[mi][1], al[mi][1]);
      split_tf32(p[4], ah[mi][2], al[mi][2]);
      split_tf32(p[8 * LDA + 4], ah[mi][3], al[mi][3]);
    }
#pragma unroll
    for (int ni = 0; ni < NB; ++ni) {  // one block of W at a time: few registers
      const float* p = wp + 8 * ni * LDW + k;
      uint32_t bh[2], bl[2];
      split_tf32(p[0], bh[0], bl[0]);
      split_tf32(p[4], bh[1], bl[1]);
#pragma unroll
      for (int mi = 0; mi < MB; ++mi) {
        mma_tf32(acc[mi][ni], al[mi], bh);
        mma_tf32(acc[mi][ni], ah[mi], bl);
        mma_tf32(acc[mi][ni], ah[mi], bh);
      }
    }
  }
}

// the product of the mode: bf16 operands (BF16) or split TF32
template <bool BF16, int MB, int NB, int K, int LDA, int LDW>
__device__ __forceinline__ void mma_tile_mode(const float* a, const float* w,
                                              float (&acc)[MB][NB][4], int lane) {
  if constexpr (BF16)
    mma_tile_bf16<MB, NB, K, LDA, LDW>(a, w, acc, lane);
  else
    mma_tile<MB, NB, K, LDA, LDW>(a, w, acc, lane);
}

// ---- bf16 rows in shared memory (the header's last paragraph) ----------------------
using bf16_t = __nv_bfloat16;
constexpr int BPAD = 8;  // bf16 values added to every bf16 row: 16 bytes

// c += a b for one block: a 16 x 8 (row major), b 8 x 8 (column major), bf16
// operands, f32 sums (a: rows g, g + 8 at columns 2 t, 2 t + 1; b: rows 2 t,
// 2 t + 1 at column g)
__device__ __forceinline__ void mma_bf16_k8(float (&c)[4], const uint32_t (&a)[2], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// Four 8 x 8 matrices of bf16 from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8 (16 bytes, 16-byte aligned); r[i] receives row
// lane / 4 of matrix i (TRANS: of its transpose) at columns 2 (lane % 4) and
// + 1, the lower column in the lower half, as a fragment of mma.sync
template <bool TRANS>
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16_t* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// the 8 x 8 bf16 matrix the warp holds as one register a lane (row lane / 4,
// columns 2 (lane % 4), + 1), transposed
__device__ __forceinline__ uint32_t movm_trans(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;" : "=r"(d) : "r"(a));
  return d;
}

// 8 floats as 8 bf16 (nearest even) at p, 16-byte aligned
__device__ __forceinline__ void store_bf16x8(bf16_t* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                            pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

// rows x K floats of device memory (row n at src + n K, 16-byte aligned) as
// bf16 rows of LD values in shared memory; all nt threads call it
template <int K, int LD>
__device__ __forceinline__ void stage_bf16(bf16_t* dst, const float* __restrict__ src, int rows,
                                           int tid, int nt) {
  for (int c = tid; c < rows * (K / 4); c += nt) {
    const int n = c / (K / 4), k = (c % (K / 4)) * 4;
    const float4 v = __ldg(reinterpret_cast<const float4*>(src + (size_t)n * K + k));
    *reinterpret_cast<uint2*>(dst + n * LD + k) =
        make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

// acc[mi][ni] += A B over k < K (a multiple of 16), both bf16 rows in shared
// memory: A the warp's MB x 16 rows from a, along k (rows LDA apart); B from
// b, either [n][k] (KN false: rows LDB apart, one an output column, Y = A W^T
// with W as torch stores it) or [k][n] (KN: rows LDB apart, Y = A W).  The
// accumulator layout is mma_tile's; NB is even.
template <int MB, int NB, int K, int LDA, int LDB, bool KN>
__device__ __forceinline__ void mma_tile_smem(const bf16_t* a, const bf16_t* b,
                                              float (&acc)[MB][NB][4], int lane) {
  static_assert(NB % 2 == 0 && K % 16 == 0, "whole pairs of n-blocks, whole k-steps");
  const bf16_t* ap = a + (lane & 15) * LDA + (lane >> 4) * 8;
  const bf16_t* bp = KN ? b + (lane & 15) * LDB + (lane >> 4) * 8
                        : b + ((lane >> 4) * 8 + (lane & 7)) * LDB + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int k = 0; k < K; k += 16) {
    uint32_t af[MB][4];
#pragma unroll
    for (int mi = 0; mi < MB; ++mi) ldsm4<false>(af[mi], ap + 16 * mi * LDA + k);
#pragma unroll
    for (int nj = 0; nj < NB; nj += 2) {
      uint32_t bf[4];  // n-blocks nj and nj + 1
      ldsm4<KN>(bf, KN ? bp + k * LDB + 8 * nj : bp + 8 * nj * LDB + k);
      const uint32_t b0[2] = {bf[0], bf[1]}, b1[2] = {bf[2], bf[3]};
#pragma unroll
      for (int mi = 0; mi < MB; ++mi) {
        mma_bf16(acc[mi][nj], af[mi], b0);
        mma_bf16(acc[mi][nj + 1], af[mi], b1);
      }
    }
  }
}

// row and first column, inside the warp's tile, of acc[mi][ni][2 half], [2 half + 1]
__device__ __forceinline__ int frag_row(int lane, int mi, int half) {
  return 16 * mi + (lane >> 2) + 8 * half;
}
__device__ __forceinline__ int frag_col(int lane, int ni) { return 8 * ni + 2 * (lane & 3); }

template <int MB, int NB>
__device__ __forceinline__ void zero(float (&acc)[MB][NB][4]) {
#pragma unroll
  for (int mi = 0; mi < MB; ++mi)
#pragma unroll
    for (int ni = 0; ni < NB; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.f;
}

}  // namespace
}  // namespace rowtile
