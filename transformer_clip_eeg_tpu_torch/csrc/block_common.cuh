// Shapes and device helpers shared by the fused block's forward
// (fused_block.cu) and backward (fused_block_bwd.cu): one E=64 row per warp,
// weight rows in registers, exact-erf GELU.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int E = 64;       // embedding width
constexpr int H = 8;        // heads
constexpr int D = E / H;    // head width
constexpr int F = 4 * E;    // FFN hidden width

// order and torch layouts of the 16 parameters:
//   g1 [E], be1 [E], wq [E,E], wk [E,E], wv [E,E], bq [E], bk [E], bv [E],
//   wo [E,E], bo [E], g2 [E], be2 [E], w1 [F,E], bb1 [F], w2 [E,F], bb2 [E]
// (a weight is [out, in], as torch.nn.Linear stores it)
struct BlockParams {
  const float* p[16];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

// N consecutive floats of device memory (16-byte aligned) into registers.
template <int N>
__device__ __forceinline__ void load_row(const float* __restrict__ src,
                                         float (&w)[N]) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 v = __ldg(s4 + i);
    w[4 * i] = v.x;
    w[4 * i + 1] = v.y;
    w[4 * i + 2] = v.z;
    w[4 * i + 3] = v.w;
  }
}

// dot product of a 16-byte aligned shared-memory row with a register row
template <int N>
__device__ __forceinline__ float dot_row(const float* row, const float (&w)[N]) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 v = r4[i];
    a0 = fmaf(v.x, w[4 * i], a0);
    a1 = fmaf(v.y, w[4 * i + 1], a1);
    a2 = fmaf(v.z, w[4 * i + 2], a2);
    a3 = fmaf(v.w, w[4 * i + 3], a3);
  }
  return (a0 + a1) + (a2 + a3);
}

// LayerNorm (eps 1e-5) of one E=64 row by one warp: two values per lane.
__device__ __forceinline__ void layernorm_row(const float* src, float* dst,
                                              const float* __restrict__ g,
                                              const float* __restrict__ b,
                                              int lane) {
  const float a0 = src[lane], a1 = src[lane + 32];
  const float mean = warp_sum(a0 + a1) * (1.0f / E);
  const float d0 = a0 - mean, d1 = a1 - mean;
  const float var = warp_sum(d0 * d0 + d1 * d1) * (1.0f / E);
  const float inv = rsqrtf(var + 1e-5f);
  dst[lane] = d0 * inv * __ldg(g + lane) + __ldg(b + lane);
  dst[lane + 32] = d1 * inv * __ldg(g + lane + 32) + __ldg(b + lane + 32);
}

// d gelu(x) / dx for the exact-erf GELU
__device__ __forceinline__ float gelu_grad(float x) {
  const float cdf = 0.5f * (1.0f + erff(x * 0.70710678118654752f));
  const float pdf = expf(-0.5f * x * x) * 0.3989422804014327f;
  return cdf + x * pdf;
}

}  // namespace
