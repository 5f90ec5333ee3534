// Shapes and device helpers shared by the conv block's forward
// (fused_conv.cu) and backward (fused_conv_bwd.cu): C = 64 channels in and
// out, 256 threads per CTA, one CTA per sample, fixed-order block sums.
#pragma once

#include <cuda_runtime.h>

#include "block_common.cuh"

namespace {

constexpr int C = 64;        // channels, in and out (the square conv)
constexpr int MAX_K = 64;    // taps
constexpr int CNT = 256;     // threads per CTA
constexpr int CNW = CNT / 32;

// the sum of every thread's v, the same value in every thread; the order of
// the additions is fixed, so the result is the same from run to run.
// `red` holds CNW floats of shared memory.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < CNW; ++w) s += red[w];
  __syncthreads();  // red is reused by the next call
  return s;
}

// the most dynamic shared memory this device lets a CTA opt into
inline cudaError_t smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

}  // namespace
