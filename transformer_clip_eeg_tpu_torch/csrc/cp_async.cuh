// 16-byte asynchronous copies from device to shared memory (cp.async), shared
// by the weight-gradient tile (wgrad.cuh) and the row tile (rowtile.cuh).
#pragma once

#include <cuda_runtime.h>

namespace {

// 16 bytes from device to shared memory, or 16 zero bytes when !valid (src
// must still be a device address)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace
