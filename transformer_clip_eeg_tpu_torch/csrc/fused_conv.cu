// Fused conv BasicBlock, forward, f32, eval or training; and the same
// convolution alone.
//
// Replaces: transformer_clip_eeg_tpu/ops/pallas_conv.py, _fbb_fwd
// (pl.pallas_call at :267; kernel body _fwd_kernel :143 / _forward_core
// :129), and, as its conv-only mode, the conv-only Pallas kernel of
// scripts/bench_conv_algo.py (make_pallas, pl.pallas_call at :74).
//
// Computes, for x [B, T, C] (C = 64 in and out) and K taps:
//   u    = x with `pad` zero rows before it and K-1-pad after
//   conv = sum_k u[t + k] W[k] + b                 W[k] is [C_in][C_out]
//   z    = conv * mask                             training only (drop.cuh,
//                                                  key (seed + b/tb) * 7577)
//   y    = (z - mean) / sqrt(var + 1e-5)           over the sample's [T, C]
//   out  = gelu(y * scale + bias)                  scale, bias [T, C]; erf GELU
// with pad = (K-1)/2, torch's 'same' padding.  The conv-only mode
// (tce_conv1d_fwd) stops at sum_k u[t + k] W[k], for any pad: no bias, no
// mask, no LayerNorm, no GELU.  The backward's wrapper runs it for dx, with
// the tap-flipped, transposed kernel and the padding swapped.
//
// W arrives tap-major, [K][C_in][C_out] (the JAX kernel's layout); the
// wrapper re-lays torch's Conv1d weight [C_out][C_in][K] into it.
//
// Bound on an H100 at the flagship shape (B=128, T=192, C=64, K=64):
// 2 B T K C^2 = 12.9 GFLOP against 6.3 MB in and 6.3 MB out, so the block is
// bound by f32 arithmetic (0.192 ms at 67 TFLOP/s outside the tensor cores),
// not by memory (about 4 us at 3.35 TB/s).  K=32 (the speech block) is half.
//
// Design: one CTA of 256 threads per sample.  The padded sample sits in
// shared memory with rows padded to C+4 floats, so that 8 consecutive rows
// read as float4s hit 32 different banks; the K taps of W stream through a
// double buffer in shared memory by cp.async, each 16 KB tap read once per
// CTA from L2.  Each thread owns 6 rows (t = ty + 32 r) by 8 columns of a
// 192-row pass and keeps its 48 sums in registers: per 4 input channels it
// reads 6 float4s of input and 8 of weights for 192 FMAs.  A window longer
// than 192 rows takes more passes (the rows past T of the last pass are
// computed on row T-1 and dropped).  In the fused mode the conv output stays
// in shared memory for the joint LayerNorm (two passes, as _lntc_fwd, with
// fixed-order block sums); nothing but x, W and out touches device memory,
// except that the training forward under autograd also writes z and
// (mean, 1/sigma) per sample for the backward (fused_conv_bwd.cu), which then
// needs no forward conv.  Plain f32 FMAs, no tensor cores.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "conv_common.cuh"
#include "drop.cuh"

namespace {

constexpr int TY = 32;          // row groups of a pass
constexpr int TX = 8;           // column groups
constexpr int RT = 6;           // rows per thread per pass
constexpr int CT = C / TX;      // columns per thread
constexpr int ROWS = TY * RT;   // rows per pass
constexpr int US = C + 4;       // padded row stride of the staged sample
static_assert(TY * TX == CNT, "one thread per (row group, column group)");
static_assert(CT == 8, "two float4s of weights per input channel");

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// tap k of W ([C][C], 16 KB) into shared memory, as one commit group
__device__ __forceinline__ void stage_tap(const float* __restrict__ w, int k,
                                          float* dst) {
  const float* src = w + (size_t)k * C * C;
  for (int i = threadIdx.x; i < C * C / 4; i += CNT) cp_async16(dst + 4 * i, src + 4 * i);
  cp_async_commit();
}

__device__ __forceinline__ float lane_of(const float4& v, int q) {
  return q == 0 ? v.x : (q == 1 ? v.y : (q == 2 ? v.z : v.w));
}

// acc[r][j] = sum_k sum_i u[t_r + k][i] W[k][i][tx*CT + j] for the thread's
// rows t_r = p0 + ty + TY r of one pass (a row past T reads row T-1)
__device__ __forceinline__ void conv_pass(const float* us, const float* __restrict__ w,
                                          float* wbuf, int T, int K, int p0, int ty,
                                          int tx, float (&acc)[RT][CT]) {
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[r][j] = 0.f;
  int off[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int t = p0 + ty + TY * r;
    off[r] = (t < T ? t : T - 1) * US;
  }
  stage_tap(w, 0, wbuf);
  for (int k = 0; k < K; ++k) {
    if (k + 1 < K) {
      stage_tap(w, k + 1, wbuf + ((k + 1) & 1) * C * C);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* wk = wbuf + (k & 1) * C * C + tx * CT;
    const float* uk = us + k * US;
#pragma unroll 2
    for (int i = 0; i < C; i += 4) {
      float4 a[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) a[r] = *reinterpret_cast<const float4*>(uk + off[r] + i);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 b0 = *reinterpret_cast<const float4*>(wk + (i + q) * C);
        const float4 b1 = *reinterpret_cast<const float4*>(wk + (i + q) * C + 4);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float av = lane_of(a[r], q);
          acc[r][0] = fmaf(av, b0.x, acc[r][0]);
          acc[r][1] = fmaf(av, b0.y, acc[r][1]);
          acc[r][2] = fmaf(av, b0.z, acc[r][2]);
          acc[r][3] = fmaf(av, b0.w, acc[r][3]);
          acc[r][4] = fmaf(av, b1.x, acc[r][4]);
          acc[r][5] = fmaf(av, b1.y, acc[r][5]);
          acc[r][6] = fmaf(av, b1.z, acc[r][6]);
          acc[r][7] = fmaf(av, b1.w, acc[r][7]);
        }
      }
    }
    __syncthreads();  // the next iteration refills this tap's buffer
  }
}

// floats of shared memory: the padded sample, W's double buffer, in the fused
// mode the conv output, and the block sums
__host__ __device__ inline size_t smem_floats(int T, int K, bool fused) {
  return (size_t)(T + K - 1) * US + 2 * C * C + (fused ? (size_t)T * C : 0) + CNW;
}

template <bool FUSED>
__global__ void __launch_bounds__(CNT, 1)
conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ cb, const float* __restrict__ scale,
            const float* __restrict__ lnb, float* __restrict__ out, int T, int K, int pad,
            DropCfg drop, float* __restrict__ saved_z, float* __restrict__ saved_stats) {
  extern __shared__ __align__(16) float smem[];
  const int rows_u = T + K - 1;
  float* us = smem;                 // [T+K-1][US]: the padded sample
  float* wbuf = us + rows_u * US;   // [2][C][C]: taps k and k+1
  float* cs = wbuf + 2 * C * C;     // fused: [T][C], the conv output
  float* red = cs + (FUSED ? T * C : 0);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // a warp covers 8 consecutive row groups by 4 column groups
  const int tx = (warp & 1) * 4 + (lane & 3);
  const int ty = (warp >> 1) * 8 + (lane >> 2);
  const int b = blockIdx.x;
  const size_t base = (size_t)b * T * C;

  for (int i = tid; i < rows_u * (C / 4); i += CNT) {
    const int j = i / (C / 4), c4 = i % (C / 4), src = j - pad;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (src >= 0 && src < T)
      v = __ldg(reinterpret_cast<const float4*>(x + base + (size_t)src * C) + c4);
    *reinterpret_cast<float4*>(us + j * US + 4 * c4) = v;
  }
  __syncthreads();

  float bias[CT];
#pragma unroll
  for (int j = 0; j < CT; ++j) bias[j] = FUSED ? __ldg(cb + tx * CT + j) : 0.f;
  for (int p0 = 0; p0 < T; p0 += ROWS) {
    float acc[RT][CT];
    conv_pass(us, w, wbuf, T, K, p0, ty, tx, acc);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int t = p0 + ty + TY * r;
      if (t >= T) continue;
      float* dst = FUSED ? cs + t * C + tx * CT : out + base + (size_t)t * C + tx * CT;
      reinterpret_cast<float4*>(dst)[0] =
          make_float4(acc[r][0] + bias[0], acc[r][1] + bias[1], acc[r][2] + bias[2],
                      acc[r][3] + bias[3]);
      reinterpret_cast<float4*>(dst)[1] =
          make_float4(acc[r][4] + bias[4], acc[r][5] + bias[5], acc[r][6] + bias[6],
                      acc[r][7] + bias[7]);
    }
  }
  if (!FUSED) return;
  __syncthreads();

  // dropout, then the joint LayerNorm in two passes, then GELU
  const int n = T * C;
  const DropSample ds = drop_sample(drop, b, CONV_TILE_MULT);
  const uint32_t idx0 = (uint32_t)ds.local * (uint32_t)n;
  float s = 0.f;
  for (int e = tid; e < n; e += CNT) {
    float v = cs[e];
    if (drop.on) {
      v *= drop_mult(ds.seed_base, idx0 + (uint32_t)e, drop.thr, drop.keep);
      cs[e] = v;
    }
    s += v;
  }
  const float mean = block_sum(s, red) / (float)n;
  float s2 = 0.f;
  for (int e = tid; e < n; e += CNT) {
    const float d = cs[e] - mean;
    s2 = fmaf(d, d, s2);
  }
  const float inv = rsqrtf(block_sum(s2, red) / (float)n + 1e-5f);
  if (saved_z != nullptr) {
    for (int e = tid; e < n; e += CNT) saved_z[base + e] = cs[e];
    if (tid == 0) {
      saved_stats[2 * b] = mean;
      saved_stats[2 * b + 1] = inv;
    }
  }
  for (int e = tid; e < n; e += CNT) {
    const float y = (cs[e] - mean) * inv;
    out[base + e] = gelu(fmaf(y, __ldg(scale + e), __ldg(lnb + e)));
  }
}

template <bool FUSED>
int launch(const float* x, const float* w, const float* cb, const float* scale,
           const float* lnb, float* out, int B, int T, int K, int pad, DropCfg drop,
           float* saved_z, float* saved_stats, void* stream) {
  if (B <= 0 || T <= 0 || K <= 0 || K > MAX_K || pad < 0 || pad > K - 1)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_floats(T, K, FUSED) * sizeof(float);
  int optin = 0;
  cudaError_t err = smem_optin(&optin);
  if (err != cudaSuccess) return (int)err;
  if (bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(conv_kernel<FUSED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  conv_kernel<FUSED><<<B, CNT, bytes, static_cast<cudaStream_t>(stream)>>>(
      x, w, cb, scale, lnb, out, T, K, pad, drop, saved_z, saved_stats);
  return (int)cudaGetLastError();
}

}  // namespace

// The fused block on `stream`; returns the CUDA error code (0 on success).
// w is tap-major [K][C][C]; b [C]; scale, bias [T][C].  The dropout
// arguments are DropCfg's first five (drop.cuh).  saved_z ([B][T][C]) and
// saved_stats ([B][2]: mean, 1/sigma) are both NULL or both written.
extern "C" int tce_fused_conv_fwd(const float* x, const float* w, const float* b,
                                  const float* scale, const float* bias, float* out, int B,
                                  int T, int c, int K, int drop_on, unsigned seed, int tb,
                                  unsigned thr, float keep, float* saved_z,
                                  float* saved_stats, void* stream) {
  if (c != C || tb <= 0 || (saved_z == nullptr) != (saved_stats == nullptr))
    return (int)cudaErrorInvalidValue;
  const DropCfg drop{drop_on, seed, tb, thr, keep, 0u, 1.f};
  return launch<true>(x, w, b, scale, bias, out, B, T, K, (K - 1) / 2, drop, saved_z,
                      saved_stats, stream);
}

// The convolution alone: out[b][t] = sum_k u[t + k] W[k], u = x with `pad`
// zero rows before it and K-1-pad after; w tap-major [K][C][C].
extern "C" int tce_conv1d_fwd(const float* x, const float* w, float* out, int B, int T,
                              int c, int K, int pad, void* stream) {
  if (c != C) return (int)cudaErrorInvalidValue;
  const DropCfg off{0, 0u, 1, 0u, 1.f, 0u, 1.f};
  return launch<false>(x, w, nullptr, nullptr, nullptr, out, B, T, K, pad, off, nullptr,
                       nullptr, stream);
}
