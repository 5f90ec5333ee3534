// Fused conv BasicBlock, backward: dconv, dW, db, dscale and dbias.  dx is
// the conv-only mode of fused_conv.cu, launched by the wrapper on dconv.
//
// Replaces: transformer_clip_eeg_tpu/ops/pallas_conv.py, _fbb_bwd
// (pl.pallas_call at :308; kernel body _bwd_kernel :161).
//
// From what the training forward saved (z, the conv output after dropout,
// and (mean, 1/sigma) per sample) and the upstream gradient g:
//   y  = (z - mean) * inv,  a = y * scale + bias
//   da = g * gelu'(a),  gh = da * scale
//   dz = (gh - mean(gh) - y * mean(gh * y)) * inv     means over [T, C] (_lntc_bwd)
//   dconv = dz * mask
//   dscale = sum_b da * y,  dbias = sum_b da,  db = sum_{b,t} dconv
//   dW[k] = sum_{b,t} u[b, t + k]^T dconv[b, t]        u = x padded (lo, hi)
// and dx is dconv padded (hi, lo) correlated with the tap-flipped, transposed
// kernel (pallas_conv.py :217-221).  The TPU kernel recomputes the forward,
// conv included; here the training forward saved z instead (6.3 MB per
// [128, 192, 64] block), so the backward runs no forward conv.
//
// Bound on an H100 at the flagship shape (B=128, T=192, C=64, K=64): dW is
// 2 B T K C^2 = 12.9 GFLOP, and dx as much again, so the backward is bound by
// f32 arithmetic (0.385 ms for both at 67 TFLOP/s); its elementwise part
// moves a few [B, T, C] planes (about 0.01 ms at 3.35 TB/s).
//
// Design: no atomics, the same result from run to run.
//  1. conv_bwd_rows_kernel, one CTA per sample: the elementwise chain above,
//     the joint means as fixed-order block sums (gh and y stay in shared
//     memory between the two passes).  Writes dconv, the per-sample terms
//     da * y and da of dscale and dbias, and x padded (lo, hi) with zero rows
//     for the dW products.
//  2. dw_partial_kernel: one CTA per (chunk of rows, tap) computes its
//     64 x 64 partial of dW[k] with wgrad.cuh's tile, over a Rows view of
//     the padded x shifted by the tap (inner = T, outer = (T+K-1) C, ld = C);
//     dw_reduce_kernel adds the partials in chunk order and writes torch's
//     Conv1d layout [C_out][C_in][K].
//  3. db, dscale and dbias: wgrad.cuh's column sums over the B T rows of
//     dconv and over the B rows of the per-sample terms.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "conv_common.cuh"
#include "drop.cuh"
#include "wgrad.cuh"

namespace {

constexpr int DW_ROWS = 2048;  // rows (b, t) per dW partial

__global__ void __launch_bounds__(CNT)
conv_bwd_rows_kernel(const float* __restrict__ x, const float* __restrict__ g,
                     const float* __restrict__ z, const float* __restrict__ stats,
                     const float* __restrict__ scale, const float* __restrict__ lnb,
                     DropCfg drop, int T, int K, float* __restrict__ dconv,
                     float* __restrict__ terms, float* __restrict__ upad) {
  extern __shared__ __align__(16) float smem[];
  const int n = T * C;
  float* gh = smem;     // [T][C]
  float* ys = gh + n;   // [T][C]
  float* red = ys + n;  // [CNW]
  const int tid = threadIdx.x, b = blockIdx.x;
  const size_t base = (size_t)b * n;
  const float mean = stats[2 * b], inv = stats[2 * b + 1];
  float* tm = terms + 2 * base;  // [2][T][C]: da * y, then da

  float s1 = 0.f, s2 = 0.f;
  for (int e = tid; e < n; e += CNT) {
    const float y = (z[base + e] - mean) * inv;
    const float sc = __ldg(scale + e);
    const float da = g[base + e] * gelu_grad(fmaf(y, sc, __ldg(lnb + e)));
    const float h = da * sc;
    gh[e] = h;
    ys[e] = y;
    s1 += h;
    s2 = fmaf(h, y, s2);
    tm[e] = da * y;
    tm[n + e] = da;
  }
  const float m1 = block_sum(s1, red) / (float)n;
  const float m2 = block_sum(s2, red) / (float)n;
  const DropSample ds = drop_sample(drop, b, CONV_TILE_MULT);
  const uint32_t idx0 = (uint32_t)ds.local * (uint32_t)n;
  for (int e = tid; e < n; e += CNT) {
    float d = (gh[e] - m1 - ys[e] * m2) * inv;
    if (drop.on) d *= drop_mult(ds.seed_base, idx0 + (uint32_t)e, drop.thr, drop.keep);
    dconv[base + e] = d;
  }

  const int lo = (K - 1) / 2, rows_u = T + K - 1;
  float* ub = upad + (size_t)b * rows_u * C;
  for (int i = tid; i < rows_u * C; i += CNT) {
    const int src = i / C - lo;
    ub[i] = (src >= 0 && src < T) ? x[base + (size_t)src * C + i % C] : 0.f;
  }
}

// partial[s][k] = sum over the rows (b, t) of chunk s of upad[b][t + k]^T dconv[b][t]
__global__ void __launch_bounds__(wgrad::NT)
dw_partial_kernel(const float* __restrict__ upad, const float* __restrict__ dconv, int B,
                  int T, int K, float* __restrict__ partial) {
  const int s = blockIdx.x, k = blockIdx.y;
  const int k0 = s * DW_ROWS;
  const int k1 = k0 + DW_ROWS < B * T ? k0 + DW_ROWS : B * T;
  const wgrad::Rows a{upad + (size_t)k * C, T, (long long)(T + K - 1) * C, C};
  const wgrad::Rows d = wgrad::rows(dconv, C);
  wgrad::atb_tile(a, d, C, C, k0, k1, 0, 0, partial + ((size_t)s * K + k) * C * C);
}

// dw[o][i][k] = sum over s, in order, of partial[s][k][i][o]
__global__ void dw_reduce_kernel(const float* __restrict__ partial, int S, int K,
                                 float* __restrict__ dw) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;  // [K][C][C] order
  if (idx >= K * C * C) return;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += partial[(size_t)s * K * C * C + idx];
  const int k = idx / (C * C), i = (idx / C) % C, o = idx % C;
  dw[((size_t)o * C + i) * K + k] = acc;
}

struct Workspace {
  size_t upad, terms, partial, sums, total;  // offsets and total, in floats
};

Workspace workspace(int B, int T, int K) {
  const size_t n = (size_t)T * C;
  const size_t upad = (size_t)B * (T + K - 1) * C;
  const size_t terms = 2 * (size_t)B * n;
  const size_t partial = (size_t)wgrad::chunks(B * T, DW_ROWS) * K * C * C;
  const size_t s1 = wgrad::colsum_workspace(C, B * T);
  const size_t s2 = wgrad::colsum_workspace(2 * T * C, B);
  Workspace w{};
  w.upad = 0;
  w.terms = upad;
  w.partial = w.terms + terms;
  w.sums = w.partial + partial;
  w.total = w.sums + (s1 > s2 ? s1 : s2);
  return w;
}

}  // namespace

// floats of workspace tce_fused_conv_bwd needs
extern "C" long long tce_fused_conv_bwd_workspace(int B, int T, int K) {
  return (long long)workspace(B, T, K).total;
}

// The backward on `stream`; returns the CUDA error code (0 on success).
// Inputs: x, g, z [B][T][C], stats [B][2], scale and bias [T][C], the dropout
// arguments of the forward.  Outputs: dconv [B][T][C] (for the wrapper's dx),
// dw [C][C][K] (torch's layout), db [C], dln [2][T][C] (dscale, dbias).
extern "C" int tce_fused_conv_bwd(const float* x, const float* g, const float* z,
                                  const float* stats, const float* scale, const float* bias,
                                  float* dconv, float* dw, float* db, float* dln, float* ws,
                                  int B, int T, int c, int K, int drop_on, unsigned seed,
                                  int tb, unsigned thr, float keep, void* stream) {
  if (c != C || B <= 0 || T <= 0 || K <= 0 || K > MAX_K || tb <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropCfg drop{drop_on, seed, tb, thr, keep, 0u, 1.f};
  const Workspace w = workspace(B, T, K);
  const size_t bytes = (2 * (size_t)T * C + CNW) * sizeof(float);
  int optin = 0;
  cudaError_t err = smem_optin(&optin);
  if (err != cudaSuccess) return (int)err;
  if (bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(conv_bwd_rows_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  conv_bwd_rows_kernel<<<B, CNT, bytes, st>>>(x, g, z, stats, scale, bias, drop, T, K, dconv,
                                              ws + w.terms, ws + w.upad);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int S = wgrad::chunks(B * T, DW_ROWS);
  dw_partial_kernel<<<dim3(S, K), wgrad::NT, 0, st>>>(ws + w.upad, dconv, B, T, K,
                                                      ws + w.partial);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dw_reduce_kernel<<<(K * C * C + 255) / 256, 256, 0, st>>>(ws + w.partial, S, K, dw);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  err = wgrad::colsum(wgrad::rows(dconv, C), C, B * T, db, ws + w.sums, st);
  if (err != cudaSuccess) return (int)err;
  return (int)wgrad::colsum(wgrad::rows(ws + w.terms, 2 * (long long)T * C), 2 * T * C, B,
                            dln, ws + w.sums, st);
}
