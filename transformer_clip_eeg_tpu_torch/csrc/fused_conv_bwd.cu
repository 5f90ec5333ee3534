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
// moves a few [B, T, C] planes (about 0.01 ms at 3.35 TB/s).  dW is one
// product with M = K C (tap, input channel) and N = C over the B T rows
// whose A operand is a sliding window of x; what would hold it back is
// staging x and dconv anew for every tap (K times the operands through L2).
//
// Design: no atomics, the same result from run to run.
//  1. conv_bwd_rows_kernel, one CTA per sample: the elementwise chain above,
//     the joint means as fixed-order block sums (gh and y stay in shared
//     memory between the two passes).  Writes dconv, the per-sample terms
//     da * y and da of dscale and dbias, and the sample's column sums of
//     dconv (db's partials).
//  2. dw_partial_kernel: a CTA takes 4 neighbouring taps and a group of
//     samples.  It streams the samples' dconv rows, 32 at a time, and the 35
//     rows of x those rows meet under the 4 taps (rows outside the sample are
//     zero fills of the copy, so no padded copy of x exists) through a
//     4-stage cp.async ring; each of its 4 groups of 64 threads owns one tap
//     and adds that tap's 64 x 64 sums, 8 x 8 a thread, with wgrad.cuh's
//     inner product: the x row of group g is the dconv row shifted by g.
//     One staging serves 4 taps, nothing is added across threads, and the
//     grid is sized to one wave of two CTAs an SM.
//  3. wgrad.cuh's sums kernel, one launch: dW's partials over the sample
//     groups into torch's Conv1d layout [C_out][C_in][K], db over the
//     samples' column sums, dscale and dbias over the per-sample terms.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "conv_common.cuh"
#include "drop.cuh"
#include "wgrad.cuh"

namespace {

constexpr int DW_KT = 32;     // dconv rows per stage
constexpr int DW_TAPS = 4;    // taps per CTA: one per group of 64 threads
constexpr int DW_XROWS = DW_KT + DW_TAPS - 1;  // x rows per stage
constexpr int DW_STAGES = 4;  // stages of the cp.async ring
constexpr int DW_STAGE_FLOATS = (DW_KT + DW_XROWS) * C;
constexpr int DW_SMEM_BYTES = DW_STAGES * DW_STAGE_FLOATS * 4;
constexpr int DW_CTAS_PER_SM = 2;

static_assert(C == wgrad::TILE && wgrad::NT == DW_TAPS * 64, "a group of 64 threads a tap");
static_assert(CNT == 4 * C, "conv_bwd_rows_kernel adds four threads' sums per column");

__global__ void __launch_bounds__(CNT)
conv_bwd_rows_kernel(const float* __restrict__ g, const float* __restrict__ z,
                     const float* __restrict__ stats,
                     const float* __restrict__ scale, const float* __restrict__ lnb,
                     DropCfg drop, int T, float* __restrict__ dconv,
                     float* __restrict__ terms, float* __restrict__ dbp) {
  extern __shared__ __align__(16) float smem[];
  const int n = T * C;
  float* gh = smem;     // [T][C]
  float* ys = gh + n;   // [T][C]
  float* red = ys + n;  // [CNW]
  float* cols = red + CNW;  // [CNT / C][C]: the threads' sums of dconv by column
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
  float colsum = 0.f;  // CNT is a multiple of C: a thread stays in column tid % C
  for (int e = tid; e < n; e += CNT) {
    float d = (gh[e] - m1 - ys[e] * m2) * inv;
    if (drop.on) d *= drop_mult(ds.seed_base, idx0 + (uint32_t)e, drop.thr, drop.keep);
    dconv[base + e] = d;
    colsum += d;
  }
  cols[tid] = colsum;
  __syncthreads();
  if (tid < C)
    dbp[(size_t)b * C + tid] =
        (cols[tid] + cols[C + tid]) + (cols[2 * C + tid] + cols[3 * C + tid]);
}

// partial[s][k][i][o] = sum over the samples b of group s and the rows t of
// x[b][t + k - lo][i] dconv[b][t][o] (x is zero outside 0 <= row < T), for the
// taps k of tap group blockIdx.x
__global__ void __launch_bounds__(wgrad::NT, DW_CTAS_PER_SM)
dw_partial_kernel(const float* __restrict__ x, const float* __restrict__ dconv, int B, int T,
                  int K, int spc, float* __restrict__ partial) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = blockIdx.x * DW_TAPS, s = blockIdx.y;
  const int b0 = s * spc, b1 = b0 + spc < B ? b0 + spc : B;
  const int lo = (K - 1) / 2;
  const int per_sample = (T + DW_KT - 1) / DW_KT;  // stages per sample
  const int nst = (b1 - b0) * per_sample;
  // product role: group g owns tap k0 + g; thread (ty, tx) of its tile
  const int g = warp >> 1, tx = lane & 7, ty = ((warp & 1) << 2) | (lane >> 3);
  const bool active = k0 + g < K;

  // stage st: dconv rows t0 .. t0 + 31 of its sample, then x rows
  // t0 + k0 - lo .. + 34; a row outside the sample is a zero fill
  auto load_stage = [&](int st) {
    float* dst = smem + (st % DW_STAGES) * DW_STAGE_FLOATS;
    const int b = b0 + st / per_sample, t0 = (st % per_sample) * DW_KT;
    const float* db = dconv + (size_t)b * T * C;
    const float* xb = x + (size_t)b * T * C;
    for (int i = tid; i < (DW_KT + DW_XROWS) * (C / 4); i += wgrad::NT) {
      const int r = i / (C / 4), c4 = (i % (C / 4)) * 4;
      const bool is_x = r >= DW_KT;
      const int t = is_x ? t0 + (r - DW_KT) + k0 - lo : t0 + r;
      const bool in = t >= 0 && t < T;
      const float* src = is_x ? xb : db;
      wgrad::cp_async16(dst + r * C + c4, in ? src + (size_t)t * C + c4 : src, in);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int st = 0; st < DW_STAGES - 1; ++st) {
    if (st < nst) load_stage(st);
    wgrad::cp_async_commit();
  }
  for (int it = 0; it < nst; ++it) {
    wgrad::cp_async_wait<DW_STAGES - 2>();
    __syncthreads();
    if (it + DW_STAGES - 1 < nst) load_stage(it + DW_STAGES - 1);
    wgrad::cp_async_commit();
    if (active) {
      const float* dr = smem + (it % DW_STAGES) * DW_STAGE_FLOATS;  // dconv rows
      const float* xr = dr + (DW_KT + g) * C;                       // x rows, shifted by the tap
#pragma unroll 8
      for (int kk = 0; kk < DW_KT; ++kk)
        wgrad::fma_row(xr + kk * C, dr + kk * C, ty, tx, acc);
    }
  }
  wgrad::cp_async_wait<0>();
  if (!active) return;
  float* out = partial + ((size_t)s * K + k0 + g) * C * C;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = out + wgrad::tile_row(ty, i) * C;
    *reinterpret_cast<float4*>(row + 4 * tx) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + 32 + 4 * tx) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// samples per dW partial: the grid (tap groups x sample groups) is about one
// wave of DW_CTAS_PER_SM CTAs on each of the device's SMs
cudaError_t samples_per_partial(int B, int K, int* spc) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int tap_groups = (K + DW_TAPS - 1) / DW_TAPS;
  int groups = DW_CTAS_PER_SM * sms / tap_groups;
  groups = groups < 1 ? 1 : (groups > B ? B : groups);
  *spc = (B + groups - 1) / groups;
  return cudaSuccess;
}

struct Workspace {
  size_t terms, dbp, partial, total;  // offsets and total, in floats
  int spc, groups;                    // samples per dW partial, and partials
};

cudaError_t workspace(int B, int T, int K, Workspace* w) {
  const cudaError_t err = samples_per_partial(B, K, &w->spc);
  if (err != cudaSuccess) return err;
  w->groups = (B + w->spc - 1) / w->spc;
  w->terms = 0;
  w->dbp = 2 * (size_t)B * T * C;
  w->partial = w->dbp + (size_t)B * C;
  w->total = w->partial + (size_t)w->groups * K * C * C;
  return cudaSuccess;
}

}  // namespace

// floats of workspace tce_fused_conv_bwd needs (negative: a CUDA error code)
extern "C" long long tce_fused_conv_bwd_workspace(int B, int T, int K) {
  if (B <= 0 || T <= 0 || K <= 0) return -(long long)cudaErrorInvalidValue;
  Workspace w{};
  const cudaError_t err = workspace(B, T, K, &w);
  return err != cudaSuccess ? -(long long)err : (long long)w.total;
}

// The backward on `stream`; returns the CUDA error code (0 on success).
// Inputs: x, g, z [B][T][C], stats [B][2], scale and bias [T][C], the dropout
// arguments of the forward.  Outputs: dconv [B][T][C] (for the wrapper's dx),
// dw [C][C][K] (torch's layout), db [C], dln [2][T][C] (dscale, dbias).
// Three kernel launches.
extern "C" int tce_fused_conv_bwd(const float* x, const float* g, const float* z,
                                  const float* stats, const float* scale, const float* bias,
                                  float* dconv, float* dw, float* db, float* dln, float* ws,
                                  int B, int T, int c, int K, int drop_on, unsigned seed,
                                  int tb, unsigned thr, float keep, void* stream) {
  if (c != C || B <= 0 || T <= 0 || K <= 0 || K > MAX_K || tb <= 0)
    return (int)cudaErrorInvalidValue;
  if (!wgrad::aligned16(x) || !wgrad::aligned16(dconv) || !wgrad::aligned16(ws))
    return (int)cudaErrorInvalidValue;  // the 16-byte copies of dw_partial_kernel
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropCfg drop{drop_on, seed, tb, thr, keep, 0u, 1.f};
  Workspace w{};
  cudaError_t err = workspace(B, T, K, &w);
  if (err != cudaSuccess) return (int)err;
  float *terms = ws + w.terms, *dbp = ws + w.dbp, *partial = ws + w.partial;

  wgrad::Plan plan;
  if (!plan.add_sum(partial, (long long)K * C * C, w.groups, K * C * C, dw, K, C) ||
      !plan.add_sum(dbp, C, B, C, db) ||
      !plan.add_sum(terms, 2 * (long long)T * C, B, 2 * T * C, dln))
    return (int)cudaErrorInvalidValue;

  const size_t bytes = (2 * (size_t)T * C + CNW + CNT) * sizeof(float);
  int optin = 0;
  if ((err = smem_optin(&optin)) != cudaSuccess) return (int)err;
  if (bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(conv_bwd_rows_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  conv_bwd_rows_kernel<<<B, CNT, bytes, st>>>(g, z, stats, scale, bias, drop, T, dconv, terms,
                                              dbp);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(dw_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DW_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((K + DW_TAPS - 1) / DW_TAPS, w.groups);
  dw_partial_kernel<<<grid, wgrad::NT, DW_SMEM_BYTES, st>>>(x, dconv, B, T, K, w.spc, partial);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)plan.launch_sums(st);
}
