// Fused pre-LN transformer encoder block, backward, f32, with dropout.
//
// Replaces: transformer_clip_eeg_tpu/ops/pallas_block.py, _fused_block_bwd
// (pl.pallas_call at :498; kernel body _bwd_kernel :270-396).
//
// Computes dx and the 16 parameter gradients of the block in fused_block.cu
// for an upstream gradient g [B, T, E], with the forward's four dropout
// masks regenerated from the seed (drop.cuh):
//   FFN:        df2 = g*m2;  dW2 = df2^T gl_d;  dgl = (df2 W2)*m1;
//               df1 = dgl * gelu'(f1);  dW1 = df1^T LN2(x1);  dy2 = df1 W1
//   LN2:        dx1 = g + LNbwd(dy2);  dg2 = sum dy2*y2;  dbe2 = sum dy2
//   out-proj:   da = dx1*m_a;  dWo = da^T ctx;  dctx = da Wo
//   attention:  per head, dV = P~^T dctx;  dP = (dctx V^T)*m_h;
//               dS = P (dP - rowsum(dP P)) / scale;  dQ = dS K;  dK = dS^T Q
//   QKV, LN1:   dy1 = dQ Wq + dK Wk + dV Wv;  dx = dx1 + LNbwd(dy1);
//               dWq = dQ^T LN1(x) (and k, v);  dg1, dbe1
// with every bias gradient the column sum of its output's gradient.
//
// Bound on an H100 at the flagship shape (B=128, T=192): about 7.2 GFLOP of
// products (dX and dW for each forward product), about 0.11 ms at 67 TFLOP/s
// f32, against about 0.13 GB of inputs, scratch and outputs (0.04 ms at
// 3.35 TB/s): bound by f32 arithmetic.
//
// Design.  The TPU kernel recomputes the forward in VMEM per batch tile and
// accumulates dW across its sequential grid.  A CTA here has 227 KB, which
// a sample's Q, K, V, dctx, dQ, dK and dV do not fit in, so the backward is
// split into launches, each with the parallelism it needs:
//   1. ffn_bwd_kernel, 32 rows per CTA: FFN, LN2 and out-projection
//      backward from x1 (which the training forward saved), writing dctx and
//      the activations the weight gradients need.
//   2. attn_bwd_kernel, one CTA per (sample, head), 1024 CTAs: that head's
//      Q, K, V and dctx (8 columns each) in shared memory; a query-owned pass
//      recomputes each P row, writes dQ and keeps the row's max, sum and
//      rowsum(dP P); a key-owned pass recomputes P column by column from
//      those and writes dK and dV, so no atomics are needed.
//   3. qkv_bwd_kernel, 32 rows per CTA: dy1 from dQ, dK, dV, then LN1's
//      backward (LN1 recomputed from x) and dx.
//   4. The weight and bias gradients: per-chunk partial sums over the B*T
//      rows, then a fixed-order reduction (wgrad.cuh).
// The forward saved q, k, v, the dropped-out attention context and x1
// (about 31 MB at the flagship shape) rather than recomputing them; f1 and
// the LayerNorms are recomputed.  Plain f32 FMAs, no tensor cores.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_common.cuh"
#include "drop.cuh"
#include "wgrad.cuh"

namespace {

constexpr int NT = 256;       // threads per CTA
constexpr int NW = NT / 32;   // warps per CTA
constexpr int RB = 32;        // rows per CTA in the row kernels
constexpr int DS = D + 1;     // padded row stride of a head's Q, K, V, dctx

static_assert(F == NT, "the FFN phase maps one thread to one hidden unit");

// scratch planes, each [B*T][E] or [B*T][F], in the workspace
enum Plane { kDf2, kDy2, kDy2y, kDx1, kDa, kDctx, kDq, kDk, kDv, kY1a, kDy1, kDy1y, kY2a,
             kNumE };

struct Scratch {
  float* e[kNumE];  // [B*T][E] planes
  float* gld;       // [B*T][F]: dropped-out GELU output
  float* df1;       // [B*T][F]: gradient of the FFN's first product
  float* red;       // partial sums of the weight-gradient reductions
};

// ---- 1. FFN, LN2 and out-projection backward ---------------------------------
__global__ void __launch_bounds__(NT, 1)
ffn_bwd_kernel(const float* __restrict__ g, const float* __restrict__ x1,
               BlockParams P, int T, int BT, DropCfg drop, Scratch S) {
  extern __shared__ __align__(16) float smem[];
  float* y2s = smem;              // [RB][E] LN2, normalised (before the affine)
  float* y2as = y2s + RB * E;     // [RB][E] LN2 output
  float* df2s = y2as + RB * E;    // [RB][E]
  float* das = df2s + RB * E;     // [RB][E]
  float* df1s = das + RB * E;     // [RB][F]
  float* part = df1s + RB * F;    // [4][RB][E] partial sums of df1 W1
  float* inv2s = part + 4 * RB * E;  // [RB]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * RB;
  const float *g2 = P.p[10], *be2 = P.p[11], *w1 = P.p[12], *bb1 = P.p[13],
              *w2 = P.p[14], *wo = P.p[8];

  // 1a. LN2 of x1 and df2 = g * m2, a warp per row
  for (int r = warp; r < RB; r += NW) {
    const int row = row0 + r;
    if (row >= BT) {
      for (int e = lane; e < E; e += 32)
        y2s[r * E + e] = y2as[r * E + e] = df2s[r * E + e] = 0.f;
      continue;
    }
    const int b = row / T, t = row % T;
    const DropSample ds = drop_sample(drop, b, BLOCK_TILE_MULT);
    const float* xr = x1 + (size_t)row * E;
    const float a0 = xr[lane], a1 = xr[lane + 32];
    const float mean = warp_sum(a0 + a1) * (1.0f / E);
    const float d0 = a0 - mean, d1 = a1 - mean;
    const float var = warp_sum(d0 * d0 + d1 * d1) * (1.0f / E);
    const float inv = rsqrtf(var + 1e-5f);
    if (lane == 0) inv2s[r] = inv;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int e = lane + 32 * half;
      const float y = (half ? d1 : d0) * inv;
      const float ya = y * __ldg(g2 + e) + __ldg(be2 + e);
      y2s[r * E + e] = y;
      y2as[r * E + e] = ya;
      S.e[kY2a][(size_t)row * E + e] = ya;
      float d = g[(size_t)row * E + e];
      if (drop.on)
        d *= drop_mult(ds.seed_base + (uint32_t)(H + 2), (uint32_t)(ds.local * T + t) * E + e,
                       drop.thr, drop.keep);
      df2s[r * E + e] = d;
      S.e[kDf2][(size_t)row * E + e] = d;
    }
  }
  __syncthreads();

  // 1b. thread = hidden unit f: recompute f1, then df1
  {
    const int f = tid;
    float w1r[E];  // W1 row f
    load_row<E>(w1 + f * E, w1r);
    float w2c[E];  // W2 column f
#pragma unroll
    for (int o = 0; o < E; ++o) w2c[o] = __ldg(w2 + o * F + f);
    const float b1 = __ldg(bb1 + f);
    for (int r = 0; r < RB; ++r) {
      const int row = row0 + r;
      if (row >= BT) {
        df1s[r * F + f] = 0.f;
        continue;
      }
      const float f1 = dot_row<E>(y2as + r * E, w1r) + b1;
      float m1 = 1.f;
      if (drop.on) {
        const int b = row / T, t = row % T;
        const DropSample ds = drop_sample(drop, b, BLOCK_TILE_MULT);
        m1 = drop_mult(ds.seed_base + (uint32_t)(H + 1), (uint32_t)(ds.local * T + t) * F + f,
                       drop.thr_ffn, drop.keep_ffn);
      }
      const float gld = gelu(f1) * m1;
      const float df1 = dot_row<E>(df2s + r * E, w2c) * m1 * gelu_grad(f1);
      S.gld[(size_t)row * F + f] = gld;
      S.df1[(size_t)row * F + f] = df1;
      df1s[r * F + f] = df1;
    }
  }
  __syncthreads();

  // 1c. dy2 = df1 W1: thread = (column e, quarter q of F), partial sums
  {
    const int e = tid % E, q = tid / E;
    float w1c[F / 4];
#pragma unroll
    for (int i = 0; i < F / 4; ++i) w1c[i] = __ldg(w1 + (q * (F / 4) + i) * E + e);
    for (int r = 0; r < RB; ++r)
      part[(q * RB + r) * E + e] = dot_row<F / 4>(df1s + r * F + q * (F / 4), w1c);
  }
  __syncthreads();

  // 1d. LN2 backward, dx1 and da = dx1 * m_a, a warp per row
  for (int r = warp; r < RB; r += NW) {
    const int row = row0 + r;
    if (row >= BT) {
      for (int e = lane; e < E; e += 32) das[r * E + e] = 0.f;
      continue;
    }
    const int b = row / T, t = row % T;
    const DropSample ds = drop_sample(drop, b, BLOCK_TILE_MULT);
    float dy[2], y[2], gh[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int e = lane + 32 * half;
      dy[half] = (part[r * E + e] + part[(RB + r) * E + e]) +
                 (part[(2 * RB + r) * E + e] + part[(3 * RB + r) * E + e]);
      y[half] = y2s[r * E + e];
      gh[half] = dy[half] * __ldg(g2 + e);
    }
    const float mean_gh = warp_sum(gh[0] + gh[1]) * (1.0f / E);
    const float mean_ghy = warp_sum(gh[0] * y[0] + gh[1] * y[1]) * (1.0f / E);
    const float inv = inv2s[r];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int e = lane + 32 * half;
      const size_t o = (size_t)row * E + e;
      const float dx1 = g[o] + (gh[half] - mean_gh - y[half] * mean_ghy) * inv;
      float da = dx1;
      if (drop.on)
        da *= drop_mult(ds.seed_base + (uint32_t)H, (uint32_t)(ds.local * T + t) * E + e,
                        drop.thr, drop.keep);
      S.e[kDy2][o] = dy[half];
      S.e[kDy2y][o] = dy[half] * y[half];
      S.e[kDx1][o] = dx1;
      S.e[kDa][o] = da;
      das[r * E + e] = da;
    }
  }
  __syncthreads();

  // 1e. dctx = da Wo: thread = (column i, row group)
  {
    const int i = tid % E, rg = tid / E;
    float woc[E];  // Wo column i
#pragma unroll
    for (int o = 0; o < E; ++o) woc[o] = __ldg(wo + o * E + i);
    for (int r = rg; r < RB; r += NT / E) {
      const int row = row0 + r;
      if (row < BT) S.e[kDctx][(size_t)row * E + i] = dot_row<E>(das + r * E, woc);
    }
  }
}

// ---- 2. attention backward, one CTA per (sample, head) ------------------------
__global__ void __launch_bounds__(NT)
attn_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, int T, float inv_scale, DropCfg drop,
                Scratch S) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;            // [T][DS]
  float* Ks = Qs + T * DS;     // [T][DS]
  float* Vs = Ks + T * DS;     // [T][DS]
  float* Cs = Vs + T * DS;     // [T][DS] dctx
  float* mx_s = Cs + T * DS;   // [T] row max of the scores
  float* sum_s = mx_s + T;     // [T] row sum of exp(s - max)
  float* dl_s = sum_s + T;     // [T] rowsum(dP P)
  float* rows = dl_s + T;      // [NW][2][T] a P row and a dP row per warp

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const DropSample ds = drop_sample(drop, b, BLOCK_TILE_MULT);
  const uint32_t key = ds.seed_base + (uint32_t)h;
  const size_t base = (size_t)b * T * E + h * D;
  const float* __restrict__ dctx = S.e[kDctx];

  for (int i = tid; i < T * D; i += NT) {
    const int t = i / D, d = i % D;
    const size_t o = base + (size_t)t * E + d;
    Qs[t * DS + d] = q[o];
    Ks[t * DS + d] = k[o];
    Vs[t * DS + d] = v[o];
    Cs[t * DS + d] = dctx[o];
  }
  __syncthreads();

  // 2a. query-owned: a warp per query row t, lanes over the keys
  float* pr = rows + warp * 2 * T;
  float* dpr = pr + T;
  for (int t = warp; t < T; t += NW) {
    float qv[D], cv[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qv[d] = Qs[t * DS + d];
      cv[d] = Cs[t * DS + d];
    }
    float mx = -INFINITY;
    for (int j = lane; j < T; j += 32) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) s = fmaf(qv[d], Ks[j * DS + d], s);
      s *= inv_scale;
      pr[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < T; j += 32) {
      const float p = expf(pr[j] - mx);
      pr[j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    const uint32_t idx0 = (uint32_t)(ds.local * T + t) * (uint32_t)T;
    float delta = 0.f;
    for (int j = lane; j < T; j += 32) {
      float dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dp = fmaf(cv[d], Vs[j * DS + d], dp);
      if (drop.on) dp *= drop_mult(key, idx0 + j, drop.thr, drop.keep);
      dpr[j] = dp;
      delta += dp * (pr[j] / sum);
    }
    delta = warp_sum(delta);
    float acc[D];
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = 0.f;
    for (int j = lane; j < T; j += 32) {
      const float dsv = (pr[j] / sum) * (dpr[j] - delta) * inv_scale;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(dsv, Ks[j * DS + d], acc[d]);
    }
    float mine = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float a = warp_sum(acc[d]);
      if (lane == d) mine = a;
    }
    if (lane < D) S.e[kDq][base + (size_t)t * E + lane] = mine;
    if (lane == 0) {
      mx_s[t] = mx;
      sum_s[t] = sum;
      dl_s[t] = delta;
    }
  }
  __syncthreads();

  // 2b. key-owned: a warp per key j, lanes over the queries
  for (int j = warp; j < T; j += NW) {
    float kv[D], vv[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      kv[d] = Ks[j * DS + d];
      vv[d] = Vs[j * DS + d];
    }
    float ak[D], av[D];
#pragma unroll
    for (int d = 0; d < D; ++d) ak[d] = av[d] = 0.f;
    for (int t = lane; t < T; t += 32) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) s = fmaf(Qs[t * DS + d], kv[d], s);
      s *= inv_scale;
      const float p = expf(s - mx_s[t]) / sum_s[t];
      float dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dp = fmaf(Cs[t * DS + d], vv[d], dp);
      float m = 1.f;
      if (drop.on)
        m = drop_mult(key, (uint32_t)(ds.local * T + t) * (uint32_t)T + j, drop.thr, drop.keep);
      const float dsv = p * (dp * m - dl_s[t]) * inv_scale;
      const float pm = p * m;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        ak[d] = fmaf(dsv, Qs[t * DS + d], ak[d]);
        av[d] = fmaf(pm, Cs[t * DS + d], av[d]);
      }
    }
    float mk = 0.f, mv = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float a = warp_sum(ak[d]);
      const float c = warp_sum(av[d]);
      if (lane == d) {
        mk = a;
        mv = c;
      }
    }
    if (lane < D) {
      S.e[kDk][base + (size_t)j * E + lane] = mk;
      S.e[kDv][base + (size_t)j * E + lane] = mv;
    }
  }
}

// ---- 3. QKV and LN1 backward ---------------------------------------------------
__global__ void __launch_bounds__(NT)
qkv_bwd_kernel(const float* __restrict__ x, BlockParams P, int BT,
               float* __restrict__ dx, Scratch S) {
  extern __shared__ __align__(16) float smem[];
  float* dqkv = smem;             // [3][RB][E]
  float* part = dqkv + 3 * RB * E;  // [3][RB][E]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * RB;
  const float *g1 = P.p[0], *be1 = P.p[1];

  for (int i = tid; i < 3 * RB * E; i += NT) {
    const int m = i / (RB * E), r = (i / E) % RB, e = i % E;
    const int row = row0 + r;
    dqkv[i] = row < BT ? S.e[kDq + m][(size_t)row * E + e] : 0.f;
  }
  __syncthreads();

  // dy1 partials: thread = (projection m, column e), one weight column each
  if (tid < 3 * E) {
    const int m = tid / E, e = tid % E;
    const float* W = P.p[2 + m];
    float wc[E];
#pragma unroll
    for (int o = 0; o < E; ++o) wc[o] = __ldg(W + o * E + e);
    for (int r = 0; r < RB; ++r)
      part[(m * RB + r) * E + e] = dot_row<E>(dqkv + (m * RB + r) * E, wc);
  }
  __syncthreads();

  // LN1 recomputed from x, its backward and dx, a warp per row
  for (int r = warp; r < RB; r += NW) {
    const int row = row0 + r;
    if (row >= BT) continue;
    const float* xr = x + (size_t)row * E;
    const float a0 = xr[lane], a1 = xr[lane + 32];
    const float mean = warp_sum(a0 + a1) * (1.0f / E);
    const float d0 = a0 - mean, d1 = a1 - mean;
    const float var = warp_sum(d0 * d0 + d1 * d1) * (1.0f / E);
    const float inv = rsqrtf(var + 1e-5f);
    float dy[2], y[2], gh[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int e = lane + 32 * half;
      dy[half] = (part[r * E + e] + part[(RB + r) * E + e]) + part[(2 * RB + r) * E + e];
      y[half] = (half ? d1 : d0) * inv;
      gh[half] = dy[half] * __ldg(g1 + e);
    }
    const float mean_gh = warp_sum(gh[0] + gh[1]) * (1.0f / E);
    const float mean_ghy = warp_sum(gh[0] * y[0] + gh[1] * y[1]) * (1.0f / E);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int e = lane + 32 * half;
      const size_t o = (size_t)row * E + e;
      dx[o] = S.e[kDx1][o] + (gh[half] - mean_gh - y[half] * mean_ghy) * inv;
      S.e[kY1a][o] = y[half] * __ldg(g1 + e) + __ldg(be1 + e);
      S.e[kDy1][o] = dy[half];
      S.e[kDy1y][o] = dy[half] * y[half];
    }
  }
}

size_t attn_smem_floats(int T) { return 4 * (size_t)T * DS + 3 * (size_t)T + 2 * NW * (size_t)T; }
constexpr size_t kFfnSmemFloats = 4 * RB * E + RB * F + 4 * RB * E + RB;
constexpr size_t kQkvSmemFloats = 6 * RB * E;

size_t red_floats(int BT) {
  size_t n = wgrad::atb_workspace(E, F, BT);
  const size_t n2 = wgrad::atb_workspace(F, E, BT);
  const size_t n3 = wgrad::colsum_workspace(F, BT);
  if (n2 > n) n = n2;
  return n3 > n ? n3 : n;
}

cudaError_t set_smem(const void* fn, size_t floats, int optin) {
  const size_t bytes = floats * sizeof(float);
  if (bytes > (size_t)optin) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// Floats of workspace tce_fused_block_bwd needs for B samples of T rows.
extern "C" long long tce_fused_block_bwd_workspace(int B, int T) {
  const size_t bt = (size_t)B * T;
  return (long long)(bt * (kNumE * E + 2 * F) + red_floats(B * T));
}

// Launch on `stream`; returns the CUDA error code (0 on success).
//   x, g [B][T][E]; saved [5][B][T][E] (q, k, v, ctx, x1 from the training
//   forward); params / dparams: the 16 tensors of BlockParams and their
//   gradients (written whole); dx [B][T][E]; ws: the workspace above.
extern "C" int tce_fused_block_bwd(const float* x, const float* g, const float* saved,
                                   const void* const* params, float* dx,
                                   void* const* dparams, float* ws, int B, int T,
                                   int e, int h, int f, float inv_scale, int drop_on,
                                   unsigned seed, int tb, unsigned thr, float keep,
                                   unsigned thr_ffn, float keep_ffn, void* stream) {
  if (e != E || h != H || f != F || B <= 0 || T <= 0 || tb <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropCfg drop{drop_on, seed, tb, thr, keep, thr_ffn, keep_ffn};
  BlockParams P;
  float* dP[16];
  for (int i = 0; i < 16; ++i) {
    P.p[i] = static_cast<const float*>(params[i]);
    dP[i] = static_cast<float*>(dparams[i]);
  }
  const int BT = B * T;
  const size_t plane = (size_t)BT * E;
  Scratch S;
  for (int i = 0; i < kNumE; ++i) S.e[i] = ws + i * plane;
  S.gld = ws + kNumE * plane;
  S.df1 = S.gld + (size_t)BT * F;
  S.red = S.df1 + (size_t)BT * F;
  const float *q = saved, *k = saved + plane, *v = saved + 2 * plane,
              *ctx = saved + 3 * plane, *x1 = saved + 4 * plane;

  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if ((err = set_smem((const void*)ffn_bwd_kernel, kFfnSmemFloats, optin)) != cudaSuccess ||
      (err = set_smem((const void*)attn_bwd_kernel, attn_smem_floats(T), optin)) != cudaSuccess ||
      (err = set_smem((const void*)qkv_bwd_kernel, kQkvSmemFloats, optin)) != cudaSuccess)
    return (int)err;

  const int row_ctas = (BT + RB - 1) / RB;
  ffn_bwd_kernel<<<row_ctas, NT, kFfnSmemFloats * sizeof(float), st>>>(g, x1, P, T, BT, drop, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  attn_bwd_kernel<<<B * H, NT, attn_smem_floats(T) * sizeof(float), st>>>(q, k, v, T, inv_scale,
                                                                          drop, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  qkv_bwd_kernel<<<row_ctas, NT, kQkvSmemFloats * sizeof(float), st>>>(x, P, BT, dx, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  using wgrad::rows;
  const wgrad::Rows rowsE[kNumE] = {
      rows(S.e[0], E), rows(S.e[1], E), rows(S.e[2], E), rows(S.e[3], E), rows(S.e[4], E),
      rows(S.e[5], E), rows(S.e[6], E), rows(S.e[7], E), rows(S.e[8], E), rows(S.e[9], E),
      rows(S.e[10], E), rows(S.e[11], E), rows(S.e[12], E)};
  const wgrad::Rows gld = rows(S.gld, F), df1 = rows(S.df1, F), ctxr = rows(ctx, E);
  // weights: dW = (gradient of the product's output)^T (its input)
  struct Atb { wgrad::Rows a, b; int m, n; int out; };
  const Atb atbs[] = {
      {rowsE[kDf2], gld, E, F, 14},        // dW2 [E][F]
      {df1, rowsE[kY2a], F, E, 12},        // dW1 [F][E]
      {rowsE[kDa], ctxr, E, E, 8},         // dWo
      {rowsE[kDq], rowsE[kY1a], E, E, 2},  // dWq
      {rowsE[kDk], rowsE[kY1a], E, E, 3},  // dWk
      {rowsE[kDv], rowsE[kY1a], E, E, 4},  // dWv
  };
  for (const Atb& j : atbs)
    if ((err = wgrad::atb(j.a, j.b, j.m, j.n, BT, dP[j.out], S.red, st)) != cudaSuccess)
      return (int)err;
  struct Sum { wgrad::Rows a; int n; int out; };
  const Sum sums[] = {
      {rowsE[kDy1y], E, 0}, {rowsE[kDy1], E, 1},                        // dg1, dbe1
      {rowsE[kDq], E, 5}, {rowsE[kDk], E, 6}, {rowsE[kDv], E, 7},       // dbq, dbk, dbv
      {rowsE[kDa], E, 9},                                               // dbo
      {rowsE[kDy2y], E, 10}, {rowsE[kDy2], E, 11},                      // dg2, dbe2
      {df1, F, 13}, {rowsE[kDf2], E, 15},                               // dbb1, dbb2
  };
  for (const Sum& j : sums)
    if ((err = wgrad::colsum(j.a, j.n, BT, dP[j.out], S.red, st)) != cudaSuccess)
      return (int)err;
  return (int)cudaSuccess;
}
