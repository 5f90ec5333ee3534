// Fused pre-LN transformer encoder block, backward, f32 or bf16 mode, with
// dropout.
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
// 3.35 TB/s): bound by f32 arithmetic.  What holds a simple version back on
// this card is not the FMAs but shared-memory loads, a second pass over the
// attention pairs and tens of small launches; the design is about those.
//
// Design.  The TPU kernel recomputes the forward in VMEM per batch tile and
// accumulates dW across its sequential grid.  A CTA here has 227 KB, which
// a sample's Q, K, V, dctx, dQ, dK and dV do not fit in, so the backward is
// five launches, each with the parallelism it needs:
//   1. ffn_bwd_kernel, 32 rows per CTA: FFN, LN2 and out-projection
//      backward from x1 (which the training forward saved), writing dctx and
//      the activations the weight gradients need, and this CTA's column sums
//      of df2, df1, da, dy2 and dy2*y2 (the bias and LN2 gradients' partials).
//   2. attn_bwd_kernel, one CTA per (sample, head), 1024 CTAs, each (query,
//      key) pair computed once.  Two identities make one pass enough:
//      rowsum(dP P) = dctx . ctx (ctx is the dropped-out context the forward
//      saved), and P = exp(s - lse) with the row's log-sum-exp saved by the
//      forward, so no row statistics are recomputed and nothing is divided.
//      A warp owns a tile of 32 keys, one key a lane (the CTA has a warp per
//      tile, 6 at T=192, so none idles): k, v, dK and dV of the key stay in
//      registers while the warp walks a block of 32 queries, whose q, dctx,
//      lse and delta are one 80-byte record in shared memory read as five
//      broadcast LDS.128, and leaves the block's dS in shared memory.  Then
//      the warp turns: one query a lane, dQ += dS K over the tile's keys (dS
//      read down a padded column, K as broadcast rows), so dQ needs no sum
//      across lanes.  The warps take the query blocks in rotation, block
//      (warp + step) mod blocks with a barrier a step, so each dQ row is
//      added to by one warp at a time and in a fixed order: no atomics.
//   3. qkv_bwd_kernel, 32 rows per CTA: dy1 from dQ, dK, dV, then LN1's
//      backward (LN1 recomputed from x) and dx, and this CTA's column sums of
//      dQ, dK, dV, dy1 and dy1*y1.
//   4. The six weight gradients as one launch of wgrad.cuh's product kernel
//      (1,152 CTAs at the flagship shape), per-chunk partial sums.
//   5. One launch that adds the products' partials and the row kernels'
//      column sums in a fixed order (wgrad.cuh's sums kernel).
// The forward saved q, k, v, the dropped-out attention context, x1 and the
// log-sum-exp (about 32 MB at the flagship shape) rather than recomputing
// them; f1 and the LayerNorms are recomputed.  Plain f32 FMAs, no tensor
// cores.
//
// The bf16 mode (the JAX kernel's mm_dtype='bfloat16'; the forward's bf16
// instantiation saved q, k, v and the context as bf16 values) has kernels of
// its own in place of 1-4, with the same launch 5 and the same workspace: g
// and x are read as bf16, dx written as bf16, the parameter
// gradients as f32, and every product's operands are rounded to bf16 where
// they are staged or made, with f32 sums; what a column sum (a bias or
// LayerNorm gradient) adds stays unrounded, as in JAX.  Every product runs on
// the tensor cores (mma.sync m16n8k16 and m16n8k8 bf16):
//   1'. ffn_bwd_bf16_kernel: dgl = df2 W2, dy2 = df1 W1, dctx = da Wo and the
//       recomputed f1 = y2a W1^T, with W1, W2 and Wo staged once as bf16 rows
//       by CTAs that stay on their SMs (two an SM) and walk the tiles of RB
//       rows; f1 and dgl are made side by side so that df1 and gld come
//       straight out of the accumulators.
//   2'. attn_bwd_bf16_kernel: S^T, dP^T, dV, dK and dQ (the scheme is
//       written above it); the pair's exp, mask and dS stay f32 FMAs.
//   3'. qkv_bwd_bf16_kernel: dy1 = dq Wq + dk Wk + dv Wv as one product over
//       3E, Wq, Wk and Wv staged once (three CTAs an SM).
//   4'. products_bf16_kernel: the six weight gradients, wgrad's jobs and
//       partials with the tile's sums on mma.sync.
// What bounds them now: the f32 planes the row kernels write and 4' reads
// back for the weight gradients (about 90 MB written and 107 MB read at the
// flagship shape, 59 us at 3.35 TB/s) and, in 2', the FMAs, exponentials
// and mask hashes of 37.7 M pairs; the products take about 7 us at the bf16
// tensor-core rate.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_common.cuh"
#include "drop.cuh"
#include "rowtile.cuh"
#include "wgrad.cuh"

namespace {

constexpr int NT = 256;       // threads per CTA
constexpr int NW = NT / 32;   // warps per CTA
constexpr int RB = 32;        // rows per CTA in the row kernels
constexpr int QS = 2 * D + 4;  // floats of a query's record: q, dctx, lse, delta, 2 unused
constexpr int KEYS = 32;      // keys per tile of the attention backward: one a lane
constexpr int DSS = KEYS + 1;  // row stride of a warp's dS block: a column read hits 32 banks
constexpr int WARP_FLOATS = KEYS * DSS + KEYS * D + 4;  // a warp's dS block and keys
constexpr int FFN_SUMS = 4 * E + F;  // ffn_bwd_kernel's column sums: df2, dy2*y2, dy2, da, df1
constexpr int QKV_SUMS = 5 * E;      // qkv_bwd_kernel's: dq, dk, dv, dy1*y1, dy1

static_assert(F == NT, "the FFN phase maps one thread to one hidden unit");
static_assert(D == 8 && QS % 4 == 0 && WARP_FLOATS % 4 == 0, "a head's row is two float4");
static_assert(4 * E == NT, "ffn_bwd_kernel's four E-wide column sums take a thread each");

// scratch planes, each [B*T][E] or [B*T][F], in the workspace
enum Plane { kDf2, kDx1, kDa, kDctx, kDq, kDk, kDv, kY1a, kY2a, kNumE };

struct Scratch {
  float* e[kNumE];  // [B*T][E] planes
  float* gld;       // [B*T][F]: dropped-out GELU output
  float* df1;       // [B*T][F]: gradient of the FFN's first product
  float* sums_ffn;  // [row CTAs][FFN_SUMS]: ffn_bwd_kernel's column sums
  float* sums_qkv;  // [row CTAs][QKV_SUMS]: qkv_bwd_kernel's column sums
};

// ---- 1. FFN, LN2 and out-projection backward ---------------------------------
__global__ void __launch_bounds__(NT, 2)
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
  float* wsum = inv2s + RB;          // [NW][2][E] each warp's sums of dy2*y2 and dy2

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * RB;
  float* sums = S.sums_ffn + (size_t)blockIdx.x * FFN_SUMS;
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

  // 1b. thread = hidden unit f: recompute f1, then df1.  Two passes over the
  // rows, so that only one of W1's row and W2's column is in registers at a
  // time and two CTAs fit an SM; f1 waits in this thread's column of df1s
  {
    const int f = tid;
    {
      float w1r[E];  // W1 row f
      load_row<E>(w1 + f * E, w1r);
      const float b1 = __ldg(bb1 + f);
      for (int r = 0; r < RB; ++r) df1s[r * F + f] = dot_row<E>(y2as + r * E, w1r) + b1;
    }
    float w2c[E];  // W2 column f
#pragma unroll
    for (int o = 0; o < E; ++o) w2c[o] = __ldg(w2 + o * F + f);
    float sum_df1 = 0.f;
    for (int r = 0; r < RB; ++r) {
      const int row = row0 + r;
      if (row >= BT) {
        df1s[r * F + f] = 0.f;
        continue;
      }
      const float f1 = df1s[r * F + f];
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
      sum_df1 += df1;
    }
    sums[4 * E + f] = sum_df1;
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
  float sum_dyy[2] = {0.f, 0.f}, sum_dy[2] = {0.f, 0.f};
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
      sum_dyy[half] = fmaf(dy[half], y[half], sum_dyy[half]);
      sum_dy[half] += dy[half];
      S.e[kDx1][o] = dx1;
      S.e[kDa][o] = da;
      das[r * E + e] = da;
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    wsum[(warp * 2) * E + lane + 32 * half] = sum_dyy[half];
    wsum[(warp * 2 + 1) * E + lane + 32 * half] = sum_dy[half];
  }
  __syncthreads();

  // this CTA's column sums, rows and warps in order: df2, dy2*y2, dy2, da
  {
    const int which = tid / E, e = tid % E;
    float acc = 0.f;
    if (which == 0 || which == 3) {
      const float* src = which == 0 ? df2s : das;
      for (int r = 0; r < RB; ++r) acc += src[r * E + e];
    } else {
      for (int w = 0; w < NW; ++w) acc += wsum[(w * 2 + which - 1) * E + e];
    }
    sums[which * E + e] = acc;
  }

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
                const float* __restrict__ v, const float* __restrict__ ctx,
                const float* __restrict__ lse, int T, float inv_scale, DropCfg drop,
                Scratch S) {
  extern __shared__ __align__(16) float smem[];
  // launched with a warp per key tile (at most NW): nt threads, nw warps
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, nw = nt >> 5;
  float* Qr = smem;                      // [T][QS]: q, dctx, lse, delta of each query
  float* dQs = Qr + T * QS;              // [T][D]: dQ, summed over the key tiles
  float* dSs = dQs + T * D + warp * WARP_FLOATS;  // [KEYS][DSS] this warp's dS of a query block
  float* Ks = dSs + KEYS * DSS;          // [KEYS][D] this warp's keys

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const DropSample ds = drop_sample(drop, b, BLOCK_TILE_MULT);
  const uint32_t key = ds.seed_base + (uint32_t)h;
  const size_t base = (size_t)b * T * E + h * D;
  const float* __restrict__ dctx = S.e[kDctx];
  const int tiles = (T + KEYS - 1) / KEYS;  // key tiles, and query blocks

  // 2a. the queries' records; delta = rowsum(dP P) = dctx . ctx
  for (int t = tid; t < T; t += nt) {
    const size_t o = base + (size_t)t * E;
    float qv[D], cv[D], xv[D];
    load8(q + o, qv);
    load8(dctx + o, cv);
    load8(ctx + o, xv);
    float* rec = Qr + t * QS;
    store8(rec, qv);
    store8(rec + D, cv);
    *reinterpret_cast<float4*>(rec + 2 * D) =
        make_float4(lse[((size_t)b * H + h) * T + t], dot8(cv, xv), 0.f, 0.f);
    const float zero[D] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    store8(dQs + t * D, zero);
  }
  __syncthreads();

  // 2b. a warp per tile of 32 keys, one key a lane.  The query blocks go
  // round: in step i warp w has block (w + i) mod tiles, so no two warps add
  // into the same rows of dQ and each row's tiles arrive in a fixed order
  for (int jt0 = 0; jt0 < tiles; jt0 += nw) {
    const int jt = jt0 + warp;
    const int j = jt * KEYS + lane;
    const bool live = jt < tiles && j < T;
    float kv[D], vv[D], dk[D], dv[D];
#pragma unroll
    for (int d = 0; d < D; ++d) kv[d] = vv[d] = dk[d] = dv[d] = 0.f;
    if (live) {
      load8(k + base + (size_t)j * E, kv);
      load8(v + base + (size_t)j * E, vv);
    }
    store8(Ks + lane * D, kv);
    for (int step = 0; step < tiles; ++step) {
      const int t0 = ((warp + step) % tiles) * KEYS;
      const int nq = T - t0 < KEYS ? T - t0 : KEYS;
      if (jt < tiles) {
        // each (query, key) pair once: P, dP, dS; dK and dV stay in registers.
        // The mask's index of (t, j) is the forward's: (local T + t) T + j, mod 2^32
        uint32_t idx = (uint32_t)(ds.local * T + t0) * (uint32_t)T + (uint32_t)j;
#pragma unroll 2
        for (int tq = 0; tq < nq; ++tq, idx += (uint32_t)T) {
          const float* rec = Qr + (t0 + tq) * QS;
          float qv[D], cv[D];
          load8(rec, qv);
          load8(rec + D, cv);
          const float4 st = *reinterpret_cast<const float4*>(rec + 2 * D);  // lse, delta
          const float p = live ? expf(dot8(qv, kv) * inv_scale - st.x) : 0.f;
          const float m = drop.on ? drop_mult(key, idx, drop.thr, drop.keep) : 1.f;
          const float pm = p * m;
          const float dsv = p * (dot8(cv, vv) * m - st.y) * inv_scale;
#pragma unroll
          for (int d = 0; d < D; ++d) {
            dk[d] = fmaf(dsv, qv[d], dk[d]);
            dv[d] = fmaf(pm, cv[d], dv[d]);
          }
          dSs[tq * DSS + lane] = dsv;
        }
        __syncwarp();
        // dQ of the block's queries, one query a lane: dS K over this tile's keys
        if (lane < nq) {
          float dq[D];
          load8(dQs + (t0 + lane) * D, dq);
#pragma unroll 8
          for (int jj = 0; jj < KEYS; ++jj) {
            const float dsv = dSs[lane * DSS + jj];
            float kk[D];
            load8(Ks + jj * D, kk);
#pragma unroll
            for (int d = 0; d < D; ++d) dq[d] = fmaf(dsv, kk[d], dq[d]);
          }
          store8(dQs + (t0 + lane) * D, dq);
        }
      }
      __syncthreads();  // the next step's owner of these dQ rows sees them
    }
    if (live) {
      store8(S.e[kDk] + base + (size_t)j * E, dk);
      store8(S.e[kDv] + base + (size_t)j * E, dv);
    }
  }

  // 2c. dQ out
  for (int i = tid; i < 2 * T; i += nt) {
    const int t = i >> 1, d0 = (i & 1) * 4;
    *reinterpret_cast<float4*>(S.e[kDq] + base + (size_t)t * E + d0) =
        *reinterpret_cast<const float4*>(dQs + t * D + d0);
  }
}

// ---- 3. QKV and LN1 backward ---------------------------------------------------
__global__ void __launch_bounds__(NT)
qkv_bwd_kernel(const float* __restrict__ x, BlockParams P, int BT,
               float* __restrict__ dx, Scratch S) {
  extern __shared__ __align__(16) float smem[];
  float* dqkv = smem;             // [3][RB][E]
  float* part = dqkv + 3 * RB * E;  // [3][RB][E]
  float* wsum = part + 3 * RB * E;  // [NW][2][E] each warp's sums of dy1*y1 and dy1
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * RB;
  float* sums = S.sums_qkv + (size_t)blockIdx.x * QKV_SUMS;
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
    const float* W = m == 0 ? P.p[2] : (m == 1 ? P.p[3] : P.p[4]);  // no indexed copy of P
    float wc[E];
#pragma unroll
    for (int o = 0; o < E; ++o) wc[o] = __ldg(W + o * E + e);
    for (int r = 0; r < RB; ++r)
      part[(m * RB + r) * E + e] = dot_row<E>(dqkv + (m * RB + r) * E, wc);
  }
  __syncthreads();

  // LN1 recomputed from x, its backward and dx, a warp per row
  float sum_dyy[2] = {0.f, 0.f}, sum_dy[2] = {0.f, 0.f};
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
      sum_dyy[half] = fmaf(dy[half], y[half], sum_dyy[half]);
      sum_dy[half] += dy[half];
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    wsum[(warp * 2) * E + lane + 32 * half] = sum_dyy[half];
    wsum[(warp * 2 + 1) * E + lane + 32 * half] = sum_dy[half];
  }
  __syncthreads();

  // this CTA's column sums, rows and warps in order: dq, dk, dv, dy1*y1, dy1
  for (int i = tid; i < QKV_SUMS; i += NT) {
    const int which = i / E, e = i % E;
    float acc = 0.f;
    if (which < 3)
      for (int r = 0; r < RB; ++r) acc += dqkv[(which * RB + r) * E + e];
    else
      for (int w = 0; w < NW; ++w) acc += wsum[(w * 2 + which - 3) * E + e];
    sums[i] = acc;
  }
}

// ---- the bf16 mode: launches 1-4 on the tensor cores -----------------------------
// Every product is mma.sync bf16 with f32 sums: operands rounded to bf16 where
// they are staged (as bf16 rows in shared memory, read by ldmatrix) or made
// (packed from the f32 accumulators of the product before).  The row kernels'
// CTAs stay on their SMs with the weights staged once as bf16 and walk the
// tiles of RB rows; each tile writes its column sums where the f32 kernels'
// CTA of the same rows would.
using rowtile::bf16_t;
using rowtile::ldsm4;
using rowtile::mma_tile_smem;
using rowtile::pack_bf16;
constexpr int LDE = E + rowtile::BPAD;      // a bf16 row of E values in shared memory
constexpr int LDF = F + rowtile::BPAD;      // of F
constexpr int LD3 = 3 * E + rowtile::BPAD;  // of dq | dk | dv
constexpr int LDY = E + 4;                  // an f32 row of E (dy2, dy1)
constexpr int RPW = RB / NW;                // rows a warp in the LayerNorm phases
constexpr int FFN_BF16_CTAS_PER_SM = 2;
constexpr int QKV_BF16_CTAS_PER_SM = 3;
// ffn_bwd_bf16_kernel: W1, W2, Wo; LN2's output and df2, then dy2 over them;
// df1, then da over it; each warp's column sums
constexpr int FFN_BF16_SMEM_BYTES =
    2 * (F * LDE + E * LDF + E * LDE + 2 * RB * LDE + RB * LDF) + 4 * NW * 4 * E;
// qkv_bwd_bf16_kernel: Wq, Wk, Wv; dq | dk | dv; dy1; each warp's column sums
constexpr int QKV_BF16_SMEM_BYTES = 2 * (3 * E * LDE + RB * LD3) + 4 * (RB * LDY + NW * 2 * E);
static_assert(RB * LDY * 4 <= 2 * RB * LDE * 2 && RB * LDE <= RB * LDF && RB % NW == 0,
              "dy2 fits over LN2's output and df2, da over df1");
constexpr int SM_SMEM_BYTES = 228 * 1024;  // one H100 SM's; a CTA also reserves 1 KB
static_assert(2 * (FFN_BF16_SMEM_BYTES + 1024) <= SM_SMEM_BYTES &&
                  QKV_BF16_CTAS_PER_SM * (QKV_BF16_SMEM_BYTES + 1024) <= SM_SMEM_BYTES,
              "the bf16 row kernels' CTAs an SM");

// LN2's normalised row `row` of x1 (before the affine; zeros past BT), a warp
// a row: y at columns lane and lane + 32; returns 1/sigma
__device__ __forceinline__ float ln_normalise(const float* __restrict__ x1, int row, int BT,
                                              int lane, float (&y)[2]) {
  float a[2] = {0.f, 0.f};
  if (row < BT) {
    a[0] = x1[(size_t)row * E + lane];
    a[1] = x1[(size_t)row * E + lane + 32];
  }
  const float mean = warp_sum(a[0] + a[1]) * (1.0f / E);
  const float d0 = a[0] - mean, d1 = a[1] - mean;
  const float var = warp_sum(d0 * d0 + d1 * d1) * (1.0f / E);
  const float inv = rsqrtf(var + 1e-5f);
  y[0] = d0 * inv;
  y[1] = d1 * inv;
  return inv;
}

// 1'. FFN, LN2 and out-projection backward of tiles of RB rows.  A: LN2 and
// df2 a warp a row (the row's normalised values and 1/sigma stay in the
// warp's registers); B: each warp all RB rows x 32 hidden units of f1 = y2a
// W1^T + b1 and dgl = df2 W2 side by side, 16 x 16 at a time (few registers
// beside A's), then df1 and gld where they lie;
// C: dy2 = df1 W1; D: LN2's backward, dx1 and da as in A; E: the tile's
// column sums and dctx = da Wo.
__global__ void __launch_bounds__(NT, FFN_BF16_CTAS_PER_SM)
ffn_bwd_bf16_kernel(const bf16* __restrict__ g, const float* __restrict__ x1, BlockParams P,
                    int T, int BT, DropCfg drop, Scratch S) {
  extern __shared__ __align__(16) float smem[];
  bf16_t* W1b = reinterpret_cast<bf16_t*>(smem);  // [F][LDE]
  bf16_t* W2b = W1b + F * LDE;                    // [E][LDF]
  bf16_t* Wob = W2b + E * LDF;                    // [E][LDE]
  bf16_t* y2b = Wob + E * LDE;                    // [RB][LDE] LN2's output
  bf16_t* df2b = y2b + RB * LDE;                  // [RB][LDE]
  float* dy2s = reinterpret_cast<float*>(y2b);    // [RB][LDY] dy2, once f1 and dgl are made
  bf16_t* df1b = df2b + RB * LDE;                 // [RB][LDF]
  bf16_t* dab = df1b;                             // [RB][LDE] da, once dy2 is made
  float* wsum = reinterpret_cast<float*>(df1b + RB * LDF);  // [NW][4][E]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int tiles = (BT + RB - 1) / RB;
  const float *g2 = P.p[10], *be2 = P.p[11], *bb1 = P.p[13];

  rowtile::stage_bf16<E, LDE>(W1b, P.p[12], F, tid, NT);
  rowtile::stage_bf16<F, LDF>(W2b, P.p[14], E, tid, NT);
  rowtile::stage_bf16<E, LDE>(Wob, P.p[8], E, tid, NT);

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * RB;
    float* sums = S.sums_ffn + (size_t)tile * FFN_SUMS;

    // A. LN2 of x1 and df2 = g m2, rows warp + NW i; the normalised rows and
    // 1/sigma stay in registers for D
    float y[RPW][2], inv[RPW], s_df2[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + NW * i, row = row0 + r;
      const bool live = row < BT;
      inv[i] = ln_normalise(x1, row, BT, lane, y[i]);
      const RowDrop rd = drop.on && live ? row_drop(drop, row, T) : RowDrop{0u, 0u};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int e = lane + 32 * hf;
        const size_t o = (size_t)row * E + e;
        const float ya = y[i][hf] * __ldg(g2 + e) + __ldg(be2 + e);
        float df2 = live ? to_f32(g[o]) : 0.f;
        if (drop.on && live)
          df2 *= drop_mult(rd.seed_base + (uint32_t)(H + 2), rd.row * E + e, drop.thr, drop.keep);
        if (live) {
          S.e[kY2a][o] = round_bf16(ya);
          S.e[kDf2][o] = round_bf16(df2);
          s_df2[hf] += df2;  // the bias gradient sums it unrounded
        }
        y2b[r * LDE + e] = __float2bfloat16_rn(live ? ya : 0.f);
        df2b[r * LDE + e] = __float2bfloat16_rn(df2);
      }
    }
    __syncthreads();

    // B. f1 and dgl for all RB rows x hidden units f0 .. f0 + 31, 16 x 16 at a time
#pragma unroll 1
    for (int c0 = 32 * warp; c0 < 32 * warp + 32; c0 += 16) {
      float colsum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 1
      for (int r0 = 0; r0 < RB; r0 += 16) {
        float f1[1][2][4], dg[1][2][4];
        rowtile::zero(f1);
        rowtile::zero(dg);
        mma_tile_smem<1, 2, E, LDE, LDE, false>(y2b + r0 * LDE, W1b + c0 * LDE, f1, lane);
        mma_tile_smem<1, 2, E, LDE, LDF, true>(df2b + r0 * LDE, W2b + c0, dg, lane);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = r0 + g8 + 8 * hh, row = row0 + r;
          const RowDrop rd = drop.on && row < BT ? row_drop(drop, row, T) : RowDrop{0u, 0u};
#pragma unroll
          for (int ni = 0; ni < 2; ++ni) {
            const int f = c0 + 8 * ni + 2 * t4;
            const float2 b1 = __ldg(reinterpret_cast<const float2*>(bb1 + f));
            float gld[2], df1[2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float x = f1[0][ni][2 * hh + c] + (c ? b1.y : b1.x);
              const float m1 = drop.on && row < BT
                                   ? drop_mult(rd.seed_base + (uint32_t)(H + 1),
                                               rd.row * F + (uint32_t)(f + c), drop.thr_ffn,
                                               drop.keep_ffn)
                                   : 1.f;
              gld[c] = gelu(x) * m1;
              df1[c] = dg[0][ni][2 * hh + c] * m1 * gelu_grad(x);
            }
            if (row < BT) {
              const size_t o = (size_t)row * F + f;
              *reinterpret_cast<float2*>(S.gld + o) = make_float2(round_bf16(gld[0]),
                                                                  round_bf16(gld[1]));
              *reinterpret_cast<float2*>(S.df1 + o) = make_float2(round_bf16(df1[0]),
                                                                  round_bf16(df1[1]));
              colsum[ni][0] += df1[0];
              colsum[ni][1] += df1[1];
            }
            *reinterpret_cast<uint32_t*>(df1b + r * LDF + f) = pack_bf16(df1[0], df1[1]);
          }
        }
      }
      // the tile's sums of df1: the lane's rows, then the 8 lanes of each column
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float v = colsum[ni][c];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (g8 == 0) sums[4 * E + c0 + 8 * ni + 2 * t4 + c] = v;
        }
    }
    __syncthreads();

    // C. dy2 = df1 W1 (W1 [f][e]: k = f), a warp 16 rows x 16 columns
    const int pr0 = 16 * (warp >> 2), pc0 = 16 * (warp & 3);
    {
      float acc[1][2][4];
      rowtile::zero(acc);
      mma_tile_smem<1, 2, F, LDF, LDE, true>(df1b + pr0 * LDF, W1b + pc0, acc, lane);
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(dy2s + (pr0 + g8 + 8 * hh) * LDY + pc0 + 8 * ni + 2 * t4) =
              make_float2(acc[0][ni][2 * hh], acc[0][ni][2 * hh + 1]);
    }
    __syncthreads();

    // D. LN2 backward, dx1 and da = dx1 m_a, the rows of A
    float s_dyy[2] = {0.f, 0.f}, s_dy[2] = {0.f, 0.f}, s_da[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + NW * i, row = row0 + r;
      float dy[2], gh[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        dy[hf] = dy2s[r * LDY + lane + 32 * hf];
        gh[hf] = dy[hf] * __ldg(g2 + lane + 32 * hf);
      }
      const float mean_gh = warp_sum(gh[0] + gh[1]) * (1.0f / E);
      const float mean_ghy = warp_sum(gh[0] * y[i][0] + gh[1] * y[i][1]) * (1.0f / E);
      const RowDrop rd = drop.on && row < BT ? row_drop(drop, row, T) : RowDrop{0u, 0u};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int e = lane + 32 * hf;
        const size_t o = (size_t)row * E + e;
        float da = 0.f;
        if (row < BT) {
          const float dx1 = to_f32(g[o]) + (gh[hf] - mean_gh - y[i][hf] * mean_ghy) * inv[i];
          da = drop.on ? dx1 * drop_mult(rd.seed_base + (uint32_t)H, rd.row * E + e, drop.thr,
                                         drop.keep)
                       : dx1;
          S.e[kDx1][o] = dx1;
          S.e[kDa][o] = round_bf16(da);
          s_dyy[hf] = fmaf(dy[hf], y[i][hf], s_dyy[hf]);
          s_dy[hf] += dy[hf];
          s_da[hf] += da;  // the bias gradient sums it unrounded
        }
        dab[r * LDE + e] = __float2bfloat16_rn(da);
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float* w = wsum + warp * 4 * E + lane + 32 * hf;
      w[0] = s_df2[hf];
      w[E] = s_dyy[hf];
      w[2 * E] = s_dy[hf];
      w[3 * E] = s_da[hf];
    }
    __syncthreads();

    // E. the tile's column sums, warps in order: df2, dy2*y2, dy2, da
    {
      const int which = tid / E, e = tid % E;
      float acc = 0.f;
      for (int w = 0; w < NW; ++w) acc += wsum[(w * 4 + which) * E + e];
      sums[which * E + e] = acc;
    }
    // dctx = da Wo (Wo [o][i]: k = o), rounded: an operand only (of dP and dV)
    {
      float acc[1][2][4];
      rowtile::zero(acc);
      mma_tile_smem<1, 2, E, LDE, LDE, true>(dab + pr0 * LDE, Wob + pc0, acc, lane);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row0 + pr0 + g8 + 8 * hh;
        if (row >= BT) continue;
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
          *reinterpret_cast<float2*>(S.e[kDctx] + (size_t)row * E + pc0 + 8 * ni + 2 * t4) =
              make_float2(round_bf16(acc[0][ni][2 * hh]), round_bf16(acc[0][ni][2 * hh + 1]));
      }
    }
    // the next tile's A and B write only what this tile's C and D have read
  }
}

// 2'. attention backward, one CTA per (sample, head).  A warp owns BK = 32
// keys (two m16 tiles), with k and v as the A operand of S^T = K Q^T and dP^T
// = V dctx^T (m16n8k8, k = the head's 8 columns) and dK, dV in registers,
// and walks the query blocks of 32 in rotation as attn_bwd_kernel does (block
// (warp + step) mod blocks, a barrier a step: each dQ row has one writer at a
// time and its key tiles arrive in a fixed order).  Each 16 queries of a
// block: P^T and dS^T from the accumulators, rounded and packed as the A
// operand of dV += P~^T dctx and dK += dS^T Q (m16n8k16; q and dctx staged as
// bf16 rows, ldmatrix.trans), and dQ += dS K with dS^T's 8 x 8 blocks
// transposed in registers (movmatrix).  Keys past T are zero and a query past
// T has lse = +inf, so neither reaches a stored gradient.
constexpr int BK = 32;  // keys a warp, and queries a step

template <bool DROP>
__global__ void __launch_bounds__(NT)
attn_bwd_bf16_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ ctx,
                     const float* __restrict__ lse, int T, float inv_scale, DropCfg drop,
                     Scratch S) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, nw = nt >> 5, g8 = lane >> 2, t4 = lane & 3;
  const int tiles = (T + BK - 1) / BK, Tp = tiles * BK;  // key tiles, and query blocks
  float* dQs = smem;                                         // [Tp][D] dQ
  float2* st = reinterpret_cast<float2*>(dQs + Tp * D);      // [Tp] (lse log2(e), delta)
  bf16_t* Qb = reinterpret_cast<bf16_t*>(st + Tp);           // [Tp][D] q
  bf16_t* Cb = Qb + Tp * D;                                  // [Tp][D] dctx
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const DropSample ds = drop_sample(drop, b, BLOCK_TILE_MULT);
  const uint32_t key = ds.seed_base + (uint32_t)h;
  const size_t base = (size_t)b * T * E + h * D;
  const float* __restrict__ dctx = S.e[kDctx];
  constexpr float LOG2E = 1.4426950408889634f;
  const float c2 = inv_scale * LOG2E;  // P = 2^(s c2 - lse log2(e))

  // the queries: q and dctx as bf16 rows; lse and delta = rowsum(dP P) = dctx . ctx
  for (int t = tid; t < Tp; t += nt) {
    float qv[D], cv[D], xv[D];
#pragma unroll
    for (int d = 0; d < D; ++d) qv[d] = cv[d] = xv[d] = 0.f;
    float2 rec = make_float2(INFINITY, 0.f);
    if (t < T) {
      const size_t o = base + (size_t)t * E;
      load8(q + o, qv);
      load8(dctx + o, cv);
      load8(ctx + o, xv);
      rec = make_float2(lse[((size_t)b * H + h) * T + t] * LOG2E, dot8(cv, xv));
    }
    rowtile::store_bf16x8(Qb + t * D, qv);
    rowtile::store_bf16x8(Cb + t * D, cv);
    st[t] = rec;
    const float zero[D] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    store8(dQs + t * D, zero);
  }
  __syncthreads();

  for (int kt0 = 0; kt0 < tiles; kt0 += nw) {
    const int j0 = (kt0 + warp) * BK;
    const bool own = kt0 + warp < tiles;
    // k and v as A fragments (key rows g, g + 8 of each m16 tile); k as the B
    // fragments of dQ = dS K (keys 2 t, 2 t + 1, + 8 at column g)
    uint32_t ka[2][2], va[2][2], kb[2][2];
    float dk[2][4], dv[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int j = j0 + 16 * mt + g8 + 8 * hh, jb = j0 + 16 * mt + 2 * t4 + 8 * hh;
        float2 kk = make_float2(0.f, 0.f), vv = kk;
        if (own && j < T) {
          kk = *reinterpret_cast<const float2*>(k + base + (size_t)j * E + 2 * t4);
          vv = *reinterpret_cast<const float2*>(v + base + (size_t)j * E + 2 * t4);
        }
        ka[mt][hh] = pack_bf16(kk.x, kk.y);
        va[mt][hh] = pack_bf16(vv.x, vv.y);
        kb[mt][hh] = pack_bf16(own && jb < T ? k[base + (size_t)jb * E + g8] : 0.f,
                               own && jb + 1 < T ? k[base + (size_t)(jb + 1) * E + g8] : 0.f);
        dk[mt][2 * hh] = dk[mt][2 * hh + 1] = dv[mt][2 * hh] = dv[mt][2 * hh + 1] = 0.f;
      }
    for (int step = 0; step < tiles; ++step) {
      if (own) {
        const int qb0 = ((warp + step) % tiles) * BK;
#pragma unroll 1
        for (int t0 = qb0; t0 < qb0 + BK; t0 += 16) {
          // q and dctx of queries t0 .. t0 + 15: bs as the B operand of S^T and
          // dP^T (bs[nb], bs[2 + nb]: 8 queries each), bt transposed as that of
          // dK and dV (bt[0..1]: q, bt[2..3]: dctx)
          uint32_t bs[4], bt[4];
          const bf16_t* rows = (lane < 16 ? Qb : Cb) + (t0 + (lane & 15)) * D;
          ldsm4<false>(bs, rows);
          ldsm4<true>(bt, rows);
          uint32_t pa[2][4], da[2][4];  // P~^T and dS^T as A fragments, k = the 16 queries
#pragma unroll
          for (int nb = 0; nb < 2; ++nb) {
            const int tq = t0 + 8 * nb + 2 * t4;  // this lane's queries tq, tq + 1
            const float4 rec = *reinterpret_cast<const float4*>(st + tq);
            // the mask's index of (t, j) is the forward's: (local T + t) T + j, mod 2^32
            const uint32_t qi = (uint32_t)(ds.local * T + tq) * (uint32_t)T;
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
              rowtile::mma_bf16_k8(s, ka[mt], bs[nb]);
              rowtile::mma_bf16_k8(dp, va[mt], bs[2 + nb]);
              float pm[4], dsv[4];
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                const float l2 = c & 1 ? rec.z : rec.x, delta = c & 1 ? rec.w : rec.y;
                const float p = exp2_sfu(fmaf(s[c], c2, -l2));
                float m = 1.f;
                if (DROP)
                  m = drop_mult(key,
                                qi + (c & 1) * (uint32_t)T + (uint32_t)(j0 + 16 * mt + g8 +
                                                                         8 * (c >> 1)),
                                drop.thr, drop.keep);
                pm[c] = p * m;
                dsv[c] = p * (dp[c] * m - delta) * inv_scale;
              }
              pa[mt][2 * nb] = pack_bf16(pm[0], pm[1]);
              pa[mt][2 * nb + 1] = pack_bf16(pm[2], pm[3]);
              da[mt][2 * nb] = pack_bf16(dsv[0], dsv[1]);
              da[mt][2 * nb + 1] = pack_bf16(dsv[2], dsv[3]);
            }
          }
          const uint32_t bq[2] = {bt[0], bt[1]}, bc[2] = {bt[2], bt[3]};
          float* dq = dQs + (t0 + g8) * D + 2 * t4;  // rows g, g + 8 of the 16 queries
          const float2 dq0 = *reinterpret_cast<const float2*>(dq);
          const float2 dq1 = *reinterpret_cast<const float2*>(dq + 8 * D);
          float acc[4] = {dq0.x, dq0.y, dq1.x, dq1.y};
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            rowtile::mma_bf16(dv[mt], pa[mt], bc);
            rowtile::mma_bf16(dk[mt], da[mt], bq);
            // dS (queries x keys of tile mt): dS^T's blocks (keys 0-7 | 8-15) x
            // (queries 0-7 | 8-15), each transposed
            const uint32_t af[4] = {rowtile::movm_trans(da[mt][0]), rowtile::movm_trans(da[mt][2]),
                                    rowtile::movm_trans(da[mt][1]), rowtile::movm_trans(da[mt][3])};
            rowtile::mma_bf16(acc, af, kb[mt]);
          }
          *reinterpret_cast<float2*>(dq) = make_float2(acc[0], acc[1]);
          *reinterpret_cast<float2*>(dq + 8 * D) = make_float2(acc[2], acc[3]);
        }
      }
      __syncthreads();  // the next step's owner of these dQ rows sees them
    }
    if (own) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int j = j0 + 16 * mt + g8 + 8 * hh;
          if (j >= T) continue;
          const size_t o = base + (size_t)j * E + 2 * t4;
          *reinterpret_cast<float2*>(S.e[kDk] + o) = make_float2(dk[mt][2 * hh], dk[mt][2 * hh + 1]);
          *reinterpret_cast<float2*>(S.e[kDv] + o) = make_float2(dv[mt][2 * hh], dv[mt][2 * hh + 1]);
        }
    }
  }

  for (int i = tid; i < 2 * T; i += nt) {
    const int t = i >> 1, d0 = (i & 1) * 4;
    *reinterpret_cast<float4*>(S.e[kDq] + base + (size_t)t * E + d0) =
        *reinterpret_cast<const float4*>(dQs + t * D + d0);
  }
}

// 3'. QKV and LN1 backward of tiles of RB rows: dq, dk and dv summed
// unrounded (the bias gradients), staged as bf16 and rounded in place (the
// operands of dWq, dWk, dWv); dy1 = [dq | dk | dv] [Wq; Wk; Wv] as one
// product over 3E; then LN1 recomputed from x, its backward and dx.
__global__ void __launch_bounds__(NT, QKV_BF16_CTAS_PER_SM)
qkv_bwd_bf16_kernel(const bf16* __restrict__ x, BlockParams P, int BT, bf16* __restrict__ dx,
                    Scratch S) {
  extern __shared__ __align__(16) float smem[];
  bf16_t* Wb = reinterpret_cast<bf16_t*>(smem);           // [3E][LDE]: Wq, Wk, Wv [o][e]
  bf16_t* Ab = Wb + 3 * E * LDE;                          // [RB][LD3] dq | dk | dv
  float* dy1s = reinterpret_cast<float*>(Ab + RB * LD3);  // [RB][LDY]
  float* wsum = dy1s + RB * LDY;                          // [NW][2][E]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int tiles = (BT + RB - 1) / RB;
  const float *g1 = P.p[0], *be1 = P.p[1];
#pragma unroll
  for (int m = 0; m < 3; ++m) rowtile::stage_bf16<E, LDE>(Wb + m * E * LDE, P.p[2 + m], E, tid, NT);

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * RB;
    float* sums = S.sums_qkv + (size_t)tile * QKV_SUMS;
    // a thread a column of dq | dk | dv, 16 loads in flight at a time, rows in order
    if (tid < 3 * E) {
      float* src = S.e[kDq + tid / E] + (size_t)row0 * E + tid % E;
      float acc = 0.f;
#pragma unroll
      for (int r0 = 0; r0 < RB; r0 += 16) {
        float val[16];
#pragma unroll
        for (int r = 0; r < 16; ++r) val[r] = row0 + r0 + r < BT ? src[(r0 + r) * E] : 0.f;
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          if (row0 + r0 + r < BT) src[(r0 + r) * E] = round_bf16(val[r]);
          acc += val[r];
          Ab[(r0 + r) * LD3 + tid] = __float2bfloat16_rn(val[r]);
        }
      }
      sums[tid] = acc;
    }
    __syncthreads();

    // dy1, a warp 16 rows x 16 columns
    {
      const int pr0 = 16 * (warp >> 2), pc0 = 16 * (warp & 3);
      float acc[1][2][4];
      rowtile::zero(acc);
      mma_tile_smem<1, 2, 3 * E, LD3, LDE, true>(Ab + pr0 * LD3, Wb + pc0, acc, lane);
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(dy1s + (pr0 + g8 + 8 * hh) * LDY + pc0 + 8 * ni + 2 * t4) =
              make_float2(acc[0][ni][2 * hh], acc[0][ni][2 * hh + 1]);
    }
    __syncthreads();

    // LN1 recomputed from x, its backward and dx, a warp a row
    float s_dyy[2] = {0.f, 0.f}, s_dy[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + NW * i, row = row0 + r;
      if (row >= BT) continue;
      const bf16* xr = x + (size_t)row * E;
      const float a0 = to_f32(xr[lane]), a1 = to_f32(xr[lane + 32]);
      const float mean = warp_sum(a0 + a1) * (1.0f / E);
      const float d0 = a0 - mean, d1 = a1 - mean;
      const float var = warp_sum(d0 * d0 + d1 * d1) * (1.0f / E);
      const float inv = rsqrtf(var + 1e-5f);
      float dy[2], yv[2], gh[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        dy[hf] = dy1s[r * LDY + lane + 32 * hf];
        yv[hf] = (hf ? d1 : d0) * inv;
        gh[hf] = dy[hf] * __ldg(g1 + lane + 32 * hf);
      }
      const float mean_gh = warp_sum(gh[0] + gh[1]) * (1.0f / E);
      const float mean_ghy = warp_sum(gh[0] * yv[0] + gh[1] * yv[1]) * (1.0f / E);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int e = lane + 32 * hf;
        const size_t o = (size_t)row * E + e;
        store_as(dx + o, S.e[kDx1][o] + (gh[hf] - mean_gh - yv[hf] * mean_ghy) * inv);
        S.e[kY1a][o] = round_bf16(yv[hf] * __ldg(g1 + e) + __ldg(be1 + e));
        s_dyy[hf] = fmaf(dy[hf], yv[hf], s_dyy[hf]);
        s_dy[hf] += dy[hf];
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      wsum[(warp * 2) * E + lane + 32 * hf] = s_dyy[hf];
      wsum[(warp * 2 + 1) * E + lane + 32 * hf] = s_dy[hf];
    }
    __syncthreads();
    if (tid < 2 * E) {  // dy1*y1, dy1: warps in order
      const int which = tid / E, e = tid % E;
      float acc = 0.f;
      for (int w = 0; w < NW; ++w) acc += wsum[(w * 2 + which) * E + e];
      sums[(3 + which) * E + e] = acc;
    }
  }
}

// 4'. The bf16 mode's weight gradients: wgrad.cuh's products, chunks and
// partials (its sums kernel adds them), on the tensor cores.  The operands
// are bf16 values in f32 rows (the row kernels and the forward rounded them),
// so a CTA stages its 64-wide slices of A and B as wgrad's ring does (16-byte
// cp.async, STAGES stages of KT rows), in rows padded by 4 floats, and each
// warp packs its fragments from them: its 16 x 32 of C = A^T B, k16 steps of
// mma.sync m16n8k16 (the A operand's rows are A's columns).  One CTA's sum
// over its KC rows is one accumulator a lane: nothing to add across warps.
constexpr int WLD = wgrad::TILE + 4;  // a staged row: the fragment loads hit 32 banks
constexpr int W_SMEM_BYTES = wgrad::STAGES * 2 * wgrad::KT * WLD * 4;
static_assert(NT == wgrad::NT && (wgrad::TILE / 16) * (wgrad::TILE / 32) == NW,
              "the copy roles of wgrad's ring; a warp 16 x 32 of the tile");

__global__ void __launch_bounds__(NT, 2)
products_bf16_kernel(const __grid_constant__ wgrad::Jobs jobs) {
  using wgrad::KT;
  using wgrad::STAGES;
  using wgrad::TILE;
  extern __shared__ __align__(16) float smem[];
  int ji = 0;
  while (ji + 1 < jobs.count && (int)blockIdx.x >= jobs.j[ji + 1].cta0) ++ji;
  const wgrad::Job& J = jobs.j[ji];
  const int tiles_n = (J.n + TILE - 1) / TILE, tiles = tiles_n * ((J.m + TILE - 1) / TILE);
  const int local = blockIdx.x - J.cta0, tile = local % tiles, chunk = local / tiles;
  const int k0 = chunk * wgrad::KC;
  const int k1 = k0 + wgrad::KC < J.k ? k0 + wgrad::KC : J.k;
  const int m0 = (tile / tiles_n) * TILE, n0 = (tile % tiles_n) * TILE;
  float* As = smem;                       // [STAGES][KT][WLD]
  float* Bs = As + STAGES * KT * WLD;     // [STAGES][KT][WLD]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  // copy role: float4 column c4 of the stage's rows lr and lr + 16
  const int c4 = (tid % 16) * 4, lr = tid / 16;
  const bool a_in = m0 + c4 < J.m, b_in = n0 + c4 < J.n;
  auto load_stage = [&](int st) {
    float* as = As + (st % STAGES) * KT * WLD;
    float* bs = Bs + (st % STAGES) * KT * WLD;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = lr + 16 * half, k = k0 + st * KT + r;
      const bool in = k < k1;
      cp_async16(as + r * WLD + c4, in && a_in ? wgrad::row_ptr(J.a, k) + m0 + c4 : J.a.p,
                 in && a_in);
      cp_async16(bs + r * WLD + c4, in && b_in ? wgrad::row_ptr(J.b, k) + n0 + c4 : J.b.p,
                 in && b_in);
    }
  };

  const int wm0 = 16 * (warp >> 1), wn0 = 32 * (warp & 1);  // the warp's rows and columns of C
  float acc[4][4];
#pragma unroll
  for (int nb = 0; nb < 4; ++nb)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nb][c] = 0.f;
  const int nst = (k1 - k0 + KT - 1) / KT;
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nst) load_stage(st);
    cp_async_commit();
  }
  for (int it = 0; it < nst; ++it) {
    cp_async_wait<STAGES - 2>();  // stage `it` has landed (this thread's copies)
    __syncthreads();              // everyone's; and stage it-1 is read by no one now
    if (it + STAGES - 1 < nst) load_stage(it + STAGES - 1);
    cp_async_commit();
    const float* as = As + (it % STAGES) * KT * WLD + wm0 + g8;
    const float* bs = Bs + (it % STAGES) * KT * WLD + wn0 + g8;
#pragma unroll
    for (int kk = 0; kk < KT; kk += 16) {
      // A^T at rows g, g + 8 and k = 2 t, 2 t + 1, + 8: A's rows k at column g
      const float* ap = as + (kk + 2 * t4) * WLD;
      const uint32_t a[4] = {pack_bf16(ap[0], ap[WLD]), pack_bf16(ap[8], ap[WLD + 8]),
                             pack_bf16(ap[8 * WLD], ap[9 * WLD]),
                             pack_bf16(ap[8 * WLD + 8], ap[9 * WLD + 8])};
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const float* bp = bs + (kk + 2 * t4) * WLD + 8 * nb;
        const uint32_t b[2] = {pack_bf16(bp[0], bp[WLD]), pack_bf16(bp[8 * WLD], bp[9 * WLD])};
        rowtile::mma_bf16(acc[nb], a, b);
      }
    }
  }
  cp_async_wait<0>();

  float* out = J.partial + (size_t)chunk * J.m * J.n;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int m = m0 + wm0 + g8 + 8 * hh;
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const int n = n0 + wn0 + 8 * nb + 2 * t4;
      if (m < J.m && n < J.n)
        *reinterpret_cast<float2*>(out + (size_t)m * J.n + n) =
            make_float2(acc[nb][2 * hh], acc[nb][2 * hh + 1]);
    }
  }
}

// a warp per key tile, so that no warp of a CTA idles (6 at T=192), up to NW
int attn_threads(int T) {
  const int tiles = (T + KEYS - 1) / KEYS;
  return 32 * (tiles < NW ? tiles : NW);
}
size_t attn_smem_floats(int T) {
  return (size_t)T * QS + (size_t)T * D + (size_t)(attn_threads(T) / 32) * WARP_FLOATS;
}

constexpr size_t kFfnSmemFloats = 4 * RB * E + RB * F + 4 * RB * E + RB + NW * 2 * E;
constexpr size_t kQkvSmemFloats = 6 * RB * E + NW * 2 * E;

// floats of the products' partial sums: dW2, dW1 and the four E x E gradients
size_t product_floats(int BT) {
  return 2 * wgrad::workspace(E, F, BT) + 4 * wgrad::workspace(E, E, BT);
}

cudaError_t set_smem(const void* fn, size_t floats, int optin) {
  const size_t bytes = floats * sizeof(float);
  if (bytes > (size_t)optin) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The three row and attention launches of the f32 mode, with their
// shared-memory limits set first.
cudaError_t launch_rows(const float* x, const float* g, float* dx, const float* q,
                        const float* k, const float* v, const float* ctx, const float* x1,
                        const float* lse, const BlockParams& P, int B, int T, float inv_scale,
                        const DropCfg& drop, const Scratch& S, cudaStream_t st) {
  const int BT = B * T, row_ctas = (BT + RB - 1) / RB;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if ((err = set_smem((const void*)ffn_bwd_kernel, kFfnSmemFloats, optin)) != cudaSuccess ||
      (err = set_smem((const void*)attn_bwd_kernel, attn_smem_floats(T), optin)) !=
          cudaSuccess ||
      (err = set_smem((const void*)qkv_bwd_kernel, kQkvSmemFloats, optin)) != cudaSuccess)
    return err;

  ffn_bwd_kernel<<<row_ctas, NT, kFfnSmemFloats * sizeof(float), st>>>(g, x1, P, T, BT, drop,
                                                                       S);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  attn_bwd_kernel<<<B * H, attn_threads(T), attn_smem_floats(T) * sizeof(float), st>>>(
      q, k, v, ctx, lse, T, inv_scale, drop, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  qkv_bwd_kernel<<<row_ctas, NT, kQkvSmemFloats * sizeof(float), st>>>(x, P, BT, dx, S);
  return cudaGetLastError();
}

// bytes of attn_bwd_bf16_kernel's shared memory: dQ, (lse, delta), q and dctx
// of every query, padded to whole blocks of BK
size_t attn_bf16_smem_bytes(int T) {
  return (size_t)((T + BK - 1) / BK * BK) * (D * 4 + 8 + 2 * D * 2);
}

// The bf16 mode's three launches: the row kernels' CTAs stay on their SMs
// (`sms` of them a kernel and CTAs an SM), the attention as the f32 mode's.
// Their shared-memory limits are set once for each device.
cudaError_t launch_rows_bf16(const bf16* x, const bf16* g, bf16* dx, const float* q,
                             const float* k, const float* v, const float* ctx, const float* x1,
                             const float* lse, const BlockParams& P, int B, int T,
                             float inv_scale, const DropCfg& drop, const Scratch& S,
                             cudaStream_t st) {
  static int configured = -1, optin = 0, sms = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != configured) {
    if ((err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
            cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    if ((err = set_smem((const void*)ffn_bwd_bf16_kernel, FFN_BF16_SMEM_BYTES / 4, optin)) !=
            cudaSuccess ||
        (err = set_smem((const void*)attn_bwd_bf16_kernel<true>, optin / 4, optin)) !=
            cudaSuccess ||
        (err = set_smem((const void*)attn_bwd_bf16_kernel<false>, optin / 4, optin)) !=
            cudaSuccess ||
        (err = set_smem((const void*)qkv_bwd_bf16_kernel, QKV_BF16_SMEM_BYTES / 4, optin)) !=
            cudaSuccess ||
        (err = set_smem((const void*)products_bf16_kernel, W_SMEM_BYTES / 4, optin)) !=
            cudaSuccess)
      return err;
    configured = dev;
  }
  if (attn_bf16_smem_bytes(T) > (size_t)optin) return cudaErrorInvalidValue;
  const int tiles = (B * T + RB - 1) / RB;
  const int ffn_ctas = tiles < FFN_BF16_CTAS_PER_SM * sms ? tiles : FFN_BF16_CTAS_PER_SM * sms;
  const int qkv_ctas = tiles < QKV_BF16_CTAS_PER_SM * sms ? tiles : QKV_BF16_CTAS_PER_SM * sms;
  ffn_bwd_bf16_kernel<<<ffn_ctas, NT, FFN_BF16_SMEM_BYTES, st>>>(g, x1, P, T, B * T, drop, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (drop.on)
    attn_bwd_bf16_kernel<true><<<B * H, attn_threads(T), attn_bf16_smem_bytes(T), st>>>(
        q, k, v, ctx, lse, T, inv_scale, drop, S);
  else
    attn_bwd_bf16_kernel<false><<<B * H, attn_threads(T), attn_bf16_smem_bytes(T), st>>>(
        q, k, v, ctx, lse, T, inv_scale, drop, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  qkv_bwd_bf16_kernel<<<qkv_ctas, NT, QKV_BF16_SMEM_BYTES, st>>>(x, P, B * T, dx, S);
  return cudaGetLastError();
}

}  // namespace

// Floats of workspace tce_fused_block_bwd needs for B samples of T rows.
extern "C" long long tce_fused_block_bwd_workspace(int B, int T) {
  const size_t bt = (size_t)B * T, row_ctas = (bt + RB - 1) / RB;
  return (long long)(bt * (kNumE * E + 2 * F) + row_ctas * (FFN_SUMS + QKV_SUMS) +
                     product_floats(B * T));
}

// Launch on `stream`; returns the CUDA error code (0 on success).
//   x, g [B][T][E]; saved: [5][B][T][E] (q, k, v, ctx, x1) then [B][H][T]
//   (the softmax rows' log-sum-exp), from the training forward; params /
//   dparams: the 16 tensors of BlockParams and their gradients (written
//   whole, f32); dx [B][T][E]; ws: the workspace above.  `bf16` selects the
//   bf16 mode: x, g and dx are then bf16.  Five kernel launches.
extern "C" int tce_fused_block_bwd(const void* x, const void* g, const float* saved,
                                   const void* const* params, void* dx,
                                   void* const* dparams, float* ws, int B, int T,
                                   int e, int h, int f, float inv_scale, int drop_on,
                                   unsigned seed, int tb, unsigned thr, float keep,
                                   unsigned thr_ffn, float keep_ffn, int bf16_mode,
                                   void* stream) {
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
  const int row_ctas = (BT + RB - 1) / RB;
  const size_t plane = (size_t)BT * E;
  Scratch S;
  for (int i = 0; i < kNumE; ++i) S.e[i] = ws + i * plane;
  S.gld = ws + kNumE * plane;
  S.df1 = S.gld + (size_t)BT * F;
  S.sums_ffn = S.df1 + (size_t)BT * F;
  S.sums_qkv = S.sums_ffn + (size_t)row_ctas * FFN_SUMS;
  float* partials = S.sums_qkv + (size_t)row_ctas * QKV_SUMS;
  const float *q = saved, *k = saved + plane, *v = saved + 2 * plane,
              *ctx = saved + 3 * plane, *x1 = saved + 4 * plane, *lse = saved + 5 * plane;

  // the weight gradients, dW = (gradient of the product's output)^T (its
  // input), and the bias and LayerNorm gradients from the row kernels' sums
  using wgrad::rows;
  wgrad::Plan plan;
  const wgrad::Rows y1a = rows(S.e[kY1a], E);
  bool ok = plan.add_product(rows(S.e[kDf2], E), rows(S.gld, F), E, F, BT, dP[14], partials) &&
            plan.add_product(rows(S.df1, F), rows(S.e[kY2a], E), F, E, BT, dP[12], partials) &&
            plan.add_product(rows(S.e[kDa], E), rows(ctx, E), E, E, BT, dP[8], partials) &&
            plan.add_product(rows(S.e[kDq], E), y1a, E, E, BT, dP[2], partials) &&
            plan.add_product(rows(S.e[kDk], E), y1a, E, E, BT, dP[3], partials) &&
            plan.add_product(rows(S.e[kDv], E), y1a, E, E, BT, dP[4], partials);
  struct ColSum { const float* partial; int stride, n, out; };
  const ColSum sums[] = {
      {S.sums_ffn, FFN_SUMS, E, 15},              // dbb2 = sum df2
      {S.sums_ffn + E, FFN_SUMS, E, 10},          // dg2 = sum dy2 * y2
      {S.sums_ffn + 2 * E, FFN_SUMS, E, 11},      // dbe2 = sum dy2
      {S.sums_ffn + 3 * E, FFN_SUMS, E, 9},       // dbo = sum da
      {S.sums_ffn + 4 * E, FFN_SUMS, F, 13},      // dbb1 = sum df1
      {S.sums_qkv, QKV_SUMS, E, 5},               // dbq
      {S.sums_qkv + E, QKV_SUMS, E, 6},           // dbk
      {S.sums_qkv + 2 * E, QKV_SUMS, E, 7},       // dbv
      {S.sums_qkv + 3 * E, QKV_SUMS, E, 0},       // dg1 = sum dy1 * y1
      {S.sums_qkv + 4 * E, QKV_SUMS, E, 1},       // dbe1 = sum dy1
  };
  for (const ColSum& c : sums)
    ok = ok && plan.add_sum(c.partial, c.stride, row_ctas, c.n, dP[c.out]);
  if (!ok) return (int)cudaErrorInvalidValue;

  const cudaError_t err =
      bf16_mode ? launch_rows_bf16(static_cast<const bf16*>(x), static_cast<const bf16*>(g),
                                   static_cast<bf16*>(dx), q, k, v, ctx, x1, lse, P, B, T,
                                   inv_scale, drop, S, st)
                : launch_rows(static_cast<const float*>(x), static_cast<const float*>(g),
                              static_cast<float*>(dx), q, k, v, ctx, x1, lse, P, B, T,
                              inv_scale, drop, S, st);
  if (err != cudaSuccess) return (int)err;
  if (bf16_mode) {
    products_bf16_kernel<<<plan.ctas, NT, W_SMEM_BYTES, st>>>(plan.jobs);
    if (const cudaError_t e2 = cudaGetLastError(); e2 != cudaSuccess) return (int)e2;
  } else if (const cudaError_t e2 = plan.launch_products(st); e2 != cudaSuccess) {
    return (int)e2;
  }
  return (int)plan.launch_sums(st);
}
