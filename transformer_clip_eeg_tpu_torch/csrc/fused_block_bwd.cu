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
// instantiation saved q, k, v and the context as bf16 values) is a second
// instantiation of the three row and attention kernels on XT = bf16: g and x
// are read as bf16, dx written as bf16, the parameter gradients as f32, and
// every product's operands are rounded to bf16 where they are staged (the
// weights as they load into registers, the activations as they are written
// for the products or read from shared memory), so today's FMA path sums
// products of bf16 values, which an f32 FMA takes exactly.  What a column
// sum (a bias or LayerNorm gradient) adds stays unrounded, as in JAX.  The
// products stay off the tensor cores (a later PR's lever).

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
template <typename XT>
__global__ void __launch_bounds__(NT, 2)
ffn_bwd_kernel(const XT* __restrict__ g, const float* __restrict__ x1,
               BlockParams P, int T, int BT, DropCfg drop, Scratch S) {
  constexpr bool R = kBf16<XT>;  // round the products' operands
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
      const float ya = operand<R>(y * __ldg(g2 + e) + __ldg(be2 + e));  // an operand only
      y2s[r * E + e] = y;
      y2as[r * E + e] = ya;
      S.e[kY2a][(size_t)row * E + e] = ya;
      float d = to_f32(g[(size_t)row * E + e]);
      if (drop.on)
        d *= drop_mult(ds.seed_base + (uint32_t)(H + 2), (uint32_t)(ds.local * T + t) * E + e,
                       drop.thr, drop.keep);
      df2s[r * E + e] = operand<R>(d);  // (the bias gradient sums it unrounded, below)
      S.e[kDf2][(size_t)row * E + e] = operand<R>(d);
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
      load_row<E, R>(w1 + f * E, w1r);
      const float b1 = __ldg(bb1 + f);
      for (int r = 0; r < RB; ++r) df1s[r * F + f] = dot_row<E>(y2as + r * E, w1r) + b1;
    }
    float w2c[E];  // W2 column f
#pragma unroll
    for (int o = 0; o < E; ++o) w2c[o] = operand<R>(__ldg(w2 + o * F + f));
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
      S.gld[(size_t)row * F + f] = operand<R>(gld);
      S.df1[(size_t)row * F + f] = operand<R>(df1);
      df1s[r * F + f] = operand<R>(df1);  // an operand of dy2 only
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
    for (int i = 0; i < F / 4; ++i) w1c[i] = operand<R>(__ldg(w1 + (q * (F / 4) + i) * E + e));
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
      const float dx1 = to_f32(g[o]) + (gh[half] - mean_gh - y[half] * mean_ghy) * inv;
      float da = dx1;
      if (drop.on)
        da *= drop_mult(ds.seed_base + (uint32_t)H, (uint32_t)(ds.local * T + t) * E + e,
                        drop.thr, drop.keep);
      sum_dyy[half] = fmaf(dy[half], y[half], sum_dyy[half]);
      sum_dy[half] += dy[half];
      S.e[kDx1][o] = dx1;
      S.e[kDa][o] = operand<R>(da);
      das[r * E + e] = operand<R>(da);  // (the bias gradient sums it unrounded, below)
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    wsum[(warp * 2) * E + lane + 32 * half] = sum_dyy[half];
    wsum[(warp * 2 + 1) * E + lane + 32 * half] = sum_dy[half];
  }
  __syncthreads();

  // this CTA's column sums, rows and warps in order: df2, dy2*y2, dy2, da.  In
  // the bf16 mode df2s and das hold rounded operands, so df2 = g m2 and da =
  // dx1 m_a are formed again, unrounded, from g and dx1 (JAX sums them so)
  {
    const int which = tid / E, e = tid % E;
    float acc = 0.f;
    if (R && (which == 0 || which == 3)) {
      for (int r = 0; r < RB && row0 + r < BT; ++r) {
        const int row = row0 + r, b = row / T, t = row % T;
        const size_t o = (size_t)row * E + e;
        float v = which == 0 ? to_f32(g[o]) : S.e[kDx1][o];
        if (drop.on) {
          const DropSample ds = drop_sample(drop, b, BLOCK_TILE_MULT);
          v *= drop_mult(ds.seed_base + (uint32_t)(which == 0 ? H + 2 : H),
                         (uint32_t)(ds.local * T + t) * E + e, drop.thr, drop.keep);
        }
        acc += v;
      }
    } else if (which == 0 || which == 3) {
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
    for (int o = 0; o < E; ++o) woc[o] = operand<R>(__ldg(wo + o * E + i));
    for (int r = rg; r < RB; r += NT / E) {
      const int row = row0 + r;
      // dctx is an operand only (of dP and dV): rounded where it is made
      if (row < BT) S.e[kDctx][(size_t)row * E + i] = operand<R>(dot_row<E>(das + r * E, woc));
    }
  }
}

// ---- 2. attention backward, one CTA per (sample, head) ------------------------
// (R: the bf16 mode; q, k, v, ctx and dctx arrive as bf16 values, dS and
// the dropped-out P are rounded as they become operands)
template <bool R>
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
          const float pm = operand<R>(p * m);
          const float dsv = operand<R>(p * (dot8(cv, vv) * m - st.y) * inv_scale);
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
template <typename XT>
__global__ void __launch_bounds__(NT)
qkv_bwd_kernel(const XT* __restrict__ x, BlockParams P, int BT,
               XT* __restrict__ dx, Scratch S) {
  constexpr bool R = kBf16<XT>;  // round the products' operands
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
    float* src = S.e[kDq + m] + (size_t)row * E + e;
    dqkv[i] = row < BT ? *src : 0.f;  // unrounded: the bias gradients sum it
    if (R && row < BT) *src = round_bf16(*src);  // an operand of dWq, dWk, dWv
  }
  __syncthreads();

  // dy1 partials: thread = (projection m, column e), one weight column each
  if (tid < 3 * E) {
    const int m = tid / E, e = tid % E;
    const float* W = m == 0 ? P.p[2] : (m == 1 ? P.p[3] : P.p[4]);  // no indexed copy of P
    float wc[E];
#pragma unroll
    for (int o = 0; o < E; ++o) wc[o] = operand<R>(__ldg(W + o * E + e));
    for (int r = 0; r < RB; ++r)
      part[(m * RB + r) * E + e] = dot_row<E, R>(dqkv + (m * RB + r) * E, wc);
  }
  __syncthreads();

  // LN1 recomputed from x, its backward and dx, a warp per row
  float sum_dyy[2] = {0.f, 0.f}, sum_dy[2] = {0.f, 0.f};
  for (int r = warp; r < RB; r += NW) {
    const int row = row0 + r;
    if (row >= BT) continue;
    const XT* xr = x + (size_t)row * E;
    const float a0 = to_f32(xr[lane]), a1 = to_f32(xr[lane + 32]);
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
      store_as(dx + o, S.e[kDx1][o] + (gh[half] - mean_gh - y[half] * mean_ghy) * inv);
      S.e[kY1a][o] = operand<R>(y[half] * __ldg(g1 + e) + __ldg(be1 + e));
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

// The three row and attention launches of one mode (XT = bf16: the bf16
// instantiations), with their shared-memory limits set first.
template <typename XT>
cudaError_t launch_rows(const XT* x, const XT* g, XT* dx, const float* q, const float* k,
                        const float* v, const float* ctx, const float* x1, const float* lse,
                        const BlockParams& P, int B, int T, float inv_scale,
                        const DropCfg& drop, const Scratch& S, cudaStream_t st) {
  const int BT = B * T, row_ctas = (BT + RB - 1) / RB;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if ((err = set_smem((const void*)ffn_bwd_kernel<XT>, kFfnSmemFloats, optin)) != cudaSuccess ||
      (err = set_smem((const void*)attn_bwd_kernel<kBf16<XT>>, attn_smem_floats(T), optin)) !=
          cudaSuccess ||
      (err = set_smem((const void*)qkv_bwd_kernel<XT>, kQkvSmemFloats, optin)) != cudaSuccess)
    return err;

  ffn_bwd_kernel<XT><<<row_ctas, NT, kFfnSmemFloats * sizeof(float), st>>>(g, x1, P, T, BT,
                                                                           drop, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  attn_bwd_kernel<kBf16<XT>><<<B * H, attn_threads(T), attn_smem_floats(T) * sizeof(float),
                               st>>>(q, k, v, ctx, lse, T, inv_scale, drop, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  qkv_bwd_kernel<XT><<<row_ctas, NT, kQkvSmemFloats * sizeof(float), st>>>(x, P, BT, dx, S);
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
      bf16_mode ? launch_rows(static_cast<const bf16*>(x), static_cast<const bf16*>(g),
                              static_cast<bf16*>(dx), q, k, v, ctx, x1, lse, P, B, T, inv_scale,
                              drop, S, st)
                : launch_rows(static_cast<const float*>(x), static_cast<const float*>(g),
                              static_cast<float*>(dx), q, k, v, ctx, x1, lse, P, B, T,
                              inv_scale, drop, S, st);
  if (err != cudaSuccess) return (int)err;
  if (const cudaError_t e2 = plan.launch_products(st); e2 != cudaSuccess) return (int)e2;
  return (int)plan.launch_sums(st);
}
