// Fused pre-LN transformer encoder block, forward, f32 or bf16 mode, eval or
// training.
//
// Replaces: transformer_clip_eeg_tpu/ops/pallas_block.py, _fused_block_fwd
// (pl.pallas_call at :458; kernel body _fwd_kernel :255 / _forward_core :189).
//
// Computes, for x [B, T, E]:
//   y1 = LN1(x); q, k, v = y1 Wq^T + bq, y1 Wk^T + bk, y1 Wv^T + bv
//   per head h (d = E/H columns): P = softmax(q_h k_h^T / scale); ctx_h = P v_h
//   x1 = x + ctx Wo^T + bo
//   out = x1 + W2 gelu(W1 LN2(x1) + b1) + b2       (exact erf GELU)
// with `scale` the reference's full emb_size**0.5 (not the head dim).
//
// Training mode applies the JAX kernel's four dropout masks where
// _forward_core does (each head's P, the attention output after Wo + bo, the
// FFN inner after GELU, the FFN output after W2 + b2), drawn in-kernel by
// drop_bits (drop.cuh), the counter hash of ops/dropout.py, so the masks are
// the same bits as the JAX kernel's interpret mode and the plain twin.  q, k,
// v and the dropped-out attention context always go through `work`
// ([4][B][T][E]); with `save` the kernels also write x1 (a fifth plane) and
// then each softmax row's log-sum-exp ([B][H][T]): what the backward
// (fused_block_bwd.cu) reads.
//
// Bound on an H100 at the flagship shape (B=128, T=192, E=64, H=8, F=256):
// 28.3 MFLOP per sample, 3.62 GFLOP per call against 12.6 MB of x in and
// out, so the block is bound by f32 arithmetic (about 54 us at 67 TFLOP/s
// outside the tensor cores), not by memory (about 4 us at 3.35 TB/s).  What
// holds a simple version back is not the FMAs.  One CTA per sample with the
// whole sample in shared memory leaves an SM 8 warps and a window limit; a
// weight row in registers costs one shared-memory load per 4 FMAs; a warp per
// (query, head) spends more shuffles than FMAs; and row kernels that stage
// their weights anew for every tile of rows spend more time waiting for L2
// than multiplying (153 KB of weights for 64 rows of the FFN).
//
// Design: three launches, none with a sample as its unit and none whose
// shared memory grows with the 266 T floats of a whole sample.
//   1. ln_qkv_kernel, 192 threads, three CTAs an SM that stay there: Wq, Wk
//      and Wv are staged once (cp.async), then the CTA walks tiles of 32 rows
//      of the B*T, the next tile's rows landing while this one is worked on:
//      LN1 a warp a row in shared memory, then a warp per 32 x 32 outputs of
//      q, k or v on the tensor cores (rowtile.cuh: split TF32, three products,
//      f32 sums).
//   2. attn_fwd_kernel, one CTA per (sample, head), 1,024 at the flagship
//      shape: the head's K and V (T x 8 floats each) in shared memory, two
//      queries a thread with q, the running max, the sum and the 8-wide
//      context in registers.  The keys go by in tiles of 16 read as broadcast
//      rows: the tile's scores stay in registers, the running max moves once
//      a tile (an online softmax in base 2: log2(e) / scale is folded into
//      q), the sum takes the clean probabilities and the context the
//      dropped-out ones.  No score touches shared memory and nothing is
//      summed across lanes.  lse = max + log(sum) leaves with the context.
//      Plain f32 FMAs: it is bound by instruction issue, about 25 a pair.
//   3. proj_ffn_kernel, 512 threads, one CTA an SM that stays there (215 KB):
//      W1 and W2 are staged once, then the CTA walks tiles of 64 rows, the
//      next tile's ctx rows landing during the FFN's second product.  A warp
//      takes 16 rows x 16 columns of the out-projection (its slice of Wo
//      comes straight from device memory as B fragments), adds the residual
//      and keeps x1 in registers; LN2 a warp a row; a warp takes 32 rows x 32
//      units of the hidden layer (GELU, mask) and leaves them in shared
//      memory; then each warp multiplies its 16 rows of the hidden layer by
//      its 16 rows of W2 over all 256 units, so the sum needs no other warp,
//      and adds x1.  The hidden layer never reaches device memory.
// What was measured on the way (PERF.md): an f32 register tile (4 x 8 sums a
// thread) in place of the tensor cores, CTAs that restage their weights for
// every tile, one to four queries a thread and key tiles of 8 and 32 in the
// attention, one launch for the whole block: all slower.
// Each head's d=8 slice is computed directly: the TPU kernel's full-width
// masked head matmuls, which did eight times the attention arithmetic to
// suit a 128x128 matrix unit, are not carried over.  No atomics: the outputs
// repeat bit for bit.
//
// The bf16 mode (the JAX kernel's mm_dtype='bfloat16', --compute_dtype
// bfloat16) is a second instantiation of the row kernels, on XT = bf16, and
// an attention kernel of its own: x is read and out written in bf16, every
// product takes operands rounded to bf16 with f32 sums, and everything else
// (LayerNorms, softmax, GELU, masks, residuals) stays f32.  The row products
// are one mma.sync m16n8k16 bf16 product each (rowtile.cuh, rounding as the
// fragments load) in place of split TF32's three.  q, k, v and the context
// are operands only, so they are rounded where they are made and kept as
// bf16 values in the f32 planes of `work` (the layout the backward reads).
// The attention (attn_fwd_bf16_kernel, 2' below) runs both of its products on
// the tensor cores and walks the keys twice, since JAX rounds the
// probabilities after they are normalised.  Bound at the flagship shape:
// 3.62 GFLOP of products at 989 TFLOP/s dense bf16 (3.7 us) against 6.3 MB
// of bf16 x and out plus 25 MB of f32 planes written and read back by the
// three launches (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_common.cuh"
#include "drop.cuh"
#include "rowtile.cuh"

namespace {

using rowtile::frag_col;
using rowtile::frag_row;
using rowtile::stage_rows;

constexpr int QRT = 32;       // rows of the B*T per CTA of ln_qkv_kernel
constexpr int QKV_NT = 192;   // its threads: a warp per 32 rows x 32 columns of q, k or v
constexpr int RT = 64;        // rows of the B*T per CTA of proj_ffn_kernel
constexpr int FFN_NT = 512;   // its threads: a warp per 32 rows x 32 hidden units
constexpr int LDW = E + rowtile::PAD;   // a row of E floats in shared memory
constexpr int LDW2 = F + rowtile::PAD;  // a row of F floats
constexpr int NQ = 2;         // queries a thread in attn_fwd_kernel
constexpr int KT = 16;        // keys per step of the attention's online softmax
constexpr int ATT_NT = 256;   // most threads of attn_fwd_kernel
constexpr int QKV_CTAS_PER_SM = 3;
constexpr int QKV_SMEM_FLOATS = 3 * E * LDW + 2 * QRT * LDW;
constexpr int FFN_SMEM_FLOATS = F * LDW + E * LDW2 + RT * LDW + RT * LDW2;

static_assert(E == 64 && D == 8 && F == 4 * E, "the tiles are built for these widths");
static_assert(QKV_NT / 32 == 3 * E / 32 && QRT == 32, "a warp: 32 rows x 32 columns");
static_assert(FFN_NT / 32 == (RT / 32) * (F / 32) && FFN_NT / 32 == (RT / 16) * (E / 16),
              "a warp: 32 x 32 of the hidden layer, 16 x 16 of the out-projection");

// ---- 1. LN1 and the Q, K, V projections ------------------------------------------
template <typename XT>
__global__ void __launch_bounds__(QKV_NT, QKV_CTAS_PER_SM)
ln_qkv_kernel(const XT* __restrict__ x, BlockParams P, int BT, float* __restrict__ q,
              float* __restrict__ k, float* __restrict__ v) {
  constexpr bool BF16 = kBf16<XT>;
  extern __shared__ __align__(16) float smem[];
  float* Ws = smem;              // [3 E][LDW]: the rows of Wq, Wk, Wv, staged once
  float* Xs = Ws + 3 * E * LDW;  // [2][QRT][LDW]: this tile's rows and the next one's
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles = (BT + QRT - 1) / QRT;

  // rows of tile `tile` into buffer `buf`, rows past the end zero-filled; bf16
  // rows are widened to float by plain loads (the buffer is free: the barrier
  // that ends the tile before this one's reader has passed)
  auto stage_tile = [&](int tile, int buf) {
    const int row0 = tile * QRT;
    const int valid = BT - row0 < QRT ? BT - row0 : QRT;
    if constexpr (BF16) {
#pragma unroll 1
      for (int c = tid; c < QRT * E / 2; c += QKV_NT) {
        const int n = c / (E / 2), e = (c % (E / 2)) * 2;
        store2(Xs + (buf * QRT + n) * LDW + e,
               n < valid ? load2(x + (size_t)(row0 + n) * E + e) : make_float2(0.f, 0.f));
      }
    } else {
      stage_rows<E>(Xs + buf * QRT * LDW, reinterpret_cast<const float*>(x) + (size_t)row0 * E,
                    E, QRT, valid, tid, QKV_NT);
    }
  };
  stage_rows<E>(Ws, P.p[2], E, E, E, tid, QKV_NT);
  stage_rows<E>(Ws + E * LDW, P.p[3], E, E, E, tid, QKV_NT);
  stage_rows<E>(Ws + 2 * E * LDW, P.p[4], E, E, E, tid, QKV_NT);
  stage_tile(blockIdx.x, 0);
  cp_async_commit();

  // warp: projection m, columns c0 .. c0 + 31 of it, all 32 rows of a tile
  const int m = warp >> 1, c0 = (warp & 1) * 32;
  float* __restrict__ dst = m == 0 ? q : (m == 1 ? k : v);  // no indexed copy of P
  const float* bias = m == 0 ? P.p[5] : (m == 1 ? P.p[6] : P.p[7]);
  float2 b2[4];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
    b2[ni] = __ldg(reinterpret_cast<const float2*>(bias + c0 + frag_col(lane, ni)));

  for (int tile = blockIdx.x, it = 0; tile < tiles; tile += gridDim.x, ++it) {
    float* As = Xs + (it & 1) * QRT * LDW;
    const int row0 = tile * QRT;
    const int valid = BT - row0 < QRT ? BT - row0 : QRT;
    if (tile + gridDim.x < tiles) stage_tile(tile + gridDim.x, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // all but the copies just started: this tile's rows are in
    __syncthreads();
    for (int r = warp; r < QRT; r += QKV_NT / 32)
      layernorm_row(As + r * LDW, As + r * LDW, P.p[0], P.p[1], lane);
    __syncthreads();

    float acc[2][4][4];
    rowtile::zero(acc);
    rowtile::mma_tile_mode<BF16, 2, 4, E, LDW, LDW>(As, Ws + (m * E + c0) * LDW, acc, lane);
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int n = c0 + frag_col(lane, ni);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = frag_row(lane, mi, half);
          if (r < valid)  // q, k, v: operands only, rounded here in the bf16 mode
            *reinterpret_cast<float2*>(dst + (size_t)(row0 + r) * E + n) =
                make_float2(operand<BF16>(acc[mi][ni][2 * half] + b2[ni].x),
                            operand<BF16>(acc[mi][ni][2 * half + 1] + b2[ni].y));
        }
    }
    __syncthreads();  // the tile after next may land where this one was
  }
}

// ---- 2. attention, one CTA per (sample, head) -----------------------------------
// qscale = log2(e) / scale: the scores, the running max m and the sum l are
// those of a softmax in base 2, P = 2^(s - m) / l, lse = m ln 2 + log l.

// One tile of KT keys from j0 on for a thread's two queries; RAGGED when the
// tile may pass T (its keys from T on count as -inf)
template <bool RAGGED, bool DROP>
__device__ __forceinline__ void attn_step(const float* Ks, const float* Vs, int j0, int T,
                                          const float (&qv)[NQ][D], float (&m)[NQ], float (&l)[NQ],
                                          float (&acc)[NQ][D], uint32_t key,
                                          const uint32_t (&idx)[NQ], const DropCfg& drop) {
  float s[NQ][KT], tmax[NQ];
#pragma unroll
  for (int u = 0; u < NQ; ++u) tmax[u] = -INFINITY;
#pragma unroll
  for (int jj = 0; jj < KT; ++jj) {
    float kk[D];
    load8(Ks + (j0 + jj) * D, kk);
#pragma unroll
    for (int u = 0; u < NQ; ++u) {
      s[u][jj] = dot8(qv[u], kk);
      if (RAGGED && j0 + jj >= T) s[u][jj] = -INFINITY;
      tmax[u] = fmaxf(tmax[u], s[u][jj]);
    }
  }
#pragma unroll
  for (int u = 0; u < NQ; ++u) {  // the running max moves once a tile
    const float mn = fmaxf(m[u], tmax[u]);
    const float alpha = exp2f(m[u] - mn);
    m[u] = mn;
    l[u] *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[u][d] *= alpha;
  }
#pragma unroll
  for (int jj = 0; jj < KT; ++jj) {
    float vv[D];
    load8(Vs + (j0 + jj) * D, vv);
#pragma unroll
    for (int u = 0; u < NQ; ++u) {
      float p = exp2f(s[u][jj] - m[u]);
      l[u] += p;  // the softmax normalises the clean probabilities
      if (DROP) p *= drop_mult(key, idx[u] + (uint32_t)(j0 + jj), drop.thr, drop.keep);
#pragma unroll
      for (int d = 0; d < D; ++d) acc[u][d] = fmaf(p, vv[d], acc[u][d]);
    }
  }
}

// (one CTA an SM is all the bound asks for: the compiler then takes the
// registers it wants, 104 in eval and 138 with the mask hash, which measured
// 10% faster in training than the 116-125 it settles on unasked)
template <bool DROP>
__global__ void __launch_bounds__(ATT_NT, 1)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ ctx,
                float* __restrict__ lse, int T, float qscale, DropCfg drop) {
  extern __shared__ __align__(16) float smem[];
  const int Tp = (T + KT - 1) / KT * KT;  // keys, padded to whole tiles with zeros
  float* Ks = smem;         // [Tp][D]
  float* Vs = Ks + Tp * D;  // [Tp][D]
  const int tid = threadIdx.x, nt = blockDim.x;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const size_t base = (size_t)b * T * E + h * D;

  for (int j = tid; j < Tp; j += nt) {
    float kv[D], vv[D];
#pragma unroll
    for (int d = 0; d < D; ++d) kv[d] = vv[d] = 0.f;
    if (j < T) {
      load8(k + base + (size_t)j * E, kv);
      load8(v + base + (size_t)j * E, vv);
    }
    store8(Ks + j * D, kv);
    store8(Vs + j * D, vv);
  }
  __syncthreads();

  const DropSample ds = drop_sample(drop, b, BLOCK_TILE_MULT);
  const uint32_t key = ds.seed_base + (uint32_t)h;
  for (int t0 = tid; t0 < T; t0 += NQ * nt) {
    int t[NQ];
    bool live[NQ];
    float qv[NQ][D], acc[NQ][D], m[NQ], l[NQ];
    uint32_t idx[NQ];  // the mask's index of (t, 0): (local T + t) T, mod 2^32
#pragma unroll
    for (int u = 0; u < NQ; ++u) {
      t[u] = t0 + u * nt;
      live[u] = t[u] < T;
    }
#pragma unroll
    for (int u = 0; u < NQ; ++u) {
#pragma unroll
      for (int d = 0; d < D; ++d) qv[u][d] = acc[u][d] = 0.f;
      if (live[u]) load8(q + base + (size_t)t[u] * E, qv[u]);
#pragma unroll
      for (int d = 0; d < D; ++d) qv[u][d] *= qscale;
      m[u] = -INFINITY;
      l[u] = 0.f;
      idx[u] = (uint32_t)(ds.local * T + t[u]) * (uint32_t)T;
    }
    int j0 = 0;
    for (; j0 + KT <= T; j0 += KT)
      attn_step<false, DROP>(Ks, Vs, j0, T, qv, m, l, acc, key, idx, drop);
    if (j0 < T) attn_step<true, DROP>(Ks, Vs, j0, T, qv, m, l, acc, key, idx, drop);

#pragma unroll
    for (int u = 0; u < NQ; ++u) {
      if (!live[u]) continue;
      const float inv = 1.0f / l[u];
#pragma unroll
      for (int d = 0; d < D; ++d) acc[u][d] *= inv;
      store8(ctx + base + (size_t)t[u] * E, acc[u]);
      if (lse != nullptr)  // the row's log-sum-exp: P = exp(s / scale - lse)
        lse[((size_t)b * H + h) * T + t[u]] = m[u] * 0.69314718055994531f + logf(l[u]);
    }
  }
}

// ---- 2'. the bf16 mode's attention, on the tensor cores --------------------------
// JAX rounds the probabilities as p.v's operand, after they are normalised and
// dropped out; an online softmax would round 2^(s - m) before the sum is
// known, and bf16(e) / l is not bf16(e / l), so the keys are walked twice:
// once for each row's max m and sum l, once for the context.  A warp takes a
// tile of BQT queries (q as the A operand of m16n8k8, k = the head's 8
// columns), the head's K and V wait as bf16 rows in shared memory, and each
// pass walks the keys BKT at a time: S = Q K^T (ldmatrix, four m16n8k8
// blocks), times log2(e) / scale in f32.  Pass 1 keeps each row's max and
// this lane's share of the sum (the 4 lanes of a row agree on the max after
// each step and add their sums at the end); pass 2 forms p = bf16(mask 2^(s -
// m) / l) in the accumulators' places, which for two adjacent 8-key blocks
// are the A fragment of m16n8k16, and adds p V (V by ldmatrix.trans).  Keys
// past T score -inf and their V rows are zero.
constexpr int BQT = 16;         // queries a warp's tile
constexpr int BKT = 32;         // keys a step of the two passes; K and V padded to it
constexpr int BATT_WARPS = 8;   // most warps of attn_fwd_bf16_kernel

// the scores q.k of keys j0 .. j0 + BKT - 1 for the warp's queries (-inf
// past T when RAGGED): s[nb][c] at row g (c < 2) or g + 8, key j0 + 8 nb +
// 2 (lane % 4) + c % 2
template <bool RAGGED>
__device__ __forceinline__ void bf16_scores(const rowtile::bf16_t* Kb, int j0, int T,
                                            const uint32_t (&qa)[2], int lane, float (&s)[4][4]) {
  uint32_t kb[4];
  rowtile::ldsm4<false>(kb, Kb + (j0 + lane) * D);
#pragma unroll
  for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
    for (int c = 0; c < 4; ++c) s[nb][c] = 0.f;
    rowtile::mma_bf16_k8(s[nb], qa, kb[nb]);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (RAGGED && j0 + 8 * nb + 2 * (lane & 3) + (c & 1) >= T) s[nb][c] = -INFINITY;
  }
}

// pass 1, one step of keys: the rows' running max m of s qscale (the 4 lanes
// of a row agree on it) and this lane's share of the sum l of 2^(s qscale - m)
template <bool RAGGED>
__device__ __forceinline__ void bf16_stats_step(const rowtile::bf16_t* Kb, int j0, int T,
                                                const uint32_t (&qa)[2], float qscale, int lane,
                                                float (&m)[2], float (&l)[2]) {
  float s[4][4];
  bf16_scores<RAGGED>(Kb, j0, T, qa, lane, s);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float tmax = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) tmax = fmaxf(tmax, fmaxf(s[nb][2 * hh], s[nb][2 * hh + 1]));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float mn = fmaxf(m[hh], tmax * qscale);  // qscale > 0: the max of the scaled
    l[hh] *= exp2_sfu(m[hh] - mn);
    m[hh] = mn;
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int c = 2 * hh; c < 2 * hh + 2; ++c) l[hh] += exp2_sfu(fmaf(s[nb][c], qscale, -mn));
  }
}

// pass 2, one step of keys: acc += bf16(mask 2^(s qscale - m) / l) v
template <bool RAGGED, bool DROP>
__device__ __forceinline__ void bf16_ctx_step(const rowtile::bf16_t* Kb,
                                              const rowtile::bf16_t* Vb, int j0, int T,
                                              const uint32_t (&qa)[2], float qscale,
                                              const float (&m)[2], const float (&inv_l)[2],
                                              const uint32_t (&idx)[2], uint32_t key,
                                              const DropCfg& drop, int lane, float (&acc)[4]) {
  float s[4][4];
  bf16_scores<RAGGED>(Kb, j0, T, qa, lane, s);
  uint32_t vb[4];  // V's keys j0 + 8 i .. + 7 as B fragments (k = keys)
  rowtile::ldsm4<true>(vb, Vb + (j0 + lane) * D);
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    uint32_t pa[4];
#pragma unroll
    for (int nbi = 0; nbi < 2; ++nbi) {
      const int nb = 2 * ks + nbi;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float p[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          p[c] = exp2_sfu(fmaf(s[nb][2 * hh + c], qscale, -m[hh])) * inv_l[hh];
          if (DROP)
            p[c] *= drop_mult(key, idx[hh] + (uint32_t)(j0 + 8 * nb + 2 * (lane & 3) + c),
                              drop.thr, drop.keep);
        }
        pa[2 * nbi + hh] = rowtile::pack_bf16(p[0], p[1]);
      }
    }
    const uint32_t bv[2] = {vb[2 * ks], vb[2 * ks + 1]};
    rowtile::mma_bf16(acc, pa, bv);
  }
}

template <bool DROP>
__global__ void __launch_bounds__(32 * BATT_WARPS)
attn_fwd_bf16_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ ctx,
                     float* __restrict__ lse, int T, float qscale, DropCfg drop) {
  extern __shared__ __align__(16) float smem[];
  const int Tp = (T + BKT - 1) / BKT * BKT;
  rowtile::bf16_t* Kb = reinterpret_cast<rowtile::bf16_t*>(smem);  // [Tp][D]
  rowtile::bf16_t* Vb = Kb + Tp * D;                               // [Tp][D]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const size_t base = (size_t)b * T * E + h * D;

  for (int j = tid; j < Tp; j += blockDim.x) {
    float kv[D], vv[D];
#pragma unroll
    for (int d = 0; d < D; ++d) kv[d] = vv[d] = 0.f;
    if (j < T) {
      load8(k + base + (size_t)j * E, kv);
      load8(v + base + (size_t)j * E, vv);
    }
    rowtile::store_bf16x8(Kb + j * D, kv);
    rowtile::store_bf16x8(Vb + j * D, vv);
  }
  __syncthreads();

  const DropSample ds = drop_sample(drop, b, BLOCK_TILE_MULT);
  const uint32_t key = ds.seed_base + (uint32_t)h;
  for (int t0 = BQT * warp; t0 < T; t0 += BQT * nw) {
    const int tq[2] = {t0 + g8, t0 + g8 + 8};
    uint32_t qa[2], idx[2];  // idx: the mask's index of (t, 0), (local T + t) T, mod 2^32
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float2 qq = tq[hh] < T
                            ? *reinterpret_cast<const float2*>(q + base + (size_t)tq[hh] * E + 2 * t4)
                            : make_float2(0.f, 0.f);
      qa[hh] = rowtile::pack_bf16(qq.x, qq.y);
      idx[hh] = (uint32_t)(ds.local * T + tq[hh]) * (uint32_t)T;
    }

    // pass 1: each row's max m and the sum l of 2^(s - m), the clean probabilities
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    int j0 = 0;
    for (; j0 + BKT <= T; j0 += BKT) bf16_stats_step<false>(Kb, j0, T, qa, qscale, lane, m, l);
    if (j0 < T) bf16_stats_step<true>(Kb, j0, T, qa, qscale, lane, m, l);
    float inv_l[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
      inv_l[hh] = 1.0f / l[hh];
    }

    // pass 2: ctx += bf16(mask 2^(s - m) / l) v
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (j0 = 0; j0 + BKT <= T; j0 += BKT)
      bf16_ctx_step<false, DROP>(Kb, Vb, j0, T, qa, qscale, m, inv_l, idx, key, drop, lane, acc);
    if (j0 < T)
      bf16_ctx_step<true, DROP>(Kb, Vb, j0, T, qa, qscale, m, inv_l, idx, key, drop, lane, acc);

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (tq[hh] >= T) continue;
      *reinterpret_cast<float2*>(ctx + base + (size_t)tq[hh] * E + 2 * t4) =
          make_float2(round_bf16(acc[2 * hh]), round_bf16(acc[2 * hh + 1]));
      if (lse != nullptr && t4 == 0)  // the row's log-sum-exp: P = exp(s / scale - lse)
        lse[((size_t)b * H + h) * T + tq[hh]] = m[hh] * 0.69314718055994531f + logf(l[hh]);
    }
  }
}

// ---- 3. out-projection, residual, LN2 and the FFN --------------------------------
// v * the mask of elements idx, idx + 1 under `key`
__device__ __forceinline__ float2 drop2(float2 v, uint32_t key, uint32_t idx, uint32_t thr,
                                        float keep) {
  return make_float2(v.x * drop_mult(key, idx, thr, keep),
                     v.y * drop_mult(key, idx + 1, thr, keep));
}

template <typename XT>
__global__ void __launch_bounds__(FFN_NT, 1)
proj_ffn_kernel(const XT* __restrict__ x, const float* __restrict__ ctx,
                XT* __restrict__ out, BlockParams P, int T, int BT, DropCfg drop,
                float* __restrict__ x1_out) {
  constexpr bool BF16 = kBf16<XT>;
  extern __shared__ __align__(16) float smem[];
  float* W1s = smem;             // [F][LDW]: W1's rows, one a hidden unit, staged once
  float* W2s = W1s + F * LDW;    // [E][LDW2]: W2's rows, staged once
  float* As = W2s + E * LDW2;    // [RT][LDW]: ctx's rows, then LN2's output
  float* Hs = As + RT * LDW;     // [RT][LDW2]: x1's rows [RT][LDW], then the hidden layer
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles = (BT + RT - 1) / RT;

  auto stage_ctx = [&](int tile) {
    const int row0 = tile * RT;
    stage_rows<E>(As, ctx + (size_t)row0 * E, E, RT, BT - row0 < RT ? BT - row0 : RT, tid,
                  FFN_NT);
  };
  stage_ctx(blockIdx.x);
  stage_rows<E>(W1s, P.p[12], E, F, F, tid, FFN_NT);
  stage_rows<F>(W2s, P.p[14], F, E, E, tid, FFN_NT);
  cp_async_commit();

  // the out-projection's warp tile: 16 rows x 16 columns
  const int pr0 = 16 * (warp >> 2), pc0 = 16 * (warp & 3);

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * RT;
    const int valid = BT - row0 < RT ? BT - row0 : RT;

    // the warp's slice of Wo as the tensor core's B fragments, straight from
    // device memory (16 KB that stay in L1), and x's elements of 3a: both asked
    // for before the wait
    float wo[E / 8][2][2];
    if constexpr (!BF16) {
#pragma unroll
      for (int ks = 0; ks < E / 8; ++ks)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
          const float* p = P.p[8] + (pc0 + 8 * ni + (lane >> 2)) * E + 8 * ks + (lane & 3);
          wo[ks][ni][0] = __ldg(p);
          wo[ks][ni][1] = __ldg(p + 4);
        }
    }
    float2 xv[2][2];
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        const int r = pr0 + frag_row(lane, 0, half);
        xv[half][ni] = r < valid ? load2(x + (size_t)(row0 + r) * E + pc0 + frag_col(lane, ni))
                                 : make_float2(0.f, 0.f);
      }
    cp_async_wait<0>();  // this tile's ctx rows (and, the first time, W1 and W2)
    __syncthreads();

    // 3a. x1 = x + (ctx Wo^T + bo) * m_a; x1 stays in x1r for 3d
    float2 x1r[2][2];  // [half][ni]
    {
      float acc[2][4];
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[ni][c] = 0.f;
      if constexpr (BF16) {  // Wo's rows straight from device memory as B fragments
        float a3[1][2][4];
        rowtile::zero(a3);
        rowtile::mma_tile_bf16<1, 2, E, LDW, E>(As + pr0 * LDW, P.p[8] + pc0 * E, a3, lane);
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[ni][c] = a3[0][ni][c];
      } else {
        const float* ap = As + (pr0 + (lane >> 2)) * LDW + (lane & 3);
#pragma unroll
        for (int ks = 0; ks < E / 8; ++ks) {
          uint32_t ah[4], al[4];
          rowtile::split_tf32(ap[8 * ks], ah[0], al[0]);
          rowtile::split_tf32(ap[8 * LDW + 8 * ks], ah[1], al[1]);
          rowtile::split_tf32(ap[8 * ks + 4], ah[2], al[2]);
          rowtile::split_tf32(ap[8 * LDW + 8 * ks + 4], ah[3], al[3]);
#pragma unroll
          for (int ni = 0; ni < 2; ++ni) {
            uint32_t bh[2], bl[2];
            rowtile::split_tf32(wo[ks][ni][0], bh[0], bl[0]);
            rowtile::split_tf32(wo[ks][ni][1], bh[1], bl[1]);
            rowtile::mma_tf32(acc[ni], al, bh);
            rowtile::mma_tf32(acc[ni], ah, bl);
            rowtile::mma_tf32(acc[ni], ah, bh);
          }
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = pr0 + frag_row(lane, 0, half), row = row0 + r;
        RowDrop rd{0u, 0u};
        if (drop.on && r < valid) rd = row_drop(drop, row, T);
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
          const int n = pc0 + frag_col(lane, ni);
          float2 v = make_float2(0.f, 0.f);
          if (r < valid) {
            const float2 b2 = __ldg(reinterpret_cast<const float2*>(P.p[9] + n));
            float2 a = make_float2(acc[ni][2 * half] + b2.x, acc[ni][2 * half + 1] + b2.y);
            if (drop.on)
              a = drop2(a, rd.seed_base + (uint32_t)H, rd.row * E + n, drop.thr, drop.keep);
            v = make_float2(xv[half][ni].x + a.x, xv[half][ni].y + a.y);
            if (x1_out != nullptr) *reinterpret_cast<float2*>(x1_out + (size_t)row * E + n) = v;
          }
          x1r[half][ni] = v;
          *reinterpret_cast<float2*>(Hs + r * LDW + n) = v;
        }
      }
    }
    __syncthreads();  // ctx is read by no one now

    // 3b. LN2, a warp a row
    for (int r = warp; r < RT; r += FFN_NT / 32)
      layernorm_row(Hs + r * LDW, As + r * LDW, P.p[10], P.p[11], lane);
    __syncthreads();

    // 3c. the hidden layer: a warp takes 32 rows x 32 hidden units, 16 rows at
    // a time (all 32 at once need more registers than 512 threads leave)
    {
      const int f0 = 32 * (warp & 7);
#pragma unroll 1
      for (int r0 = 32 * (warp >> 3), end = r0 + 32; r0 < end; r0 += 16) {
        float acc[1][4][4];
        rowtile::zero(acc);
        rowtile::mma_tile_mode<BF16, 1, 4, E, LDW, LDW>(As + r0 * LDW, W1s + f0 * LDW, acc,
                                                        lane);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = r0 + frag_row(lane, 0, half);
          RowDrop rd{0u, 0u};
          if (drop.on) rd = row_drop(drop, row0 + (r < valid ? r : 0), T);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            const int f = f0 + frag_col(lane, ni);
            const float2 b2 = __ldg(reinterpret_cast<const float2*>(P.p[13] + f));
            float2 hv = make_float2(gelu(acc[0][ni][2 * half] + b2.x),
                                    gelu(acc[0][ni][2 * half + 1] + b2.y));
            if (drop.on)
              hv = drop2(hv, rd.seed_base + (uint32_t)(H + 1), rd.row * F + f, drop.thr_ffn,
                         drop.keep_ffn);
            *reinterpret_cast<float2*>(Hs + r * LDW2 + f) = hv;
          }
        }
      }
    }
    __syncthreads();  // LN2's output is read by no one now: the next tile's ctx may land
    if (tile + gridDim.x < tiles) stage_ctx(tile + gridDim.x);
    cp_async_commit();

    // 3d. out = x1 + (hidden W2^T + b2) * m_2: the warp's 16 x 16 elements of 3a,
    // over all F hidden units, so the sum needs no other warp
    {
      float fo[1][2][4];
      rowtile::zero(fo);
      rowtile::mma_tile_mode<BF16, 1, 2, F, LDW2, LDW2>(Hs + pr0 * LDW2, W2s + pc0 * LDW2, fo,
                                                        lane);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = pr0 + frag_row(lane, 0, half), row = row0 + r;
        if (r >= valid) continue;
        RowDrop rd{0u, 0u};
        if (drop.on) rd = row_drop(drop, row, T);
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
          const int n = pc0 + frag_col(lane, ni);
          const float2 b2 = __ldg(reinterpret_cast<const float2*>(P.p[15] + n));
          float2 f2 = make_float2(fo[0][ni][2 * half] + b2.x, fo[0][ni][2 * half + 1] + b2.y);
          if (drop.on)
            f2 = drop2(f2, rd.seed_base + (uint32_t)(H + 2), rd.row * E + n, drop.thr, drop.keep);
          store2(out + (size_t)row * E + n,
                 make_float2(x1r[half][ni].x + f2.x, x1r[half][ni].y + f2.y));
        }
      }
    }
    // the next tile's 3a writes x1's rows over the hidden layer only after its barrier
  }
}

// threads of attn_fwd_kernel: two queries each, whole warps, at most ATT_NT
int attn_threads(int T) {
  const int nt = 32 * ((T + 32 * NQ - 1) / (32 * NQ));
  return nt < ATT_NT ? nt : ATT_NT;
}

size_t attn_smem_bytes(int T) {
  return 2 * (size_t)((T + KT - 1) / KT * KT) * D * sizeof(float);
}

// warps of attn_fwd_bf16_kernel: as many as split the tiles of BQT queries
// evenly over the fewest rounds of at most BATT_WARPS
int attn_bf16_threads(int T) {
  const int tiles = (T + BQT - 1) / BQT;
  const int rounds = (tiles + BATT_WARPS - 1) / BATT_WARPS;
  return 32 * ((tiles + rounds - 1) / rounds);
}

size_t attn_bf16_smem_bytes(int T) {
  return 2 * (size_t)((T + BKT - 1) / BKT * BKT) * D * sizeof(rowtile::bf16_t);
}

cudaError_t set_smem(const void* fn, size_t bytes, int optin) {
  if (bytes > (size_t)optin) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The three launches of one mode on checked arguments.
template <typename XT>
cudaError_t launch_forward(const XT* x, XT* out, const BlockParams& P, int B, int T,
                           float inv_scale, const DropCfg& drop, float* work, int save,
                           int sms, cudaStream_t st) {
  constexpr bool BF16 = kBf16<XT>;
  const int BT = B * T;
  const size_t plane = (size_t)BT * E;
  float *q = work, *k = work + plane, *v = work + 2 * plane, *ctx = work + 3 * plane;
  float* x1 = save ? work + 4 * plane : nullptr;
  float* lse = save ? work + 5 * plane : nullptr;
  // the row kernels' CTAs stay on their SMs and walk the tiles of rows
  const int qkv_tiles = (BT + QRT - 1) / QRT, ffn_tiles = (BT + RT - 1) / RT;
  const int qkv_ctas = qkv_tiles < QKV_CTAS_PER_SM * sms ? qkv_tiles : QKV_CTAS_PER_SM * sms;
  const int ffn_ctas = ffn_tiles < sms ? ffn_tiles : sms;
  cudaError_t err;
  ln_qkv_kernel<XT><<<qkv_ctas, QKV_NT, QKV_SMEM_FLOATS * sizeof(float), st>>>(x, P, BT, q,
                                                                               k, v);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const float qscale = inv_scale * 1.4426950408889634f;
  if constexpr (BF16) {
    if (drop.on)
      attn_fwd_bf16_kernel<true><<<B * H, attn_bf16_threads(T), attn_bf16_smem_bytes(T), st>>>(
          q, k, v, ctx, lse, T, qscale, drop);
    else
      attn_fwd_bf16_kernel<false><<<B * H, attn_bf16_threads(T), attn_bf16_smem_bytes(T),
                                    st>>>(q, k, v, ctx, lse, T, qscale, drop);
  } else if (drop.on) {
    attn_fwd_kernel<true><<<B * H, attn_threads(T), attn_smem_bytes(T), st>>>(
        q, k, v, ctx, lse, T, qscale, drop);
  } else {
    attn_fwd_kernel<false><<<B * H, attn_threads(T), attn_smem_bytes(T), st>>>(
        q, k, v, ctx, lse, T, qscale, drop);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  proj_ffn_kernel<XT><<<ffn_ctas, FFN_NT, FFN_SMEM_FLOATS * sizeof(float), st>>>(
      x, ctx, out, P, T, BT, drop, x1);
  return cudaGetLastError();
}

// every instantiation's shared-memory limit
cudaError_t configure(int optin) {
  const size_t qkv_bytes = QKV_SMEM_FLOATS * sizeof(float);
  const size_t ffn_bytes = FFN_SMEM_FLOATS * sizeof(float);
  cudaError_t err;
  if ((err = set_smem((const void*)ln_qkv_kernel<float>, qkv_bytes, optin)) != cudaSuccess ||
      (err = set_smem((const void*)ln_qkv_kernel<bf16>, qkv_bytes, optin)) != cudaSuccess ||
      (err = set_smem((const void*)attn_fwd_kernel<true>, optin, optin)) != cudaSuccess ||
      (err = set_smem((const void*)attn_fwd_kernel<false>, optin, optin)) != cudaSuccess ||
      (err = set_smem((const void*)attn_fwd_bf16_kernel<true>, optin, optin)) != cudaSuccess ||
      (err = set_smem((const void*)attn_fwd_bf16_kernel<false>, optin, optin)) != cudaSuccess ||
      (err = set_smem((const void*)proj_ffn_kernel<float>, ffn_bytes, optin)) != cudaSuccess ||
      (err = set_smem((const void*)proj_ffn_kernel<bf16>, ffn_bytes, optin)) != cudaSuccess)
    return err;
  return cudaSuccess;
}

}  // namespace

// Launch on `stream`; returns the CUDA error code (0 on success).  The
// dropout arguments are those of DropCfg (drop.cuh).  `work` holds
// [4][B][T][E] floats (q, k, v, ctx), and with `save` a fifth plane (x1) and
// then [B][H][T] (lse): the `saved` tensor of the backward.  `bf16` selects
// the bf16 mode: x and out are then bf16 [B][T][E], `work` stays float.
// Three kernel launches.
extern "C" int tce_fused_block_fwd(const void* x, void* out,
                                   const void* const* params, int B, int T,
                                   int e, int h, int f, float inv_scale,
                                   int drop_on, unsigned seed, int tb,
                                   unsigned thr, float keep, unsigned thr_ffn,
                                   float keep_ffn, float* work, int save, int bf16_mode,
                                   void* stream) {
  if (e != E || h != H || f != F || B <= 0 || T <= 0 || tb <= 0 || work == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropCfg drop{drop_on, seed, tb, thr, keep, thr_ffn, keep_ffn};
  BlockParams P;
  for (int i = 0; i < 16; ++i) P.p[i] = static_cast<const float*>(params[i]);
  // the kernels' shared-memory limits, set once for each device (a call's
  // host time matters: a train step is bound by its launches)
  static int configured = -1, optin = 0, sms = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev != configured) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if ((err = configure(optin)) != cudaSuccess) return (int)err;
    configured = dev;
  }
  if (attn_smem_bytes(T) > (size_t)optin) return (int)cudaErrorInvalidValue;
  if (bf16_mode)
    return (int)launch_forward(static_cast<const bf16*>(x), static_cast<bf16*>(out), P, B, T,
                               inv_scale, drop, work, save, sms, st);
  return (int)launch_forward(static_cast<const float*>(x), static_cast<float*>(out), P, B, T,
                             inv_scale, drop, work, save, sms, st);
}
