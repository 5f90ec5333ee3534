// Fused pre-LN transformer encoder block, forward, f32, eval or training.
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
// the same bits as the JAX kernel's interpret mode and the plain twin.  When
// `saved` is not NULL the kernel also writes q, k, v, the dropped-out
// attention context and x1 ([5][B][T][E]) and then each softmax row's
// log-sum-exp ([B][H][T]) for the backward (fused_block_bwd.cu).
//
// Bound on an H100 at the flagship shape (B=128, T=192, E=64, H=8, F=256):
// 28.3 MFLOP per sample, 3.62 GFLOP per launch against 12.6 MB of x in and
// out, so the block is bound by f32 arithmetic (about 54 us at 67 TFLOP/s
// outside the tensor cores), not by memory (about 4 us at 3.35 TB/s).
//
// Design: one CTA per sample, every intermediate in shared memory (LN1
// output, Q, K, V, attention context, x1, LN2 output: about 200 KB at T=192),
// nothing but x and out touching device memory.  Each thread keeps one
// weight row in registers and streams the activation rows past it (reads
// that the whole warp broadcasts).  Each head's d=8 slice is computed
// directly: the TPU kernel's full-width masked head matmuls, which did eight
// times the attention arithmetic to suit a 128x128 matrix unit, are not
// carried over.  K and V rows are padded to E+1 floats so that the 32 lanes
// of a warp, each on its own key, hit 32 different banks.  The FFN walks
// the rows in chunks of 16 so the 256-wide hidden layer is never stored
// whole.  Tensor cores are not used: this first version runs in plain f32.

#include <cuda_runtime.h>
#include <math.h>

#include "block_common.cuh"
#include "drop.cuh"

namespace {

constexpr int NT = 256;     // threads per CTA (== F: one hidden unit each)
constexpr int NW = NT / 32; // warps per CTA
constexpr int R = 16;       // FFN row chunk
constexpr int KS = E + 1;   // padded row stride of K and V

static_assert(F == NT, "the FFN hidden phase maps one thread to one unit");
static_assert(3 * E <= NT, "the QKV phase maps one thread to one column");

__host__ __device__ inline size_t smem_floats(int T) {
  const size_t attn = 2 * (size_t)T * KS + (size_t)NW * T;  // K, V, scores
  const size_t ffn = (size_t)R * F + 4 * (size_t)R * E;      // hidden, partials
  return 2 * (size_t)T * E + (attn > ffn ? attn : ffn);
}

__global__ void __launch_bounds__(NT, 1)
fused_block_fwd_kernel(const float* __restrict__ x, float* __restrict__ out,
                       BlockParams P, int T, float inv_scale, DropCfg drop,
                       float* __restrict__ saved) {
  extern __shared__ __align__(16) float smem[];
  float* bufA = smem;              // [T][E]: LN1 out, then ctx, then LN2 out
  float* bufX = bufA + T * E;      // [T][E]: Q, then x1
  float* kbuf = bufX + T * E;      // [T][KS]
  float* vbuf = kbuf + T * KS;     // [T][KS]
  float* sc = vbuf + T * KS;       // [NW][T]: one score row per warp
  float* hbuf = kbuf;              // FFN: [R][F] hidden chunk
  float* part = kbuf + R * F;      // FFN: [4][R][E] partial outputs

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t base = (size_t)blockIdx.x * T * E;
  const float* __restrict__ xb = x + base;
  float* __restrict__ ob = out + base;
  const DropSample ds = drop_sample(drop, blockIdx.x, BLOCK_TILE_MULT);
  const size_t plane = (size_t)gridDim.x * T * E;  // one saved [B][T][E] plane
  const float *g1 = P.p[0], *be1 = P.p[1], *wq = P.p[2], *wk = P.p[3],
              *wv = P.p[4], *bq = P.p[5], *bk = P.p[6], *bv = P.p[7],
              *wo = P.p[8], *bo = P.p[9], *g2 = P.p[10], *be2 = P.p[11],
              *w1 = P.p[12], *bb1 = P.p[13], *w2 = P.p[14], *bb2 = P.p[15];

  // 1. LN1, a warp per row
  for (int t = warp; t < T; t += NW)
    layernorm_row(xb + (size_t)t * E, bufA + t * E, g1, be1, lane);
  __syncthreads();

  // 2. Q, K, V: thread = one output column of one of the three projections
  if (tid < 3 * E) {
    const int m = tid / E, o = tid % E;
    const float* W = m == 0 ? wq : (m == 1 ? wk : wv);
    const float bias = __ldg((m == 0 ? bq : (m == 1 ? bk : bv)) + o);
    float w[E];
    load_row<E>(W + o * E, w);
    float* dst = m == 0 ? bufX + o : (m == 1 ? kbuf : vbuf) + o;
    const int stride = m == 0 ? E : KS;
    for (int t = 0; t < T; ++t) dst[t * stride] = dot_row<E>(bufA + t * E, w) + bias;
  }
  __syncthreads();
  if (saved != nullptr) {  // q, k, v for the backward
    for (int i = tid; i < T * E; i += NT) {
      const int t = i / E, e = i % E;
      saved[base + i] = bufX[i];
      saved[plane + base + i] = kbuf[t * KS + e];
      saved[2 * plane + base + i] = vbuf[t * KS + e];
    }
  }

  // 3. attention: a warp per (query row, head); lanes walk the keys
  float* srow = sc + warp * T;
  for (int item = warp; item < T * H; item += NW) {
    const int t = item / H, h = item % H;
    float q[D];
#pragma unroll
    for (int d = 0; d < D; ++d) q[d] = bufX[t * E + h * D + d];
    float mx = -INFINITY;
    for (int j = lane; j < T; j += 32) {
      const float* kr = kbuf + j * KS + h * D;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) s = fmaf(q[d], kr[d], s);
      s *= inv_scale;
      srow[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    float acc[D];
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = 0.f;
    const uint32_t key = ds.seed_base + (uint32_t)h;
    const uint32_t idx0 = (uint32_t)(ds.local * T + t) * (uint32_t)T;
    for (int j = lane; j < T; j += 32) {
      float p = expf(srow[j] - mx);
      sum += p;  // the softmax normalises the clean probabilities
      if (drop.on) p *= drop_mult(key, idx0 + j, drop.thr, drop.keep);
      const float* vr = vbuf + j * KS + h * D;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vr[d], acc[d]);
    }
    sum = warp_sum(sum);
    float mine = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float a = warp_sum(acc[d]);
      if (lane == d) mine = a;
    }
    if (lane < D) bufA[t * E + h * D + lane] = mine / sum;
    if (saved != nullptr && lane == 0)  // the row's log-sum-exp: P = exp(s - lse)
      saved[5 * plane + ((size_t)blockIdx.x * H + h) * T + t] = mx + logf(sum);
  }
  __syncthreads();
  if (saved != nullptr)  // the attention context, after dropout
    for (int i = tid; i < T * E; i += NT) saved[3 * plane + base + i] = bufA[i];

  // 4. out-projection + residual: x1 = x + ctx Wo^T + bo, into bufX
  {
    const int o = tid % E, g = tid / E;
    float w[E];
    load_row<E>(wo + o * E, w);
    const float bias = __ldg(bo + o);
    const uint32_t key = ds.seed_base + (uint32_t)H;
    for (int t = g; t < T; t += NT / E) {
      float a = dot_row<E>(bufA + t * E, w) + bias;
      if (drop.on) a *= drop_mult(key, (uint32_t)(ds.local * T + t) * E + o, drop.thr, drop.keep);
      bufX[t * E + o] = xb[(size_t)t * E + o] + a;
    }
  }
  __syncthreads();
  if (saved != nullptr)  // x1
    for (int i = tid; i < T * E; i += NT) saved[4 * plane + base + i] = bufX[i];

  // 5. LN2, a warp per row
  for (int t = warp; t < T; t += NW)
    layernorm_row(bufX + t * E, bufA + t * E, g2, be2, lane);
  __syncthreads();

  // 6. FFN in row chunks: out = x1 + gelu(y2 W1^T + b1) W2^T + b2
  {
    float wa[E];  // W1 row of hidden unit tid
    load_row<E>(w1 + tid * E, wa);
    const float ba = __ldg(bb1 + tid);
    const int o = tid % E, g = tid / E;  // output column, quarter of F
    float wb[F / 4];
    load_row<F / 4>(w2 + o * F + g * (F / 4), wb);
    const uint32_t key_in = ds.seed_base + (uint32_t)(H + 1);
    const uint32_t key_out = ds.seed_base + (uint32_t)(H + 2);
    for (int c0 = 0; c0 < T; c0 += R) {
      const int nr = min(R, T - c0);
      for (int r = 0; r < nr; ++r) {
        float hv = gelu(dot_row<E>(bufA + (c0 + r) * E, wa) + ba);
        if (drop.on)
          hv *= drop_mult(key_in, (uint32_t)(ds.local * T + c0 + r) * F + tid,
                          drop.thr_ffn, drop.keep_ffn);
        hbuf[r * F + tid] = hv;
      }
      __syncthreads();
      for (int r = 0; r < nr; ++r)
        part[(g * R + r) * E + o] = dot_row<F / 4>(hbuf + r * F + g * (F / 4), wb);
      __syncthreads();
      for (int i = tid; i < nr * E; i += NT) {
        const int r = i / E, oc = i % E;
        const float f2 =
            (part[r * E + oc] + part[(R + r) * E + oc]) +
            (part[(2 * R + r) * E + oc] + part[(3 * R + r) * E + oc]);
        float fo = f2 + __ldg(bb2 + oc);
        if (drop.on)
          fo *= drop_mult(key_out, (uint32_t)(ds.local * T + c0 + r) * E + oc,
                          drop.thr, drop.keep);
        ob[(size_t)(c0 + r) * E + oc] = bufX[(c0 + r) * E + oc] + fo;
      }
      __syncthreads();
    }
  }
}

}  // namespace

// Launch on `stream`; returns the CUDA error code (0 on success).  The
// dropout arguments are those of DropCfg (drop.cuh); `saved` may be NULL.
extern "C" int tce_fused_block_fwd(const float* x, float* out,
                                   const void* const* params, int B, int T,
                                   int e, int h, int f, float inv_scale,
                                   int drop_on, unsigned seed, int tb,
                                   unsigned thr, float keep, unsigned thr_ffn,
                                   float keep_ffn, float* saved, void* stream) {
  if (e != E || h != H || f != F || B <= 0 || T <= 0 || tb <= 0)
    return (int)cudaErrorInvalidValue;
  const DropCfg drop{drop_on, seed, tb, thr, keep, thr_ffn, keep_ffn};
  BlockParams P;
  for (int i = 0; i < 16; ++i) P.p[i] = static_cast<const float*>(params[i]);
  const size_t bytes = smem_floats(T) * sizeof(float);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(fused_block_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  fused_block_fwd_kernel<<<B, NT, bytes, static_cast<cudaStream_t>(stream)>>>(
      x, out, P, T, inv_scale, drop, saved);
  return (int)cudaGetLastError();
}
