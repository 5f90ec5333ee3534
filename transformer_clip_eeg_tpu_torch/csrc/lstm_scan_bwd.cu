// LSTM recurrence, backward (BPTT), f32, several independent recurrences per
// launch.
//
// Replaces: transformer_clip_eeg_tpu/ops/pallas_lstm.py, _lstm_bwd
// (pl.pallas_call at :290; kernel body _bwd_kernel :96-154).
//
// Computes, for the upstream gradient g [T, D, B, H] of h, from a zero
// initial state, in reverse time (gate order i, f, g, o):
//   dh = g[t] + dh';  do = dh tanh(c);  dc = dh o (1 - tanh(c)^2) + dc'
//   di = dc g;  dg = dc i;  df = dc c_prev;  dc' = dc f
//   dpre = [di i(1-i), df f(1-f), dg (1-g^2), do o(1-o)]  ->  dxw[t]
//   dh' = dpre whh^T
// and dwhh[d] = sum over t, b of h_prev^T dpre (h_prev = 0 at t = 0).
//
// Bound on an H100 at the flagship's H=128 layer (T=192, D=2, B=128): 6.4
// GFLOP for dpre whh^T and 6.4 for dwhh, about 0.19 ms at 67 TFLOP/s f32;
// about 0.3 GB of gates, states, g and dxw (0.09 ms at 3.35 TB/s).  As in
// the forward, the real floor is the chain of 192 dependent steps.
//
// Design.  The TPU kernel recomputes the gates from (xw, h_prev) and carries
// dwhh across its sequential grid.  Here the training forward wrote the
// activated gates (lstm_scan.cu, gates_out), so each step reads them instead
// of redoing the xw + h whh product, and the recurrence kernel carries only
// dh (shared memory) and dc (registers).  Its layout is the forward's: one
// CTA per (batch tile, direction), a thread per hidden unit and RPT batch
// rows.  dh' = dpre whh^T reads whh^T [4H][H] (transposed once by the
// wrapper, so neighbouring threads read neighbouring floats); at H=128 it is
// 256 KB, so the first KS rows are staged in shared memory and the rest are
// read from L2 every step, as in the forward.  dwhh is a separate reduction
// over the T*B rows of each direction (wgrad.cuh): per-chunk partial sums,
// then a fixed-order sum, no atomics.

#include <cuda_runtime.h>
#include <math.h>

#include "wgrad.cuh"

namespace {

constexpr int NT = 128;  // threads per CTA

template <int RPT>
__global__ void __launch_bounds__(NT)
lstm_bwd_kernel(const float* __restrict__ gates, const float* __restrict__ whh_t,
                const float* __restrict__ c_all, const float* __restrict__ g_h,
                float* __restrict__ dxw, int T, int D, int B, int H, int KS) {
  extern __shared__ __align__(16) float smem[];
  const int G = 4 * H;
  const int RG = NT / H;    // row groups
  const int BT = RG * RPT;  // batch rows per CTA
  const int d = blockIdx.y;
  const int j = threadIdx.x % H;
  const int rg = threadIdx.x / H;
  float* dh_s = smem;            // [BT][H]: dh carried from step t+1
  float* dp_s = dh_s + BT * H;   // [BT][G]: this step's dpre
  float* w_s = dp_s + BT * G;    // [KS][H]: rows n < KS of this direction's whh^T
  const float* __restrict__ WT = whh_t + (size_t)d * G * H;

  for (int i = threadIdx.x; i < KS * H; i += NT) w_s[i] = WT[i];
  for (int i = threadIdx.x; i < BT * H; i += NT) dh_s[i] = 0.f;

  int lr[RPT];
  bool valid[RPT];
  size_t brow[RPT];
  float dc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    lr[r] = rg + r * RG;
    const int b = blockIdx.x * BT + lr[r];
    valid[r] = b < B;
    brow[r] = valid[r] ? (size_t)b : 0;
    dc[r] = 0.f;
  }
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    const size_t row0 = ((size_t)t * D + d) * B;
    const size_t prow0 = ((size_t)(t > 0 ? t - 1 : 0) * D + d) * B;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      float dp[4] = {0.f, 0.f, 0.f, 0.f};
      if (valid[r]) {
        const float* gr = gates + (row0 + brow[r]) * G + j;
        const float ig = __ldg(gr), fg = __ldg(gr + H), gg = __ldg(gr + 2 * H),
                    og = __ldg(gr + 3 * H);
        const size_t hi = (row0 + brow[r]) * H + j;
        const float c = __ldg(c_all + hi);
        const float c_prev = t > 0 ? __ldg(c_all + (prow0 + brow[r]) * H + j) : 0.f;
        const float dh = __ldg(g_h + hi) + dh_s[lr[r] * H + j];
        const float tc = tanhf(c);
        const float dout = dh * tc;
        const float dcv = dh * og * (1.0f - tc * tc) + dc[r];
        dc[r] = dcv * fg;
        dp[0] = (dcv * gg) * ig * (1.0f - ig);
        dp[1] = (dcv * c_prev) * fg * (1.0f - fg);
        dp[2] = (dcv * ig) * (1.0f - gg * gg);
        dp[3] = dout * og * (1.0f - og);
        float* out = dxw + (row0 + brow[r]) * G + j;
#pragma unroll
        for (int q = 0; q < 4; ++q) out[q * H] = dp[q];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) dp_s[lr[r] * G + q * H + j] = dp[q];
    }
    __syncthreads();  // dpre of step t complete; dh_s of step t+1 read

    // dh' = dpre whh^T: unit j of each row, over the 4H gate columns
    float acc[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) acc[r] = 0.f;
    for (int n = 0; n < G; ++n) {
      const float w = n < KS ? w_s[n * H + j] : __ldg(WT + (size_t)n * H + j);
#pragma unroll
      for (int r = 0; r < RPT; ++r) acc[r] = fmaf(dp_s[lr[r] * G + n], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) dh_s[lr[r] * H + j] = acc[r];
    __syncthreads();  // dh' complete, dp_s free for the next step
  }
}

template <int RPT>
int launch(const float* gates, const float* whh_t, const float* c, const float* g,
           float* dxw, int T, int D, int B, int H, cudaStream_t stream) {
  const int BT = (NT / H) * RPT;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t fixed = (size_t)BT * 5 * H * sizeof(float);  // dh_s and dp_s
  const size_t row_bytes = (size_t)H * sizeof(float);
  if (fixed > (size_t)optin) return (int)cudaErrorInvalidValue;
  long ks = (long)(((size_t)optin - fixed) / row_bytes);
  if (ks > 4 * H) ks = 4 * H;
  const size_t bytes = fixed + (size_t)ks * row_bytes;
  err = cudaFuncSetAttribute(lstm_bwd_kernel<RPT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + BT - 1) / BT, D);
  lstm_bwd_kernel<RPT><<<grid, NT, bytes, stream>>>(gates, whh_t, c, g, dxw, T, D, B, H,
                                                    (int)ks);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of workspace tce_lstm_scan_bwd needs (the dwhh partial sums).
extern "C" long long tce_lstm_scan_bwd_workspace(int T, int D, int B, int H) {
  (void)D;
  return (long long)wgrad::atb_workspace(H, 4 * H, T > 1 ? (T - 1) * B : 0);
}

// Launch on `stream`; returns the CUDA error code (0 on success).
//   gates [T][D][B][4H] (activated i, f, g, o from the training forward),
//   whh_t [D][4H][H] (whh transposed), h, c, g [T][D][B][H];
//   out: dxw [T][D][B][4H], dwhh [D][H][4H]; ws: the workspace above.
// H must be a multiple of 4 that divides 128.
extern "C" int tce_lstm_scan_bwd(const float* gates, const float* whh_t, const float* h,
                                 const float* c, const float* g, float* dxw, float* dwhh,
                                 float* ws, int T, int D, int B, int H, void* stream) {
  if (T <= 0 || D <= 0 || B <= 0 || H < 4 || H > NT || NT % H != 0 || H % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = H >= 32 ? launch<4>(gates, whh_t, c, g, dxw, T, D, B, H, s)
                         : launch<1>(gates, whh_t, c, g, dxw, T, D, B, H, s);
  if (rc != 0) return rc;
  const int G = 4 * H;
  // dwhh[d] = sum over t >= 1 and b of h[t-1, d, b]^T dxw[t, d, b]
  for (int d = 0; d < D; ++d) {
    const wgrad::Rows hp{h + (size_t)d * B * H, B, (long long)D * B * H, H};
    const wgrad::Rows dp{dxw + ((size_t)D + d) * B * G, B, (long long)D * B * G, G};
    const cudaError_t err = wgrad::atb(hp, dp, H, G, T > 1 ? (T - 1) * B : 0,
                                       dwhh + (size_t)d * H * G, ws, s);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
