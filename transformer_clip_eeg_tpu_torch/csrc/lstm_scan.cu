// LSTM recurrence, forward, f32, several independent recurrences per launch.
//
// Replaces: transformer_clip_eeg_tpu/ops/pallas_lstm.py, _lstm_fwd
// (pl.pallas_call at :219; kernel body _fwd_kernel :69), in its packed form
// lstm_scan_pallas_packed.
//
// Computes, for precomputed gate inputs xw [T, D, B, 4H] (x W_ih^T + both
// biases) and recurrent weights whh [D, H, 4H], from a zero state:
//   pre = xw[t, d] + h W;  i, f, o = sigmoid;  g = tanh   (torch order i,f,g,o)
//   c = f c + i g;  h = o tanh(c);  h_out[t, d] = h   (c_out too, if asked)
// and, when gates_out is not NULL (training), the activated gates i, f, g, o
// laid out as xw, which the backward (lstm_scan_bwd.cu) reads.
//
// Bound on an H100 at the flagship's H=128 layer (T=192, D=2, B=128):
// 6.4 GFLOP, about 96 us at 67 TFLOP/s in f32, and 100 MB of xw, about
// 30 us at 3.35 TB/s; the real floor is the chain of 192 dependent steps.
//
// Design: one CTA per (batch tile, direction); both directions of a biLSTM
// run at once, each on its own CTAs.  A thread owns one hidden unit and
// RPT batch rows: it computes that unit's four gates, so c stays in its
// registers and only h is exchanged, through shared memory, once a step.
// At H=128 whh is 256 KB, more than the 227 KB a CTA can hold: the first
// KS rows of whh are staged in shared memory once, the rest are read from
// L2 every step.  Batch tile 4 at H=128 balances the per-step arithmetic
// (4 x 128 x 512 FMAs) against the per-step weight reads, and gives 64 CTAs.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 128;  // threads per CTA

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <int RPT>
__global__ void __launch_bounds__(NT)
lstm_fwd_kernel(const float* __restrict__ xw, const float* __restrict__ whh,
                float* __restrict__ h_out, float* __restrict__ c_out,
                float* __restrict__ gates_out, int T, int D, int B, int H, int KS) {
  extern __shared__ __align__(16) float smem[];
  const int G = 4 * H;
  const int RG = NT / H;   // row groups
  const int BT = RG * RPT; // batch rows per CTA
  const int d = blockIdx.y;
  const int j = threadIdx.x % H;
  const int rg = threadIdx.x / H;
  float* h_s = smem;           // [BT][H]: h of the previous step
  float* w_s = smem + BT * H;  // [KS][G]: rows k < KS of this direction's whh
  const float* __restrict__ W = whh + (size_t)d * H * G;

  for (int i = threadIdx.x; i < KS * G; i += NT) w_s[i] = W[i];
  for (int i = threadIdx.x; i < BT * H; i += NT) h_s[i] = 0.f;

  int lr[RPT];      // local row in the tile
  bool valid[RPT];  // row < B
  size_t brow[RPT]; // global batch row
  float c[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    lr[r] = rg + r * RG;
    const int b = blockIdx.x * BT + lr[r];
    valid[r] = b < B;
    brow[r] = valid[r] ? (size_t)b : 0;
    c[r] = 0.f;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const size_t row0 = ((size_t)t * D + d) * B;
    float xv[RPT][4];  // issued early, consumed after the matmul
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float* xr = xw + (row0 + brow[r]) * G + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) xv[r][g] = valid[r] ? __ldg(xr + g * H) : 0.f;
    }
    float acc[RPT][4];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[r][g] = 0.f;

    // h W over k, four k at a time (H % 4 == 0, KS % 4 == 0)
    for (int k = 0; k < H; k += 4) {
      float4 hv[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        hv[r] = *reinterpret_cast<const float4*>(h_s + lr[r] * H + k);
      const bool staged = k < KS;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float w[4];
        if (staged) {
          const float* wr = w_s + (k + kk) * G + j;
#pragma unroll
          for (int g = 0; g < 4; ++g) w[g] = wr[g * H];
        } else {
          const float* wr = W + (size_t)(k + kk) * G + j;
#pragma unroll
          for (int g = 0; g < 4; ++g) w[g] = __ldg(wr + g * H);
        }
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const float hk = kk == 0 ? hv[r].x : kk == 1 ? hv[r].y : kk == 2 ? hv[r].z : hv[r].w;
#pragma unroll
          for (int g = 0; g < 4; ++g) acc[r][g] = fmaf(hk, w[g], acc[r][g]);
        }
      }
    }
    __syncthreads();  // every thread has read h of step t-1

#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float ig = sigmoidf(xv[r][0] + acc[r][0]);
      const float fg = sigmoidf(xv[r][1] + acc[r][1]);
      const float gg = tanhf(xv[r][2] + acc[r][2]);
      const float og = sigmoidf(xv[r][3] + acc[r][3]);
      c[r] = fg * c[r] + ig * gg;
      const float h = og * tanhf(c[r]);
      h_s[lr[r] * H + j] = valid[r] ? h : 0.f;
      if (valid[r]) {
        const size_t o = (row0 + brow[r]) * H + j;
        h_out[o] = h;
        if (c_out != nullptr) c_out[o] = c[r];
        if (gates_out != nullptr) {
          float* gr = gates_out + (row0 + brow[r]) * G + j;
          gr[0] = ig;
          gr[H] = fg;
          gr[2 * H] = gg;
          gr[3 * H] = og;
        }
      }
    }
    __syncthreads();  // h of step t is complete
  }
}

template <int RPT>
int launch(const float* xw, const float* whh, float* h_out, float* c_out,
           float* gates_out, int T, int D, int B, int H, cudaStream_t stream) {
  const int BT = (NT / H) * RPT;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t h_bytes = (size_t)BT * H * sizeof(float);
  const size_t row_bytes = (size_t)4 * H * sizeof(float);
  if (h_bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  long ks = (long)(((size_t)optin - h_bytes) / row_bytes);
  if (ks > H) ks = H;
  ks -= ks % 4;
  const size_t bytes = h_bytes + (size_t)ks * row_bytes;
  err = cudaFuncSetAttribute(lstm_fwd_kernel<RPT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + BT - 1) / BT, D);
  lstm_fwd_kernel<RPT><<<grid, NT, bytes, stream>>>(xw, whh, h_out, c_out,
                                                    gates_out, T, D, B, H, (int)ks);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns the CUDA error code (0 on success).  `c_out`
// and `gates_out` may be NULL.  H must be a multiple of 4 that divides 128.
extern "C" int tce_lstm_scan_fwd(const float* xw, const float* whh,
                                 float* h_out, float* c_out, float* gates_out,
                                 int T, int D, int B, int H, void* stream) {
  if (T <= 0 || D <= 0 || B <= 0 || H < 4 || H > NT || NT % H != 0 || H % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H >= 32) return launch<4>(xw, whh, h_out, c_out, gates_out, T, D, B, H, s);
  return launch<1>(xw, whh, h_out, c_out, gates_out, T, D, B, H, s);
}
