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
// 30 us at 3.35 TB/s; the real floor is the chain of 192 dependent steps,
// each a [B, H] x [H, 4H] product, the gate math and an exchange of h.
//
// Design (lstm_cluster.cuh): one thread-block cluster per (batch tile,
// direction).  At H=128 a cluster of 4 CTAs splits the hidden units 32 per
// CTA; each CTA keeps its [128 k x 128 gate columns] slice of whh in
// registers for all T steps (64 floats a thread, each slice held by two
// threads, so nothing of whh is read from memory in the step loop) and
// tiles 8 batch rows, giving 16 x 2 x 4 = 128 CTAs of 512 threads at
// B=128.  A step: every thread sums its 16 k of h_prev W for 4 rows x 4
// gates (256 FMAs, one shared-memory float4 per 16); the 8 lanes of a k
// group add their sums by shuffles, leaving 4 gates of one (row, unit) in
// its owner, which does the gate math with c in its registers; every 4th
// owner sends the h of 4 units into the h buffer of every CTA of the
// cluster (16-byte st.async into distributed shared memory, counted on the
// receiver's mbarrier), double-buffered by step parity.  The next step's xw
// is loaded a step ahead.  No atomics: the same inputs give the same bits.

#include <cuda_runtime.h>
#include <math.h>

#include "lstm_cluster.cuh"

namespace {

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <int H>
__global__ void __launch_bounds__(lstm::threads<H>())
lstm_fwd_cluster(const float* __restrict__ xw, const float* __restrict__ whh,
                 float* __restrict__ h_out, float* __restrict__ c_out,
                 float* __restrict__ gates_out, int T, int D, int B, int U) {
  using S = lstm::Fwd<H>;
  constexpr int NT = S::NT, KPT = S::KPT, KG = S::KG, RPT = S::RPT, G = 4 * H;
  constexpr int FULL = KG * S::KEEP / S::NV;  // lanes left with the same sums
  static_assert(S::NV / S::KEEP <= KG && 4 * KG <= 32, "a group's rows fit its lanes");
  extern __shared__ float4 smem4[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem4);        // [EG][2]: h arrived
  float* hbuf = reinterpret_cast<float*>(smem4 + lstm::EG);  // [2][BT][H]: h_prev, by parity
  const int N = H / U;
  const int BT = lstm::OWNERS / U;
  const int n = blockIdx.x % N;  // rank in the cluster
  const int tile = blockIdx.x / N;
  const int d = blockIdx.y;
  const int tid = threadIdx.x;
  // this thread's exchange group: its rows' h arrive on gbar
  const int eg = tid / (NT / lstm::EG);
  uint64_t* gbar = bar + 2 * eg;
  const uint32_t h_bytes = (uint32_t)(BT / lstm::EG * H * sizeof(float));

  // product role: k group kg (the low lane bits), unit u, rows prg * RPT ..
  const int kg = tid % KG, u = (tid / KG) % U, prg = tid / (KG * U);
  // owner role: the row whose 4 gates this thread keeps after group_sum
  const int orow = prg * RPT + lstm::group_offset<KG / 2, S::NV, S::KEEP>(kg) / 4;
  const bool owner = kg % FULL == 0;
  const int j = n * U + u;
  const int b = tile * BT + orow;
  const bool valid = owner && b < B;

  float w[KPT / 4][4][4];  // whh[k][g H + j], k = 4 KG i + 4 kg + q
  {
    const float* W = whh + (size_t)d * H * G + j;
#pragma unroll
    for (int i = 0; i < KPT / 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int g = 0; g < 4; ++g)
          w[i][q][g] = __ldg(W + (size_t)(4 * KG * i + 4 * kg + q) * G + g * H);
  }
  for (int i = tid; i < BT * H; i += NT) hbuf[i] = 0.f;  // h of step -1
  // gbar[1] counts the group's h of the steps t = 1, 3, ..., gbar[0] of
  // t = 2, 4, ...; the group's first thread arms them
  if (N > 1 && tid % (NT / lstm::EG) == 0) {
    lstm::mbar_init(&gbar[0]);
    lstm::mbar_init(&gbar[1]);
    lstm::fence_mbar_init();
    if (T > 1) lstm::mbar_expect(&gbar[1], h_bytes);
    if (T > 2) lstm::mbar_expect(&gbar[0], h_bytes);
  }

  float xc[4] = {0.f, 0.f, 0.f, 0.f};
  if (valid) {
    const float* xr = xw + ((size_t)d * B + b) * G + j;
#pragma unroll
    for (int g = 0; g < 4; ++g) xc[g] = __ldg(xr + g * H);
  }
  float c = 0.f;
  lstm::cluster_sync();  // every CTA of the cluster runs, its mbarriers armed

  for (int t = 0; t < T; ++t) {
    float xn[4] = {0.f, 0.f, 0.f, 0.f};  // next step's xw, in flight during this one
    if (valid && t + 1 < T) {
      const float* xr = xw + (((size_t)(t + 1) * D + d) * B + b) * G + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) xn[g] = __ldg(xr + g * H);
    }
    if (N > 1 && t > 0) {  // the group's h of step t-1 from every CTA of the cluster
      lstm::mbar_wait(&gbar[t & 1], ((t - 1) >> 1) & 1);
      if (tid % (NT / lstm::EG) == 0 && t + 2 < T) lstm::mbar_expect(&gbar[t & 1], h_bytes);
    }
    const float* hb = hbuf + (t & 1) * BT * H + prg * RPT * H + 4 * kg;

    float acc[S::NV];  // [RPT rows][4 gates]
#pragma unroll
    for (int v = 0; v < S::NV; ++v) acc[v] = 0.f;
#pragma unroll
    for (int i = 0; i < KPT / 4; ++i) {
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float4 hv = *reinterpret_cast<const float4*>(hb + r * H + 4 * KG * i);
        const float hk[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int g = 0; g < 4; ++g) acc[4 * r + g] = fmaf(hk[q], w[i][q][g], acc[4 * r + g]);
      }
    }
    lstm::group_sum<KG / 2, S::NV, S::KEEP>(acc, kg);  // acc[0..4): the row's gates

    const float ig = sigmoidf(xc[0] + acc[0]);
    const float fg = sigmoidf(xc[1] + acc[1]);
    const float gg = tanhf(xc[2] + acc[2]);
    const float og = sigmoidf(xc[3] + acc[3]);
    c = fg * c + ig * gg;
    const float h = og * tanhf(c);
    // h into the next step's buffer of every CTA of the cluster, this one
    // too; the last step's h is not needed there
    if (t + 1 < T) {
      const float hv = valid ? h : 0.f;
      float* slot = hbuf + ((t + 1) & 1) * BT * H + orow * H + j;
      if (N == 1) {
        if (owner) *slot = hv;
      } else {  // the owner of every 4th unit sends the h of 4 units
        const int lane0 = (tid & 31) - KG * (u & 3);
        const float4 h4 = make_float4(__shfl_sync(0xffffffffu, hv, lane0),
                                      __shfl_sync(0xffffffffu, hv, lane0 + KG),
                                      __shfl_sync(0xffffffffu, hv, lane0 + 2 * KG),
                                      __shfl_sync(0xffffffffu, hv, lane0 + 3 * KG));
        if (owner && (u & 3) == 0) lstm::send_all(slot, &gbar[(t + 1) & 1], h4, N);
      }
    }
    if (valid) {
      const size_t o = (((size_t)t * D + d) * B + b) * H + j;
      h_out[o] = h;
      if (c_out != nullptr) c_out[o] = c;
      if (gates_out != nullptr) {
        float* gr = gates_out + (((size_t)t * D + d) * B + b) * G + j;
        gr[0] = ig;
        gr[H] = fg;
        gr[2 * H] = gg;
        gr[3 * H] = og;
      }
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) xc[g] = xn[g];
    if (N == 1) __syncthreads();  // a cluster of one CTA: the block barrier is the exchange
  }
  // no CTA leaves while a store of the cluster into shared memory may be in
  // flight (the waits cover what arrives here, not what this CTA sent)
  if (N > 1) lstm::cluster_sync();
}

template <int H>
int launch(const float* xw, const float* whh, float* h_out, float* c_out, float* gates_out,
           int T, int D, int B, int n, int bt, int threads, long long smem,
           cudaStream_t stream) {
  using S = lstm::Fwd<H>;
  const int units = lstm::plan_units(H, n, bt, threads, S::NT, S::RPT);
  if (units == 0 || smem < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(((B + bt - 1) / bt) * n, D);
  return lstm::launch_clusters(lstm_fwd_cluster<H>, grid, S::NT, n, (size_t)smem,
                               lstm::fwd_smem_bytes(H, bt), stream,
                               xw, whh, h_out, c_out, gates_out, T, D, B, units);
}

}  // namespace

// Launch on `stream`; returns the CUDA error code (0 on success).  `c_out`
// and `gates_out` may be NULL.  H is 4, 8, 16, 32, 64 or 128; (n, bt,
// threads, smem) is the plan of lstm_launch_plan in ops/lstm_scan.py:
// clusters of n CTAs, bt batch rows each, `smem` bytes of shared memory.
extern "C" int tce_lstm_scan_fwd(const float* xw, const float* whh, float* h_out,
                                 float* c_out, float* gates_out, int T, int D, int B, int H,
                                 int n, int bt, int threads, long long smem, void* stream) {
  if (T <= 0 || D <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TCE_LSTM_FWD(HH)                                                              \
  case HH:                                                                            \
    return launch<HH>(xw, whh, h_out, c_out, gates_out, T, D, B, n, bt, threads, smem, s);
  switch (H) {
    TCE_LSTM_FWD(4)
    TCE_LSTM_FWD(8)
    TCE_LSTM_FWD(16)
    TCE_LSTM_FWD(32)
    TCE_LSTM_FWD(64)
    TCE_LSTM_FWD(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TCE_LSTM_FWD
}
