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
// of redoing the xw + h whh product.  The recurrence runs as the forward
// does (lstm_cluster.cuh): one thread-block cluster per (batch tile,
// direction), at H=128 4 CTAs of 32 units and 8 batch rows each, 128 CTAs
// of 512 threads at B=128.  A CTA keeps the [512 gate columns x 32 units]
// slice of whh^T in registers (4 units x 16 columns, 64 floats a thread,
// each held by two threads), so nothing of whh is read from memory in the
// step loop.  A step: the owner of each (row, unit) computes its four dpre
// from the saved gates, c, c_prev and g (loaded one step ahead, while the
// previous step ran), writes them to dxw and sends them, one 16-byte
// st.async, into the dpre buffer of every CTA of the cluster (distributed
// shared memory, counted on the receiver's mbarrier, double-buffered by
// step parity; the buffer keeps a unit's four gates side by side and the
// weights are loaded in that column order); once the CTA's buffer is
// complete every thread sums its column group of dpre whh^T for 4 rows x 4
// units (256 FMAs), and the 32 lanes of a warp, one column group each, add
// their sums by shuffles into the owners, which keep dh' and dc in
// registers.  dwhh is a separate reduction over the T*B rows
// (wgrad.cuh, tce_lstm_dwhh): the directions' products as one launch of
// per-chunk partial sums, then one launch of fixed-order sums.  No atomics
// anywhere: the same inputs give the same bits.

#include <cuda_runtime.h>
#include <math.h>

#include "lstm_cluster.cuh"
#include "wgrad.cuh"

namespace {

// The saved forward values the owner of (row b, unit j) reads at step t.
struct StepIn {
  float ig, fg, gg, og, c_prev, gh;
};

__device__ __forceinline__ StepIn load_step(const float* __restrict__ gates,
                                            const float* __restrict__ c_all,
                                            const float* __restrict__ g_h, int t, int D, int B,
                                            int H, int d, int b, int j) {
  const size_t row = ((size_t)t * D + d) * B + b;
  const float* gr = gates + row * 4 * H + j;
  StepIn s;
  s.ig = __ldg(gr);
  s.fg = __ldg(gr + H);
  s.gg = __ldg(gr + 2 * H);
  s.og = __ldg(gr + 3 * H);
  s.gh = __ldg(g_h + row * H + j);
  s.c_prev = t > 0 ? __ldg(c_all + (((size_t)(t - 1) * D + d) * B + b) * H + j) : 0.f;
  return s;
}

template <int H>
__global__ void __launch_bounds__(lstm::threads<H>())
lstm_bwd_cluster(const float* __restrict__ gates, const float* __restrict__ whh,
                 const float* __restrict__ c_all, const float* __restrict__ g_h,
                 float* __restrict__ dxw, int T, int D, int B, int U) {
  using S = lstm::Bwd<H>;
  constexpr int UPT = S::UPT, CPT = S::CPT, KG = S::KG, RPT = S::RPT, G = 4 * H;
  constexpr int FULL = KG * S::KEEP / S::NV;  // lanes left with the same sum
  static_assert(S::NV / S::KEEP <= KG && KG <= 32, "a group's values fit its lanes");
  extern __shared__ float4 smem4[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem4);  // [EG][2]: dpre arrived
  // [2][BT][H][4]: dpre by parity, the 4 gates of a unit side by side, so
  // that column 4 jj + g of a row is gate g of unit jj
  float* dpbuf = reinterpret_cast<float*>(smem4 + lstm::EG);
  const int N = H / U;
  const int BT = lstm::OWNERS / U;
  const int UG = U / UPT;
  const int n = blockIdx.x % N;  // rank in the cluster
  const int tile = blockIdx.x / N;
  const int d = blockIdx.y;
  const int tid = threadIdx.x;
  // this thread's exchange group: its rows' dpre arrive on gbar
  const int eg = tid / (S::NT / lstm::EG);
  uint64_t* gbar = bar + 2 * eg;
  const uint32_t dp_bytes = (uint32_t)(BT / lstm::EG * G * sizeof(float));

  // product role: column group kg (the low lane bits), units ug * UPT ..,
  // rows prg * RPT ..
  const int kg = tid % KG, ug = (tid / KG) % UG, prg = tid / (KG * UG);
  // owner role: the (row, unit) whose sum this thread keeps after group_sum
  const int kept = lstm::group_offset<KG / 2, S::NV, S::KEEP>(kg);
  const int orow = prg * RPT + kept / UPT;
  const bool owner = kg % FULL == 0;
  const int j = n * U + ug * UPT + kept % UPT;
  const int b = tile * BT + orow;
  const bool valid = owner && b < B;

  // whh^T[col][unit] = whh[unit][q H + jj] for the dpbuf column
  // col = 4 jj + q, jj = KG i + kg
  float w[UPT][CPT / 4][4];
  {
    const float* W = whh + ((size_t)d * H + n * U + ug * UPT) * G + kg;
#pragma unroll
    for (int uu = 0; uu < UPT; ++uu)
#pragma unroll
      for (int i = 0; i < CPT / 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) w[uu][i][q] = __ldg(W + (size_t)uu * G + q * H + KG * i);
  }
  // step it = T-1-t of the loop: gbar[0] counts the group's dpre of it = 0,
  // 2, ..., gbar[1] of it = 1, 3, ...; the last step's dpre is not
  // exchanged.  The group's first thread arms them
  if (N > 1 && tid % (S::NT / lstm::EG) == 0) {
    lstm::mbar_init(&gbar[0]);
    lstm::mbar_init(&gbar[1]);
    lstm::fence_mbar_init();
    if (T > 1) lstm::mbar_expect(&gbar[0], dp_bytes);
    if (T > 2) lstm::mbar_expect(&gbar[1], dp_bytes);
  }

  StepIn cur{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float c = 0.f;  // c at the current step
  if (valid) {
    cur = load_step(gates, c_all, g_h, T - 1, D, B, H, d, b, j);
    c = __ldg(c_all + (((size_t)(T - 1) * D + d) * B + b) * H + j);
  }
  float dc = 0.f, dhn = 0.f;  // carried from step t+1: dc' and dh'
  lstm::cluster_sync();  // every CTA of the cluster runs, its mbarriers armed

  for (int t = T - 1, it = 0; t >= 0; --t, ++it) {
    StepIn nxt{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // step t-1, in flight during this one
    if (valid && t > 0) nxt = load_step(gates, c_all, g_h, t - 1, D, B, H, d, b, j);

    const float dh = cur.gh + dhn;
    const float tc = tanhf(c);
    const float dout = dh * tc;
    const float dcv = dh * cur.og * (1.0f - tc * tc) + dc;
    dc = dcv * cur.fg;
    float dp[4];
    dp[0] = (dcv * cur.gg) * cur.ig * (1.0f - cur.ig);
    dp[1] = (dcv * cur.c_prev) * cur.fg * (1.0f - cur.fg);
    dp[2] = (dcv * cur.ig) * (1.0f - cur.gg * cur.gg);
    dp[3] = dout * cur.og * (1.0f - cur.og);
    if (owner && t > 0) {
      // dpre of step t into every CTA of the cluster, this one too (zeros
      // for rows past B: their operands are zero)
      float* slot = dpbuf + (it & 1) * BT * G + orow * G + 4 * j;
      const float4 dp4 = make_float4(dp[0], dp[1], dp[2], dp[3]);
      if (N > 1)
        lstm::send_all(slot, &gbar[it & 1], dp4, N);
      else
        *reinterpret_cast<float4*>(slot) = dp4;
    }
    if (valid) {
      float* out = dxw + (((size_t)t * D + d) * B + b) * G + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) out[q * H] = dp[q];
    }
    if (t == 0) break;  // dh' of step 0 is not needed
    if (N > 1) {
      lstm::mbar_wait(&gbar[it & 1], (it >> 1) & 1);
      if (tid % (S::NT / lstm::EG) == 0 && it + 3 < T) lstm::mbar_expect(&gbar[it & 1], dp_bytes);
    } else {
      __syncthreads();  // a cluster of one CTA: the block barrier is the exchange
    }

    // dh' = dpre whh^T: this thread's column group, RPT rows x UPT units
    const float* dpb = dpbuf + (it & 1) * BT * G + prg * RPT * G + 4 * kg;
    float acc[S::NV];  // [RPT rows][UPT units]
#pragma unroll
    for (int v = 0; v < S::NV; ++v) acc[v] = 0.f;
#pragma unroll
    for (int i = 0; i < CPT / 4; ++i) {
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float4 pv = *reinterpret_cast<const float4*>(dpb + r * G + 4 * KG * i);
        const float pk[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int uu = 0; uu < UPT; ++uu)
            acc[UPT * r + uu] = fmaf(pk[q], w[uu][i][q], acc[UPT * r + uu]);
      }
    }
    lstm::group_sum<KG / 2, S::NV, S::KEEP>(acc, kg);
    dhn = acc[0];
    c = cur.c_prev;
    cur = nxt;
  }
  // no CTA leaves while a store of the cluster into shared memory may be in
  // flight (the waits cover what arrives here, not what this CTA sent)
  if (N > 1) lstm::cluster_sync();
}

template <int H>
int launch(const float* gates, const float* whh, const float* c, const float* g, float* dxw,
           int T, int D, int B, int n, int bt, int threads, long long smem,
           cudaStream_t stream) {
  using S = lstm::Bwd<H>;
  const int units = lstm::plan_units(H, n, bt, threads, S::NT, S::RPT);
  if (units == 0 || smem < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(((B + bt - 1) / bt) * n, D);
  return lstm::launch_clusters(lstm_bwd_cluster<H>, grid, S::NT, n, (size_t)smem,
                               lstm::bwd_smem_bytes(H, bt), stream,
                               gates, whh, c, g, dxw, T, D, B, units);
}

}  // namespace

// The recurrence: launch on `stream`; returns the CUDA error code (0 on
// success).  gates [T][D][B][4H] (activated i, f, g, o from the training
// forward), whh [D][H][4H], c, g [T][D][B][H]; out: dxw [T][D][B][4H].  H
// is 4, 8, 16, 32, 64 or 128; (n, bt, threads, smem) is the plan of
// lstm_launch_plan in ops/lstm_scan.py.
extern "C" int tce_lstm_scan_bwd(const float* gates, const float* whh, const float* c,
                                 const float* g, float* dxw, int T, int D, int B, int H,
                                 int n, int bt, int threads, long long smem, void* stream) {
  if (T <= 0 || D <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TCE_LSTM_BWD(HH) \
  case HH:               \
    return launch<HH>(gates, whh, c, g, dxw, T, D, B, n, bt, threads, smem, s);
  switch (H) {
    TCE_LSTM_BWD(4)
    TCE_LSTM_BWD(8)
    TCE_LSTM_BWD(16)
    TCE_LSTM_BWD(32)
    TCE_LSTM_BWD(64)
    TCE_LSTM_BWD(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TCE_LSTM_BWD
}

// Floats of workspace tce_lstm_dwhh needs (the partial sums).
extern "C" long long tce_lstm_dwhh_workspace(int T, int D, int B, int H) {
  return (long long)D * (long long)wgrad::workspace(H, 4 * H, T > 1 ? (T - 1) * B : 0);
}

// dwhh[d] = sum over t >= 1 and b of h[t-1, d, b]^T dxw[t, d, b], in a fixed
// order: h [T][D][B][H], dxw [T][D][B][4H]; out dwhh [D][H][4H]; ws: the
// workspace above.  The D products are one launch and their sums another
// (per wgrad::MAX_JOBS directions).  Returns the CUDA error code (0 on
// success); H must be a multiple of 4 and the tensors 16-byte aligned.
extern "C" int tce_lstm_dwhh(const float* h, const float* dxw, float* dwhh, float* ws,
                             int T, int D, int B, int H, void* stream) {
  if (T <= 0 || D <= 0 || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = 4 * H, K = T > 1 ? (T - 1) * B : 0;
  for (int d0 = 0; d0 < D; d0 += wgrad::MAX_JOBS) {
    wgrad::Plan plan;
    for (int d = d0; d < D && d < d0 + wgrad::MAX_JOBS; ++d) {
      const wgrad::Rows hp{h + (size_t)d * B * H, B, (long long)D * B * H, H};
      const wgrad::Rows dp{dxw + ((size_t)D + d) * B * G, B, (long long)D * B * G, G};
      if (!plan.add_product(hp, dp, H, G, K, dwhh + (size_t)d * H * G, ws))
        return (int)cudaErrorInvalidValue;
    }
    cudaError_t err = plan.launch_products(s);
    if (err == cudaSuccess) err = plan.launch_sums(s);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
