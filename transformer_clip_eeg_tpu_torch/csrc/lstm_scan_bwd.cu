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
// anywhere: the same inputs give the same bits.  At H=256 (lstm_bwd_mid,
// lstm_mid.cuh) a cluster of 8 CTAs splits the units 32 per CTA and tiles 16,
// 24 or 32 batch rows; each CTA multiplies its own units' dpre by its slice of
// whh^T (in shared memory, on the tensor cores in split TF32), a partial dh'
// of all 256 units, and sends each CTA its units' partial sums, which the
// owners add in rank order.  Past H=256
// (lstm_bwd_wide, lstm_wide.cuh) one persistent cooperative grid runs every
// recurrence, cut into (direction, batch group) pairs and, within a pair,
// slices of U units: each CTA sums dpre whh^T for its group's rows and its U
// units on the tensor cores (split TF32), from its slice of whh^T in shared
// memory (and, past what fits, L2), one barrier a step per pair; dwhh is the
// same reduction.

#include <cuda_runtime.h>
#include <math.h>

#include "lstm_cluster.cuh"
#include "lstm_mid.cuh"
#include "lstm_wide.cuh"
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
  constexpr int NG = S::GROUPS;
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
  const int eg = tid / (S::NT / NG);
  uint64_t* gbar = bar + 2 * eg;
  const uint32_t dp_bytes = (uint32_t)(BT / NG * G * sizeof(float));

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
  if (N > 1 && tid % (S::NT / NG) == 0) {
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
      if (tid % (S::NT / NG) == 0 && it + 3 < T) lstm::mbar_expect(&gbar[it & 1], dp_bytes);
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

// H = 256 (lstm_mid.cuh): one cluster of 8 CTAs per (batch tile of 8 NB
// rows, direction), 32 units a CTA.  Thread (warp w, lane u) owns unit u of
// the CTA in rows w + 8 i (NB rows), keeps their dc and dh' in registers,
// and writes their dpre to the CTA's dpre buffer (column 4 u + gate) and to
// dxw.  The product: warp w sums the partial dh' of the 32 units of CTA w
// over the CTA's 128 dpre columns (16 k-steps) and sends it there.
template <int NB>
__global__ void __launch_bounds__(lstm_mid::NT, 1)
lstm_bwd_mid(const float* __restrict__ gates, const float* __restrict__ whh,
             const float* __restrict__ c_all, const float* __restrict__ g_h,
             float* __restrict__ dxw, int T, int D, int B) {
  using namespace lstm_mid;
  constexpr int BT = 8 * NB, G = 4 * H, KS = 4 * U / 8;  // KS: k-steps of 8
  extern __shared__ float4 smem4[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem4);  // [2]: partial sums arrived, by parity
  float* ws = reinterpret_cast<float*>(smem4 + 1);     // [NW][KS][2 mb][32 lanes][4]: the slice
  float* pbuf = ws + SLICE;                            // [2][BT][LDP]: this CTA's dpre
  float* rbuf = pbuf + 2 * BT * LDP;                   // [2][N sources][BT][U]: partial dh'
  const int n = blockIdx.x % N, tile = blockIdx.x / N, d = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int j = n * U + lane;  // the owner's unit
  const uint32_t p_bytes = (uint32_t)(N * BT * U * sizeof(float));

  // The slice of whh^T in fragment order, as A [256 units][128 dpre columns]:
  // A[jj][k] = whh[jj][gate H + n U + uu] for the column k = 4 uu + gate.  For
  // warp w (the units of CTA w), k-step s, m block mb and lane (g, q), a0 ..
  // a3: row m of block mb is unit 32 w + 4 (m % 8) + 2 mb + m / 8; a0 and a1
  // (rows g, g + 8) are k = 8 s + 2 q, a2 and a3 k + 1.
  {
    const float* W = whh + (size_t)d * H * G + n * U;
    for (int e = tid; e < SLICE; e += NT) {  // coalesced along the columns' units uu
      const int uu = e % U, gate = (e / U) % 4, jj = e / (4 * U), k = 4 * uu + gate;
      const int ul = jj % U;  // the unit in its CTA: 4 g + 2 mb + (row g + 8 of the block)
      const int dst = (((jj / U * KS + k / 8) * 2 + (ul % 4) / 2) * 32 + 4 * (ul / 4) +
                       (k % 8) / 2) * 4 + (ul % 2) + 2 * (k & 1);
      ws[dst] = __ldg(W + (size_t)jj * G + gate * H + uu);
    }
  }
  // step it = T-1-t of the loop: bar[0] counts the partial sums of it = 0,
  // 2, ..., bar[1] of it = 1, 3, ...; the last step's are not exchanged
  if (tid == 0) {
    lstm::mbar_init(&bar[0]);
    lstm::mbar_init(&bar[1]);
    lstm::fence_mbar_init();
    if (T > 1) lstm::mbar_expect(&bar[0], p_bytes);
    if (T > 2) lstm::mbar_expect(&bar[1], p_bytes);
  }

  int b[NB];
  bool valid[NB];
  StepIn cur[NB];
  float c[NB], dc[NB], dhn[NB];  // c at the current step; dc' and dh' from step t+1
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    b[i] = tile * BT + warp + NW * i;
    valid[i] = b[i] < B;
    cur[i] = StepIn{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    c[i] = dc[i] = dhn[i] = 0.f;
    if (valid[i]) {
      cur[i] = load_step(gates, c_all, g_h, T - 1, D, B, H, d, b[i], j);
      c[i] = __ldg(c_all + (((size_t)(T - 1) * D + d) * B + b[i]) * H + j);
    }
  }
  lstm::cluster_sync();  // the slices staged, every CTA of the cluster running, mbarriers armed

  for (int t = T - 1, it = 0; t >= 0; --t, ++it) {
    StepIn nxt[NB];  // step t-1, in flight during this one
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      nxt[i] = StepIn{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (valid[i] && t > 0) nxt[i] = load_step(gates, c_all, g_h, t - 1, D, B, H, d, b[i], j);
    }
    float4 dp[NB];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const StepIn& x = cur[i];
      const float dh = x.gh + dhn[i];
      const float tc = tanhf(c[i]);
      const float dout = dh * tc;
      const float dcv = dh * x.og * (1.0f - tc * tc) + dc[i];
      dc[i] = dcv * x.fg;
      dp[i] = make_float4((dcv * x.gg) * x.ig * (1.0f - x.ig),
                          (dcv * x.c_prev) * x.fg * (1.0f - x.fg),
                          (dcv * x.ig) * (1.0f - x.gg * x.gg), dout * x.og * (1.0f - x.og));
      // zeros for rows past B: their operands are zero
      *reinterpret_cast<float4*>(pbuf + ((it & 1) * BT + warp + NW * i) * LDP + 4 * lane) =
          valid[i] ? dp[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (t > 0) {  // dh' of step 0 is not needed
      __syncthreads();  // the CTA's dpre is complete; every owner has read the last partials
      float acc[2][NB][4];
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mb][nb][e] = 0.f;
      const float* b0 = pbuf + ((it & 1) * BT + g) * LDP + 2 * q;
      const float4* wl = reinterpret_cast<const float4*>(ws) + warp * KS * 64 + lane;
#pragma unroll 4
      for (int s = 0; s < KS; ++s) {
        uint32_t ah[2][4], al[2][4], bh[NB][2], bl[NB][2];
        split_a(wl[s * 64], ah[0], al[0]);
        split_a(wl[s * 64 + 32], ah[1], al[1]);
        load_b<NB>(b0, LDP, s, bh, bl);
        step_products<2, NB>(acc, ah, al, bh, bl);
      }
      // acc[mb][nb]: (e) 0 unit 4 g + 2 mb, row 8 nb + 2 q; 1 that unit, row
      // 8 nb + 2 q + 1; 2 unit 4 g + 2 mb + 1, row 8 nb + 2 q; 3 that unit, row
      // 8 nb + 2 q + 1 (units of CTA warp): a lane sends units 4 g .. 4 g + 3
      // of its two rows of each n block
      const uint32_t m = lstm::map_rank(lstm::smem_addr(&bar[it & 1]), warp);
      const uint32_t slot0 = lstm::map_rank(
          lstm::smem_addr(rbuf + (((it & 1) * N + n) * BT + 2 * q) * U + 4 * g), warp);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const float* a0 = acc[0][nb];
        const float* a1 = acc[1][nb];
        const uint32_t a = slot0 + (uint32_t)(8 * nb * U * sizeof(float));
        lstm::st_async(a, make_float4(a0[0], a0[2], a1[0], a1[2]), m);
        lstm::st_async(a + (uint32_t)(U * sizeof(float)), make_float4(a0[1], a0[3], a1[1], a1[3]),
                       m);
      }
    }
    // dxw while the peers compute
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      if (valid[i]) {
        float* out = dxw + (((size_t)t * D + d) * B + b[i]) * G + j;
        out[0] = dp[i].x;
        out[H] = dp[i].y;
        out[2 * H] = dp[i].z;
        out[3 * H] = dp[i].w;
      }
    }
    if (t == 0) break;
    lstm::mbar_wait(&bar[it & 1], (it >> 1) & 1);
    if (tid == 0 && it + 3 < T) lstm::mbar_expect(&bar[it & 1], p_bytes);
    // dh' = the partial sums of the 8 CTAs, in rank order
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const float* rp = rbuf + (it & 1) * N * BT * U + (warp + NW * i) * U + lane;
      float sum = rp[0];
#pragma unroll
      for (int src = 1; src < N; ++src) sum += rp[src * BT * U];
      dhn[i] = sum;
      c[i] = cur[i].c_prev;
      cur[i] = nxt[i];
    }
  }
  // no CTA leaves while a store of the cluster into its shared memory may
  // be in flight
  lstm::cluster_sync();
}

template <int H>
int launch(const float* gates, const float* whh, const float* c, const float* g, float* dxw,
           int T, int D, int B, int n, int bt, int threads, long long smem,
           cudaStream_t stream) {
  using S = lstm::Bwd<H>;
  const int units = lstm::plan_units(H, n, bt, threads, S::NT, S::RPT, S::GROUPS);
  if (units == 0 || smem < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(((B + bt - 1) / bt) * n, D);
  return lstm::launch_clusters(lstm_bwd_cluster<H>, grid, S::NT, n, (size_t)smem,
                               lstm::bwd_smem_bytes(H, bt), stream,
                               gates, whh, c, g, dxw, T, D, B, units);
}

template <int NB>
int launch_mid(const float* gates, const float* whh, const float* c, const float* g, float* dxw,
               int T, int D, int B, int n, int bt, int waves, int threads, long long smem,
               cudaStream_t stream) {
  return lstm_mid::launch(lstm_bwd_mid<NB>, D, B, n, bt, waves, threads, smem,
                          lstm_mid::bwd_smem_bytes(bt), stream, gates, whh, c, g, dxw, T, D, B);
}

// The wide family (lstm_wide.cuh), every H > 256: one persistent cooperative
// grid, CTA c owning the units [j0, j0 + U) of pair p0 + c / (H / U), the
// pair p being direction p / BG and batch group p % BG.  A step sums dh' of
// its units from the previous step's dpre (dxw[t+1], its group's rows, all 4H
// columns, through L2) and whh^T's columns of its units (wb = whh transposed
// to [D][4H][H]), then writes its units' dpre to dxw[t].  dcstate [D][B][H]
// carries dc; arrived [D BG] counts each pair's CTAs done with a step (zero
// at launch).
__global__ void __launch_bounds__(lstm_wide::NT, 1)
lstm_bwd_wide(const float* __restrict__ gates, const float* __restrict__ wb,
              const float* __restrict__ c_all, const float* __restrict__ g_h, float* dxw,
              float* __restrict__ dcstate, unsigned* arrived, int T, int D, int B, int H, int U,
              int R, int BG, int p0) {
  using namespace lstm_wide;
  extern __shared__ float4 smem4[];
  const int G = 4 * H, N = U, per_pair = H / U, LDW = ldw(N);
  const int p = p0 + blockIdx.x / per_pair, d = p / BG;
  const int j0 = (blockIdx.x % per_pair) * U;
  const int rows = group_rows(B, BG), b_lo = (p % BG) * rows, b_hi = min(b_lo + rows, B);
  const int tr = tile_rows(rows), tc = tile_cols(N), RS = tc + PAD;
  float* ws = reinterpret_cast<float*>(smem4);  // [R][LDW]: resident rows of the slice
  float* ring = ws + (size_t)R * LDW;           // the ring, then the splits' sums
  const float* wg = wb + (size_t)d * G * H + j0;  // row k of the slice at wg + k H
  for (int q = threadIdx.x; q < R * (N / 4); q += NT) {
    const int k = q / (N / 4), c4 = q % (N / 4);
    *reinterpret_cast<float4*>(ws + (size_t)k * LDW + 4 * c4) =
        __ldg(reinterpret_cast<const float4*>(wg + (size_t)k * H + 4 * c4));
  }
  // (the first read of ws follows a __syncthreads of tile_product)
  const Warp w = warp_place<KC_BWD>(tr, tc);

  for (int it = 0; it < T; ++it) {
    const int t = T - 1 - it;
    // the step's saved values, wanted after the product: into L2 while the
    // other CTAs finish the last step
    for (int b0 = b_lo; b0 < b_hi; b0 += tr)
      for (int e = threadIdx.x; e < min(tr, b_hi - b0) * U; e += NT) {
        const size_t row = ((size_t)t * D + d) * B + b0 + e / U;
        const int j = j0 + e % U;
#pragma unroll
        for (int g = 0; g < 4; ++g) prefetch_l2(gates + row * G + g * H + j);
        prefetch_l2(c_all + row * H + j);
        prefetch_l2(g_h + row * H + j);
        if (t > 0) prefetch_l2(c_all + (row - (size_t)D * B) * H + j);
      }
    if (it > 0) wait_for(arrived + p, (unsigned)(it * per_pair));
    for (int b0 = b_lo; b0 < b_hi; b0 += tr) {
      const int nr = min(tr, b_hi - b0);
      for (int n0 = 0; n0 < N; n0 += tc) {
        const int ncols = min(tc, N - n0);
        float acc[WARP_MB][WARP_NB][4];  // dh' of the tile's rows and units
        zero(acc);
        if (it > 0) {  // dh' of the last step is 0
          const float* dp = dxw + (((size_t)(t + 1) * D + d) * B + b0) * G;
          tile_product<KC_BWD>(acc, dp, G, nr, ws, LDW, R, wg + n0, H, G, n0, tr, tc, ncols,
                               ring, w);
        }
        store_sums(acc, ring, tr, tc, ncols, w);
        // the dpre of each (row, unit) of the tile, EPI at a time, dh' summed
        // over the splits in split order
        const int np = nr * ncols;
        for (int e0 = threadIdx.x; e0 < np; e0 += EPI * NT) {
          StepIn in[EPI];
          float cv[EPI], dhv[EPI], dcp[EPI];
#pragma unroll
          for (int i = 0; i < EPI; ++i) {
            const int e = e0 + i * NT;
            if (e >= np) continue;
            const int r = e / ncols, u = e % ncols, b = b0 + r, j = j0 + n0 + u;
            float dhn = ring[(size_t)r * RS + u];
            for (int k = 1; k < w.WK; ++k) dhn += ring[((size_t)k * tr + r) * RS + u];
            in[i] = load_step(gates, c_all, g_h, t, D, B, H, d, b, j);
            cv[i] = __ldg(c_all + (((size_t)t * D + d) * B + b) * H + j);
            dhv[i] = dhn;
            dcp[i] = it > 0 ? dcstate[((size_t)d * B + b) * H + j] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < EPI; ++i) {
            const int e = e0 + i * NT;
            if (e >= np) continue;
            const int b = b0 + e / ncols, j = j0 + n0 + e % ncols;
            const StepIn& x = in[i];
            const float dh = x.gh + dhv[i];
            const float th = tanhf(cv[i]);
            const float dout = dh * th;
            const float dcv = dh * x.og * (1.0f - th * th) + dcp[i];
            dcstate[((size_t)d * B + b) * H + j] = dcv * x.fg;
            float* out = dxw + (((size_t)t * D + d) * B + b) * G + j;
            out[0] = (dcv * x.gg) * x.ig * (1.0f - x.ig);
            out[H] = (dcv * x.c_prev) * x.fg * (1.0f - x.fg);
            out[2 * H] = (dcv * x.ig) * (1.0f - x.gg * x.gg);
            out[3 * H] = dout * x.og * (1.0f - x.og);
          }
        }
        __syncthreads();  // the sums are read: the next tile's ring may refill them
      }
    }
    if (it + 1 < T) arrive(arrived + p);
  }
}

}  // namespace

// The recurrence: launch on `stream`; returns the CUDA error code (0 on
// success).  gates [T][D][B][4H] (activated i, f, g, o from the training
// forward), whh [D][H][4H], c, g [T][D][B][H]; out: dxw [T][D][B][4H].
// (n, bt, groups, threads, smem) is the plan of lstm_launch_plan in
// ops/lstm_scan.py.  H = 4, 8, 16, 32, 64 or 128 runs the clusters of
// lstm_cluster.cuh (`groups`, `dcstate` and `arrived` are not read); H = 256
// those of lstm_mid.cuh (n = 8, bt = 16, 24 or 32, `groups` the waves the plan
// claims for its clusters); H > 256 (a multiple of
// 64) the wide kernel: n units per CTA, bt rows of each CTA's slice of whh^T
// resident in shared memory, the batch in `groups` groups; whh is then whh
// transposed to [D][4H][H], dcstate a [D][B][H] scratch and arrived D x
// groups zeroed counters.
extern "C" int tce_lstm_scan_bwd(const float* gates, const float* whh, const float* c,
                                 const float* g, float* dxw, int T, int D, int B, int H,
                                 int n, int bt, int groups, int threads, long long smem,
                                 float* dcstate, unsigned* arrived, void* stream) {
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
    case 256:
#define TCE_LSTM_BWD_MID(NB)                                                                  \
  if (bt == 8 * NB)                                                                           \
    return launch_mid<NB>(gates, whh, c, g, dxw, T, D, B, n, bt, groups, threads, smem, s);
      TCE_LSTM_BWD_MID(2)
      TCE_LSTM_BWD_MID(3)
      TCE_LSTM_BWD_MID(4)
#undef TCE_LSTM_BWD_MID
      return (int)cudaErrorInvalidValue;
    default: {
      if (H <= 256 || dcstate == nullptr || arrived == nullptr)
        return (int)cudaErrorInvalidValue;
      int p0 = 0;
      void* args[] = {&gates, &whh, &c, &g, &dxw, &dcstate, &arrived, &T, &D, &B, &H, &n, &bt,
                      &groups, &p0};
      return lstm_wide::launch_wide((const void*)lstm_bwd_wide, args, &p0, D, B, H, n, groups,
                                    bt, 4 * H, 1, lstm_wide::KC_BWD, threads, smem, s);
    }
  }
#undef TCE_LSTM_BWD
}

// The clusters of the H = 256 backward kernel at a batch tile of `bt` rows
// that the current card holds at once (cudaOccupancyMaxActiveClusters), or
// minus a CUDA error code.
extern "C" int tce_lstm_bwd_mid_coresident(int bt) {
  const size_t smem = lstm_mid::bwd_smem_bytes(bt);
  if (bt == 16) return lstm_mid::coresident(lstm_bwd_mid<2>, smem);
  if (bt == 24) return lstm_mid::coresident(lstm_bwd_mid<3>, smem);
  if (bt == 32) return lstm_mid::coresident(lstm_bwd_mid<4>, smem);
  return -(int)cudaErrorInvalidValue;
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
