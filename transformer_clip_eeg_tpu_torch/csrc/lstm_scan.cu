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
// At H=256 (lstm_fwd_mid, lstm_mid.cuh) a cluster of 8 CTAs splits the
// units 32 per CTA and tiles 16, 24 or 32 batch rows, so that at B=128 every
// cluster is co-resident; each CTA keeps its [256 k x 128 gate columns]
// slice of whh in shared memory and sums h_prev W on the tensor cores
// (split TF32), each lane ending with the 4 gates of its (row, unit).
// Past H=256 (lstm_fwd_wide, lstm_wide.cuh) one persistent cooperative grid
// runs every recurrence, cut into (direction, batch group) pairs and, within
// a pair, slices of U units: each CTA sums h_prev W for its group's rows and
// its 4 U gate columns on the tensor cores (split TF32), from its whh slice
// in shared memory (and, past what fits, L2), one barrier a step per pair.

#include <cuda_runtime.h>
#include <math.h>

#include "lstm_cluster.cuh"
#include "lstm_mid.cuh"
#include "lstm_wide.cuh"

namespace {

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// the wide and H=256 kernels' sigmoid, with the fast exponential (2 ulp and
// 1.16 |x| ulp more): the gate math of a step sits on the chain of T steps
__device__ __forceinline__ float sigmoid_fast(float x) { return 1.0f / (1.0f + __expf(-x)); }

template <int H>
__global__ void __launch_bounds__(lstm::threads<H>())
lstm_fwd_cluster(const float* __restrict__ xw, const float* __restrict__ whh,
                 float* __restrict__ h_out, float* __restrict__ c_out,
                 float* __restrict__ gates_out, int T, int D, int B, int U) {
  using S = lstm::Fwd<H>;
  constexpr int NT = S::NT, KPT = S::KPT, KG = S::KG, RPT = S::RPT, G = 4 * H;
  constexpr int NG = S::GROUPS;
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
  const int eg = tid / (NT / NG);
  uint64_t* gbar = bar + 2 * eg;
  const uint32_t h_bytes = (uint32_t)(BT / NG * H * sizeof(float));

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
  if (N > 1 && tid % (NT / NG) == 0) {
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
      if (tid % (NT / NG) == 0 && t + 2 < T) lstm::mbar_expect(&gbar[t & 1], h_bytes);
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

// H = 256 (lstm_mid.cuh): one cluster of 8 CTAs per (batch tile of 8 NB
// rows, direction), 32 units a CTA.  Warp w sums the k-steps of its half
// kh = w / 4 for the units 8 ug .. 8 ug + 7 (ug = w % 4); lane (g, q) then
// owns unit 8 ug + g of the CTA in rows 8 nb + 2 q + kh (NB rows), keeps
// their c in registers, and sends their h.
template <int NB>
__global__ void __launch_bounds__(lstm_mid::NT, 1)
lstm_fwd_mid(const float* __restrict__ xw, const float* __restrict__ whh,
             float* __restrict__ h_out, float* __restrict__ c_out,
             float* __restrict__ gates_out, int T, int D, int B) {
  using namespace lstm_mid;
  constexpr int BT = 8 * NB, G = 4 * H, KS = H / 8, KH = KS / 2;  // k-steps of 8; a warp's
  extern __shared__ float4 smem4[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem4);  // [2]: h arrived, by step parity
  float* ws = reinterpret_cast<float*>(smem4 + 1);     // [4 ug][KS][2 mb][32 lanes][4]: the slice
  float* hbuf = ws + SLICE;                            // [2][BT][LDH]: h_prev, by parity
  float4* half = reinterpret_cast<float4*>(hbuf + 2 * BT * LDH);  // [NW][NB][32 lanes]
  const int n = blockIdx.x % N, tile = blockIdx.x / N, d = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int ug = warp % 4, kh = warp / 4;
  const int j = n * U + 8 * ug + g;  // this lane's unit
  const uint32_t h_bytes = (uint32_t)(BT * H * sizeof(float));

  // The slice in fragment order: for unit group ug, k-step s, m block mb and
  // lane (g, q), a0 .. a3: row m of block mb is gate 2 mb + m / 8 of unit
  // 8 ug + m % 8; a0 and a1 (rows g, g + 8) are k = 8 s + 2 q, a2 and a3 k + 1.
  {
    const float* W = whh + (size_t)d * H * G + n * U;
    for (int e = tid; e < SLICE; e += NT) {  // coalesced along the units
      const int uu = e % U, gate = (e / U) % 4, k = e / (4 * U);
      const int dst = (((uu / 8 * KS + k / 8) * 2 + gate / 2) * 32 + 4 * (uu % 8) +
                       (k % 8) / 2) * 4 + (gate & 1) + 2 * (k & 1);
      ws[dst] = __ldg(W + (size_t)k * G + gate * H + uu);
    }
  }
  if (tid == 0) {  // bar[1] counts the h of steps 0, 2, ..., bar[0] of 1, 3, ...
    lstm::mbar_init(&bar[0]);
    lstm::mbar_init(&bar[1]);
    lstm::fence_mbar_init();
    if (T > 1) lstm::mbar_expect(&bar[1], h_bytes);
    if (T > 2) lstm::mbar_expect(&bar[0], h_bytes);
  }

  int b[NB];
  bool valid[NB];
  float c[NB], xc[NB][4];
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    b[i] = tile * BT + 8 * i + 2 * q + kh;
    valid[i] = b[i] < B;
    c[i] = 0.f;
    const float* xr = xw + ((size_t)d * B + b[i]) * G + j;
#pragma unroll
    for (int gate = 0; gate < 4; ++gate) xc[i][gate] = valid[i] ? __ldg(xr + gate * H) : 0.f;
  }
  lstm::cluster_sync();  // the slices staged, every CTA of the cluster running, mbarriers armed

  for (int t = 0; t < T; ++t) {
    float xn[NB][4];  // the next step's xw, in flight during this one
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const float* xr = xw + (((size_t)(t + 1) * D + d) * B + b[i]) * G + j;
#pragma unroll
      for (int gate = 0; gate < 4; ++gate)
        xn[i][gate] = valid[i] && t + 1 < T ? __ldg(xr + gate * H) : 0.f;
    }
    float pre[NB][4];  // the gates' sums of h_prev W of this lane's rows
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) pre[i][gate] = 0.f;
    if (t > 0) {  // h of step -1 is 0
      lstm::mbar_wait(&bar[t & 1], ((t - 1) >> 1) & 1);
      if (tid == 0 && t + 2 < T) lstm::mbar_expect(&bar[t & 1], h_bytes);
      float acc[2][NB][4];
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mb][nb][e] = 0.f;
      const float* b0 = hbuf + ((t & 1) * BT + g) * LDH + 2 * q;
      const float4* wl = reinterpret_cast<const float4*>(ws) + (ug * KS + KH * kh) * 64 + lane;
#pragma unroll 4
      for (int s = 0; s < KH; ++s) {
        uint32_t ah[2][4], al[2][4], bh[NB][2], bl[NB][2];
        split_a(wl[s * 64], ah[0], al[0]);
        split_a(wl[s * 64 + 32], ah[1], al[1]);
        load_b<NB>(b0, LDH, KH * kh + s, bh, bl);
        step_products<2, NB>(acc, ah, al, bh, bl);
      }
      // acc[mb][nb]: (e) 0 row 2 q, gate 2 mb; 1 row 2 q + 1, gate 2 mb; 2 row
      // 2 q, gate 2 mb + 1; 3 row 2 q + 1, gate 2 mb + 1 (rows of n block nb).
      // This warp keeps row 2 q + kh and gives its partner the other row
      float4* mine = half + warp * NB * 32 + lane;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const float* a0 = acc[0][nb];
        const float* a1 = acc[1][nb];
        mine[nb * 32] = kh ? make_float4(a0[0], a0[2], a1[0], a1[2])
                           : make_float4(a0[1], a0[3], a1[1], a1[3]);
      }
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + ug), "r"(64) : "memory");
      const float4* theirs = half + (warp ^ 4) * NB * 32 + lane;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const float* a0 = acc[0][nb];
        const float* a1 = acc[1][nb];
        const float4 o = theirs[nb * 32];
        pre[nb][0] = (kh ? a0[1] : a0[0]) + o.x;
        pre[nb][1] = (kh ? a0[3] : a0[2]) + o.y;
        pre[nb][2] = (kh ? a1[1] : a1[0]) + o.z;
        pre[nb][3] = (kh ? a1[3] : a1[2]) + o.w;
      }
    }

    float hv[NB], gv[NB][4];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      gv[i][0] = sigmoid_fast(xc[i][0] + pre[i][0]);
      gv[i][1] = sigmoid_fast(xc[i][1] + pre[i][1]);
      gv[i][2] = tanhf(xc[i][2] + pre[i][2]);
      gv[i][3] = sigmoid_fast(xc[i][3] + pre[i][3]);
      c[i] = gv[i][1] * c[i] + gv[i][0] * gv[i][2];
      hv[i] = gv[i][3] * tanhf(c[i]);
    }
    // the h of 4 units of each row (lanes g = 4 a .. 4 a + 3 of one q) into
    // the next step's buffer of every CTA of the cluster, lane g to CTAs
    // g % 4 and g % 4 + 4 (zeros for rows past B); the last step's h is not
    // needed there.  The stores to device memory follow, while the peers
    // compute
    if (t + 1 < T) {
      const int src = (lane & 16) | q;  // lane (4 a, q)
      const uint32_t slot0 = lstm::smem_addr(hbuf + ((t + 1) & 1) * BT * LDH + n * U + 8 * ug +
                                             4 * (g >> 2));
      const uint32_t m = lstm::smem_addr(&bar[(t + 1) & 1]);
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const float v = valid[i] ? hv[i] : 0.f;
        const float4 h4 = make_float4(__shfl_sync(0xffffffffu, v, src),
                                      __shfl_sync(0xffffffffu, v, src + 4),
                                      __shfl_sync(0xffffffffu, v, src + 8),
                                      __shfl_sync(0xffffffffu, v, src + 12));
        const uint32_t a = slot0 + (uint32_t)((8 * i + 2 * q + kh) * LDH * sizeof(float));
        lstm::st_async(lstm::map_rank(a, g & 3), h4, lstm::map_rank(m, g & 3));
        lstm::st_async(lstm::map_rank(a, (g & 3) + 4), h4, lstm::map_rank(m, (g & 3) + 4));
      }
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      if (valid[i]) {
        const size_t row = ((size_t)t * D + d) * B + b[i];
        h_out[row * H + j] = hv[i];
        if (c_out != nullptr) c_out[row * H + j] = c[i];
        if (gates_out != nullptr) {
          float* gr = gates_out + row * G + j;
#pragma unroll
          for (int gate = 0; gate < 4; ++gate) gr[gate * H] = gv[i][gate];
        }
      }
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) xc[i][gate] = xn[i][gate];
    }
  }
  // no CTA leaves while a store of the cluster into its shared memory may
  // be in flight
  lstm::cluster_sync();
}

template <int H>
int launch(const float* xw, const float* whh, float* h_out, float* c_out, float* gates_out,
           int T, int D, int B, int n, int bt, int threads, long long smem,
           cudaStream_t stream) {
  using S = lstm::Fwd<H>;
  const int units = lstm::plan_units(H, n, bt, threads, S::NT, S::RPT, S::GROUPS);
  if (units == 0 || smem < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(((B + bt - 1) / bt) * n, D);
  return lstm::launch_clusters(lstm_fwd_cluster<H>, grid, S::NT, n, (size_t)smem,
                               lstm::fwd_smem_bytes(H, bt), stream,
                               xw, whh, h_out, c_out, gates_out, T, D, B, units);
}

template <int NB>
int launch_mid(const float* xw, const float* whh, float* h_out, float* c_out, float* gates_out,
               int T, int D, int B, int n, int bt, int waves, int threads, long long smem,
               cudaStream_t stream) {
  return lstm_mid::launch(lstm_fwd_mid<NB>, D, B, n, bt, waves, threads, smem,
                          lstm_mid::fwd_smem_bytes(bt), stream, xw, whh, h_out, c_out, gates_out,
                          T, D, B);
}

// The wide family (lstm_wide.cuh), every H > 256: one persistent cooperative
// grid, CTA c owning the units [j0, j0 + U) of pair p0 + c / (H / U), the
// pair p being direction p / BG and batch group p % BG.  wf is whh permuted to
// [D][H][H][4] (wf[d][k][4 j + g] = whh[d][k][g H + j]); cstate [D][B][H]
// carries c; arrived [D BG] counts each pair's CTAs done with a step (zero
// at launch).
__global__ void __launch_bounds__(lstm_wide::NT, 1)
lstm_fwd_wide(const float* __restrict__ xw, const float* __restrict__ wf, float* h_out,
              float* __restrict__ c_out, float* __restrict__ gates_out,
              float* __restrict__ cstate, unsigned* arrived, int T, int D, int B, int H,
              int U, int R, int BG, int p0) {
  using namespace lstm_wide;
  extern __shared__ float4 smem4[];
  const int G = 4 * H, N = 4 * U, per_pair = H / U, LDW = ldw(N);
  const int p = p0 + blockIdx.x / per_pair, d = p / BG;
  const int j0 = (blockIdx.x % per_pair) * U;
  const int rows = group_rows(B, BG), b_lo = (p % BG) * rows, b_hi = min(b_lo + rows, B);
  const int tr = tile_rows(rows), tc = tile_cols(N), RS = tc + PAD;
  float* ws = reinterpret_cast<float*>(smem4);  // [R][LDW]: resident rows of the slice
  float* ring = ws + (size_t)R * LDW;           // the ring, then the splits' sums
  const float* wg = wf + (size_t)d * H * G + 4 * j0;  // row k of the slice at wg + k G
  for (int q = threadIdx.x; q < R * (N / 4); q += NT) {
    const int k = q / (N / 4), c4 = q % (N / 4);
    *reinterpret_cast<float4*>(ws + (size_t)k * LDW + 4 * c4) =
        __ldg(reinterpret_cast<const float4*>(wg + (size_t)k * G + 4 * c4));
  }
  // (the first read of ws follows a __syncthreads of tile_product)
  const Warp w = warp_place<KC_FWD>(tr, tc);

  for (int t = 0; t < T; ++t) {
    // the step's xw, wanted after the product: into L2 while the other CTAs
    // finish the last step
    for (int b0 = b_lo; b0 < b_hi; b0 += tr)
      for (int e = threadIdx.x; e < min(tr, b_hi - b0) * U; e += NT) {
        const float* xr = xw + (((size_t)t * D + d) * B + b0 + e / U) * G + j0 + e % U;
#pragma unroll
        for (int g = 0; g < 4; ++g) prefetch_l2(xr + g * H);
      }
    if (t > 0) wait_for(arrived + p, (unsigned)(t * per_pair));
    for (int b0 = b_lo; b0 < b_hi; b0 += tr) {
      const int nr = min(tr, b_hi - b0);
      for (int n0 = 0; n0 < N; n0 += tc) {
        const int ncols = min(tc, N - n0);
        float acc[WARP_MB][WARP_NB][4];
        zero(acc);
        if (t > 0) {  // h of step -1 is 0
          const float* hp = h_out + (((size_t)(t - 1) * D + d) * B + b0) * H;
          tile_product<KC_FWD>(acc, hp, H, nr, ws, LDW, R, wg + n0, G, H, n0, tr, tc, ncols,
                               ring, w);
        }
        store_sums(acc, ring, tr, tc, ncols, w);
        // the gate math of each (row, unit) of the tile, EPI at a time: a
        // unit's 4 gates are 4 neighbouring columns, summed over the splits
        // in split order
        const int nu = ncols / 4, np = nr * nu;
        for (int e0 = threadIdx.x; e0 < np; e0 += EPI * NT) {
          float4 pre[EPI];
          float cp[EPI];
#pragma unroll
          for (int i = 0; i < EPI; ++i) {
            const int e = e0 + i * NT;
            if (e >= np) continue;
            const int r = e / nu, u = e % nu, b = b0 + r, j = j0 + n0 / 4 + u;
            float4 s = *reinterpret_cast<const float4*>(ring + (size_t)r * RS + 4 * u);
            for (int k = 1; k < w.WK; ++k) {
              const float4 v =
                  *reinterpret_cast<const float4*>(ring + ((size_t)k * tr + r) * RS + 4 * u);
              s.x += v.x;
              s.y += v.y;
              s.z += v.z;
              s.w += v.w;
            }
            const float* xr = xw + (((size_t)t * D + d) * B + b) * G + j;
            pre[i] = make_float4(__ldg(xr) + s.x, __ldg(xr + H) + s.y, __ldg(xr + 2 * H) + s.z,
                                 __ldg(xr + 3 * H) + s.w);
            cp[i] = t > 0 ? cstate[((size_t)d * B + b) * H + j] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < EPI; ++i) {
            const int e = e0 + i * NT;
            if (e >= np) continue;
            const int b = b0 + e / nu, j = j0 + n0 / 4 + e % nu;
            const size_t row = ((size_t)t * D + d) * B + b;
            const float ig = sigmoid_fast(pre[i].x);
            const float fg = sigmoid_fast(pre[i].y);
            const float gg = tanhf(pre[i].z);
            const float og = sigmoid_fast(pre[i].w);
            const float c = fg * cp[i] + ig * gg;
            const float h = og * tanhf(c);
            cstate[((size_t)d * B + b) * H + j] = c;
            h_out[row * H + j] = h;
            if (c_out != nullptr) c_out[row * H + j] = c;
            if (gates_out != nullptr) {
              float* gr = gates_out + row * G + j;
              gr[0] = ig;
              gr[H] = fg;
              gr[2 * H] = gg;
              gr[3 * H] = og;
            }
          }
        }
        __syncthreads();  // the sums are read: the next tile's ring may refill them
      }
    }
    if (t + 1 < T) arrive(arrived + p);
  }
}

}  // namespace

// Launch on `stream`; returns the CUDA error code (0 on success).  `c_out`
// and `gates_out` may be NULL.  (n, bt, groups, threads, smem) is the plan of
// lstm_launch_plan in ops/lstm_scan.py.  H = 4, 8, 16, 32, 64 or 128 runs the
// clusters of lstm_cluster.cuh: n CTAs each, bt batch rows, `smem` bytes of
// shared memory; `groups`, `cstate` and `arrived` are not read.  H = 256 runs
// those of lstm_mid.cuh: n = 8, bt = 16, 24 or 32, `groups` the waves the plan
// claims for its clusters.  H > 256 (a multiple of 64)
// runs the wide kernel: n units per CTA, bt rows of each CTA's whh slice
// resident in shared memory, the batch in `groups` groups; whh is then the
// permuted copy lstm_fwd_wide reads, cstate a [D][B][H] scratch and arrived
// D x groups zeroed counters.
extern "C" int tce_lstm_scan_fwd(const float* xw, const float* whh, float* h_out,
                                 float* c_out, float* gates_out, int T, int D, int B, int H,
                                 int n, int bt, int groups, int threads, long long smem,
                                 float* cstate, unsigned* arrived, void* stream) {
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
    case 256:
#define TCE_LSTM_FWD_MID(NB)                                                          \
  if (bt == 8 * NB)                                                                   \
    return launch_mid<NB>(xw, whh, h_out, c_out, gates_out, T, D, B, n, bt, groups, \
                          threads, smem, s);
      TCE_LSTM_FWD_MID(2)
      TCE_LSTM_FWD_MID(3)
      TCE_LSTM_FWD_MID(4)
#undef TCE_LSTM_FWD_MID
      return (int)cudaErrorInvalidValue;
    default: {
      if (H <= 256 || cstate == nullptr || arrived == nullptr) return (int)cudaErrorInvalidValue;
      int p0 = 0;
      void* args[] = {&xw, &whh, &h_out, &c_out, &gates_out, &cstate, &arrived, &T, &D, &B,
                      &H, &n, &bt, &groups, &p0};
      return lstm_wide::launch_wide((const void*)lstm_fwd_wide, args, &p0, D, B, H, n, groups,
                                    bt, H, 4, lstm_wide::KC_FWD, threads, smem, s);
    }
  }
#undef TCE_LSTM_FWD
}

// The clusters of the H = 256 forward kernel at a batch tile of `bt` rows
// that the current card holds at once (cudaOccupancyMaxActiveClusters), or
// minus a CUDA error code.
extern "C" int tce_lstm_fwd_mid_coresident(int bt) {
  const size_t smem = lstm_mid::fwd_smem_bytes(bt);
  if (bt == 16) return lstm_mid::coresident(lstm_fwd_mid<2>, smem);
  if (bt == 24) return lstm_mid::coresident(lstm_fwd_mid<3>, smem);
  if (bt == 32) return lstm_mid::coresident(lstm_fwd_mid<4>, smem);
  return -(int)cudaErrorInvalidValue;
}
