// Launch plan, step product and grid barrier of the wide LSTM recurrence
// kernels (lstm_scan.cu lstm_fwd_wide, lstm_scan_bwd.cu lstm_bwd_wide): every
// H above 256, padded by the wrapper to a multiple of GRANULE.
//
// Why the cluster kernels (lstm_cluster.cuh) stop at 256: they hold a CTA's
// slice of whh in registers and give every (batch tile, direction) cluster a
// copy of it.  At H = 512 one direction's whh is 4 MiB: 32 units a CTA fill
// the whole register file, 16 need clusters of 32 CTAs (16 is the most the
// card allows), and every batch tile would hold its own copy.  At H = 1024
// both directions' whh (32 MiB) exceed the card's shared memory (132 x 227
// KiB = 29.3 MiB).  So past 256 the weights are spread over the whole card,
// and whatever does not fit is read from L2.
//
// Bound on an H100 (B = 128, T = 192, D = 2): 103.1 GFLOP at H = 512 (the
// forward 1.54 ms at 67 TFLOP/s f32, the backward's two products 3.08 ms),
// 412.3 GFLOP at H = 1024 (6.15 ms forward); the bytes (xw, h, c, gates)
// take a fraction of that.  The floor is again the chain of T dependent
// steps, each a real GEMM ([128, 512] x [512, 2048] at H = 512) followed by
// a barrier across the card.
//
// Design.  One persistent cooperative grid runs all D recurrences, cut in two
// dimensions: each direction's batch rows into BG groups of group_rows(B, BG)
// rows, and its hidden units into H / U slices of U units.  A (direction,
// batch group) pair is a recurrence of its own: its H / U CTAs own one slice
// each and exchange nothing with another pair's CTAs.  A step of the forward
// is the product h[t-1] [rows, H] x (the CTA's whh columns) [H, 4U], whose
// columns are laid out unit-major, gate-minor (the wrapper's permuted copy of
// whh, so that a unit's four gates are four neighbouring columns), then the
// gate math of each (row, unit); the backward's is dpre[t+1] [rows, 4H] x
// (whh^T's columns of the CTA's units) [4H, U], then the dpre of each (row,
// unit).  The step's operand (h, or dpre) is the previous step's output in
// device memory (h_out, or dxw): each CTA writes its units' columns of its
// group's rows and reads its group's rows of all columns, through L2, behind
// one barrier a step (a counter of arrivals per pair: no pair waits for
// another).  c (forward) and dc (backward) of each (row, unit) live in a
// [D, B, H] scratch, read and written by the one thread that owns them.
//
// The product runs on the tensor cores in split TF32 (rowtile.cuh):
// mma.sync m16n8k8, each operand split as x = hi + lo and the product taken
// as lo*hi + hi*lo + hi*hi, f32 sums, which agrees with an f32 FMA chain to
// about 2^-20 of the terms (a single TF32 product would miss the recurrence's
// 1e-5 limit).  whh stays in f32 and is split as each fragment is loaded, like
// the operand: storing it split would double both the bytes it holds in
// shared memory and the loads of each fragment, to save an AND and a
// subtraction a register, which the CTA's row blocks share.  A tile is at
// most TM rows x TN columns; a warp owns WARP_MB x WARP_NB blocks of 16 rows
// x 8 columns of it and, where the tile has fewer blocks than the warps, one
// of warps_k splits of each chunk's k; the splits meet in shared memory and
// are added in a fixed order.  Each of the three products is a pass over all
// of a warp's blocks (back to back, a block's three products wait for each
// other), and each shape of a warp's blocks has its own branch-free loop.
// The operand's rows (kc + PAD floats apart) and whh's rows (ldw floats
// apart) give conflict-free fragment loads.  After the product each thread
// finishes EPI (row, unit) pairs at a time, their inputs (xw; or the gates,
// c and g) asked of L2 before the step's barrier and loaded together.
//
// Where whh lives: rows [0, R) of the CTA's slice stay in shared memory for
// all T steps; rows [R, K) (K = H forward, 4H backward) are streamed from L2
// every step beside the operand, through the same ring of STAGES chunks of kc
// rows (KC_FWD, KC_BWD; 16-byte cp.async.cg: the operand was written by
// other CTAs in this launch).  At H = 1024, D = 2 (32 MiB of whh, more than
// the card's shared memory) the plan of ops/lstm_scan.py keeps 384 of the
// forward slice's 1,024 rows (U = 16 units, 64 columns, one batch group:
// 98,304 B of whh resident, 163,840 B streamed a step, beside 512 KiB of h)
// and 768 of the backward's 4,096 (U = 32 in 2 groups of 64 rows: 98,304 B
// resident, 425,984 B streamed a step, beside 1 MiB of dpre).  On an H100
// (ptxas, sm_90a) the forward takes 166 registers a thread and the backward
// 186, no spills.  No atomics but the barrier's counter: the same inputs give
// the same bits.
//
// The wrapper (ops/lstm_scan.py, lstm_launch_plan) computes the plan of each
// kernel: U, BG, R and the shared-memory bytes, and runs as many pairs per
// launch as put their CTAs on the card's SMs at once, the rest in further
// launches; the C entry points check it against the rules below, and a grid
// that cannot be co-resident is refused (cudaErrorCooperativeLaunchTooLarge):
// it never hangs on the barrier.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "rowtile.cuh"

namespace lstm_wide {
namespace {

constexpr int NT = 256;      // threads per CTA
constexpr int NW = 8;        // warps per CTA
constexpr int KC_FWD = 64;   // rows of K per chunk: forward (K = H)
constexpr int KC_BWD = 128;  // and backward (K = 4H)
constexpr int STAGES = 2;    // chunks in the ring of staged operand (and streamed) rows
constexpr int PAD = 4;       // floats after each staged operand row and each sum row
constexpr int TM = 128;      // rows of a tile at most
constexpr int TN = 64;       // columns of a tile at most
constexpr int WARP_MB = 2;   // a warp's blocks of 16 rows
constexpr int WARP_NB = 4;   // and of 8 columns
constexpr int GRANULE = 64;  // H is a multiple of this (and so K of each kernel's chunk)

// The plan rules.  B the batch, BG its groups, N the CTA's columns (4U
// forward, U backward), K the product's depth, kc the kernel's chunk, R the
// resident rows.
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// rows of each batch group (the last may have fewer)
__host__ __device__ inline int group_rows(int B, int BG) { return (B + BG - 1) / BG; }

// rows and columns of a tile
__host__ __device__ inline int tile_rows(int rows) { return imin((rows + 15) / 16 * 16, TM); }
__host__ __device__ inline int tile_cols(int N) { return imin(N, TN); }

// warps along a tile's rows and columns, and splits of each chunk's k
__host__ __device__ inline int warps_m(int tr) { return (tr / 16 + WARP_MB - 1) / WARP_MB; }
__host__ __device__ inline int warps_n(int tc) { return (tc / 8 + WARP_NB - 1) / WARP_NB; }
__host__ __device__ inline int warps_k(int tr, int tc, int kc) {
  return imin(NW / (warps_m(tr) * warps_n(tc)), kc / 8);
}

// floats between rows of whh in shared memory: 8 or 24 modulo 32, so that
// the 32 lanes' loads of a B fragment (row t, column g) hit 32 banks
__host__ __device__ inline int ldw(int N) { return N % 16 == 0 ? N + 8 : N; }

// the ring: STAGES chunks of the operand's rows and, when rows of whh are
// streamed (`streamed` 1), of those rows
inline int ring_floats(int tr, int tc, int streamed, int kc) {
  return STAGES * (tr * (kc + PAD) + streamed * kc * ldw(tc));
}

// the splits' sums of a tile, which reuse the ring once a product is done
inline int red_floats(int tr, int tc, int kc) { return warps_k(tr, tc, kc) * tr * (tc + PAD); }

// Shared memory: R resident rows of the slice, then the ring or the sums.
inline size_t smem_bytes(int N, int R, int tr, int tc, int streamed, int kc) {
  return sizeof(float) * ((size_t)R * ldw(N) +
                          imax(ring_floats(tr, tc, streamed, kc), red_floats(tr, tc, kc)));
}

// (direction, batch group) pairs per launch: as many as put their CTAs (H / U
// each) on the card's SMs, one CTA each; the launches run the rest in turn.
inline int pairs_per_launch(int pairs, int per_pair, int sms) {
  return per_pair > sms ? 1 : imin(sms / per_pair, pairs);
}

// Whether U, BG and R are ones the kernels take for hidden size H (cols
// columns a unit: 4 forward, 1 backward; R of K rows): whole blocks of 8
// columns, whole chunks, and no empty batch group.
inline bool plan_ok(int H, int U, int cols, int R, int K, int B, int BG, int kc) {
  return H % GRANULE == 0 && U >= 1 && H % U == 0 && cols * U % 8 == 0 && R >= 0 &&
         R <= K && R % kc == 0 && BG >= 1 && (BG - 1) * group_rows(B, BG) < B;
}

// A warp's place in a tile: blocks 2 wm .. (rows), 4 wn .. (columns), split
// wk of WK of each chunk's k; `active` is false for warps past the splits.
struct Warp {
  int wm, wn, wk, WK;
  bool active;
};

template <int KC>
__device__ __forceinline__ Warp warp_place(int tr, int tc) {
  const int WM = warps_m(tr), WN = warps_n(tc), w = threadIdx.x / 32;
  Warp p;
  p.wm = w % WM;
  p.wn = (w / WM) % WN;
  p.wk = w / (WM * WN);
  p.WK = warps_k(tr, tc, KC);
  p.active = p.wk < p.WK;
  return p;
}

// One chunk's products of a warp: its k steps kk = k0, k0 + ks, ... < KC / 8
// (8 deep each) for its MB x NB blocks, a branch-free loop for each shape.
// as: the warp's first operand row in the staged chunk, at this lane's (row
// g, column t); wb: the chunk's first row of whh at this lane's (row t,
// column g), rows wst floats apart.
template <int KC, int MB, int NB>
__device__ __forceinline__ void chunk_product(float (&acc)[WARP_MB][WARP_NB][4], const float* as,
                                              const float* wb, int wst, int k0, int ks) {
  constexpr int AST = KC + PAD;
#pragma unroll 2
  for (int kk = k0; kk < KC / 8; kk += ks) {
    uint32_t ah[MB][4], al[MB][4], bh[NB][2], bl[NB][2];
#pragma unroll
    for (int mi = 0; mi < MB; ++mi) {
      const float* p = as + 16 * mi * AST + 8 * kk;
      rowtile::split_tf32(p[0], ah[mi][0], al[mi][0]);
      rowtile::split_tf32(p[8 * AST], ah[mi][1], al[mi][1]);
      rowtile::split_tf32(p[4], ah[mi][2], al[mi][2]);
      rowtile::split_tf32(p[8 * AST + 4], ah[mi][3], al[mi][3]);
    }
#pragma unroll
    for (int ni = 0; ni < NB; ++ni) {
      const float* p = wb + (size_t)8 * kk * wst + 8 * ni;
      rowtile::split_tf32(p[0], bh[ni][0], bl[ni][0]);
      rowtile::split_tf32(p[4 * wst], bh[ni][1], bl[ni][1]);
    }
    // small terms first, each a pass over all of the warp's blocks, so that
    // neighbouring products do not wait for each other's sums
#pragma unroll
    for (int mi = 0; mi < MB; ++mi)
#pragma unroll
      for (int ni = 0; ni < NB; ++ni) rowtile::mma_tf32(acc[mi][ni], al[mi], bh[ni]);
#pragma unroll
    for (int mi = 0; mi < MB; ++mi)
#pragma unroll
      for (int ni = 0; ni < NB; ++ni) rowtile::mma_tf32(acc[mi][ni], ah[mi], bl[ni]);
#pragma unroll
    for (int mi = 0; mi < MB; ++mi)
#pragma unroll
      for (int ni = 0; ni < NB; ++ni) rowtile::mma_tf32(acc[mi][ni], ah[mi], bh[ni]);
  }
}

// chunk_product for the warp's mb (1 or 2) x nb (1 to 4) blocks
template <int KC>
__device__ __forceinline__ void chunk_product(float (&acc)[WARP_MB][WARP_NB][4], const float* as,
                                              const float* wb, int wst, int k0, int ks, int mb,
                                              int nb) {
  static_assert(WARP_MB == 2 && WARP_NB == 4, "one instance per shape of a warp's blocks");
  switch (4 * (mb - 1) + nb - 1) {
    case 0: return chunk_product<KC, 1, 1>(acc, as, wb, wst, k0, ks);
    case 1: return chunk_product<KC, 1, 2>(acc, as, wb, wst, k0, ks);
    case 2: return chunk_product<KC, 1, 3>(acc, as, wb, wst, k0, ks);
    case 3: return chunk_product<KC, 1, 4>(acc, as, wb, wst, k0, ks);
    case 4: return chunk_product<KC, 2, 1>(acc, as, wb, wst, k0, ks);
    case 5: return chunk_product<KC, 2, 2>(acc, as, wb, wst, k0, ks);
    case 6: return chunk_product<KC, 2, 3>(acc, as, wb, wst, k0, ks);
    default: return chunk_product<KC, 2, 4>(acc, as, wb, wst, k0, ks);
  }
}

// A tile of the step's product, this warp's split of it:
//   acc[mi][ni] += sum over its k of A[r][k] W[k][c]
// for the rows r of block 2 wm + mi and the columns c of block 4 wn + ni.
// A: the step's operand in device memory, the tile's first row, rows lda
// floats apart (rows from nr on read as 0).  W: the CTA's slice from column
// n0, rows < R resident in `ws` (ldws floats apart), row k >= R at wg + k ldwg
// (wg at column n0).  ncols (a multiple of 8) of the tile's tc columns are
// real.  Every thread of the CTA calls it (it stages and crosses
// __syncthreads); inactive warps only stage.
template <int KC>
__device__ __forceinline__ void tile_product(float (&acc)[WARP_MB][WARP_NB][4], const float* A,
                                             int lda, int nr, const float* ws, int ldws, int R,
                                             const float* wg, int ldwg, int K, int n0, int tr,
                                             int tc, int ncols, float* ring, const Warp& w) {
  constexpr int AST = KC + PAD;  // floats of a staged operand row
  const int LDT = ldw(tc);       // and of a streamed row of whh
  float* abuf = ring;            // [STAGES][tr][AST]
  float* wbuf = ring + STAGES * tr * AST;  // [STAGES][KC][LDT]
  const int nq = K / KC, tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // this warp's blocks of rows and of columns that the tile has
  const int mb = imin(WARP_MB, tr / 16 - WARP_MB * w.wm);
  const int nb = imin(WARP_NB, ncols / 8 - WARP_NB * w.wn);
  // chunk q into ring slot q % STAGES, as one cp.async group (empty past nq)
  auto stage = [&](int q) {
    if (q < nq) {
      const int k0 = q * KC, slot = q % STAGES;
      float* as = abuf + slot * tr * AST;
      for (int p = tid; p < tr * (KC / 4); p += NT) {
        const int r = p / (KC / 4), c4 = p % (KC / 4);
        const bool ok = r < nr;
        cp_async16(as + r * AST + 4 * c4, A + (size_t)(ok ? r : 0) * lda + k0 + 4 * c4, ok);
      }
      if (k0 >= R) {
        float* wsl = wbuf + slot * KC * LDT;
        for (int p = tid; p < KC * (tc / 4); p += NT) {
          const int r = p / (tc / 4), c4 = p % (tc / 4);
          const bool ok = 4 * c4 < ncols;
          cp_async16(wsl + r * LDT + 4 * c4, wg + (size_t)(k0 + r) * ldwg + 4 * (ok ? c4 : 0),
                     ok);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int q = 0; q < STAGES - 1; ++q) stage(q);
  for (int q = 0; q < nq; ++q) {
    cp_async_wait<STAGES - 2>();  // chunk q has landed (this thread's copies)
    // every thread's copies of chunk q are visible, and every thread is done
    // with chunk q - 1, whose slot the next stage refills
    __syncthreads();
    stage(q + STAGES - 1);
    if (w.active) {
      const int k0 = q * KC, slot = q % STAGES;
      const float* as = abuf + slot * tr * AST + (16 * WARP_MB * w.wm + g) * AST + t;
      const float* wb;
      int wst;
      if (k0 < R) {
        wb = ws + (size_t)k0 * ldws + n0;
        wst = ldws;
      } else {
        wb = wbuf + slot * KC * LDT;
        wst = LDT;
      }
      wb += t * wst + 8 * WARP_NB * w.wn + g;
      if (nb > 0) chunk_product<KC>(acc, as, wb, wst, w.wk, w.WK, mb, nb);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every thread is done with the ring, which the sums reuse
}

// The warp's sums of a tile into red [WK][tr][tc + PAD] (split wk's rows at
// red + wk tr (tc + PAD)), then a barrier: the tile's sums are complete.
// Every thread calls it.
__device__ __forceinline__ void store_sums(const float (&acc)[WARP_MB][WARP_NB][4], float* red,
                                           int tr, int tc, int ncols, const Warp& w) {
  if (w.active) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, RS = tc + PAD;
#pragma unroll
    for (int mi = 0; mi < WARP_MB; ++mi) {
#pragma unroll
      for (int ni = 0; ni < WARP_NB; ++ni) {
        const int r = 16 * (WARP_MB * w.wm + mi) + g, c = 8 * (WARP_NB * w.wn + ni) + 2 * t;
        if (r < tr && c < ncols) {
          float* o = red + ((size_t)w.wk * tr + r) * RS + c;
          *reinterpret_cast<float2*>(o) = make_float2(acc[mi][ni][0], acc[mi][ni][1]);
          *reinterpret_cast<float2*>(o + 8 * RS) = make_float2(acc[mi][ni][2], acc[mi][ni][3]);
        }
      }
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void zero(float (&acc)[WARP_MB][WARP_NB][4]) {
#pragma unroll
  for (int mi = 0; mi < WARP_MB; ++mi)
#pragma unroll
    for (int ni = 0; ni < WARP_NB; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.f;
}

// pairs (row, unit) of a tile a thread finishes at once: their inputs are
// loaded together, one latency for EPI pairs
constexpr int EPI = 4;

// asks L2 for the line holding p (the epilogue's inputs, read after the
// product)
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// This CTA's writes of the step are done: count them on the pair's counter.
__device__ __forceinline__ void arrive(unsigned* count) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
  }
}

// Waits until `target` arrivals were counted; every write they counted is
// then visible to the CTA's reads through L2.
__device__ __forceinline__ void wait_for(const unsigned* count, unsigned target) {
  if (threadIdx.x == 0) {
    while (ld_acquire(count) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

// Checks the plan (U units a CTA, BG batch groups, R resident rows of the
// slice's K rows, cols columns a unit, chunks of kc rows, `threads`, `smem`
// bytes) against the
// rules above and the card, and launches `kernel` cooperatively, once per
// run of pairs that fits the SMs: (pairs in the run) x H / U CTAs of NT
// threads, the run's first pair in *p0, which `args` (the kernel's argument
// addresses) points to.  A grid that cannot be co-resident is refused.
inline int launch_wide(const void* kernel, void** args, int* p0, int D, int B, int H, int U,
                       int BG, int R, int K, int cols, int kc, int threads, long long smem,
                       cudaStream_t stream) {
  int dev = 0, optin = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  if (!plan_ok(H, U, cols, R, K, B, BG, kc) || threads != NT || smem < 0)
    return (int)cudaErrorInvalidValue;
  const int N = cols * U, tr = tile_rows(group_rows(B, BG)), tc = tile_cols(N);
  if ((size_t)smem != smem_bytes(N, R, tr, tc, R < K, kc) || smem > (long long)optin)
    return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  const int per_pair = H / U, pairs = D * BG, run = pairs_per_launch(pairs, per_pair, sms);
  for (*p0 = 0; *p0 < pairs; *p0 += run) {
    const int ctas = imin(pairs - *p0, run) * per_pair;
    if ((long long)per_sm * sms < ctas) return (int)cudaErrorCooperativeLaunchTooLarge;
    err = cudaLaunchCooperativeKernel(kernel, dim3(ctas), dim3(NT), args, (size_t)smem, stream);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace
}  // namespace lstm_wide
