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
// KiB = 29.3 MiB).  So past 256 the weights are shared by all batch rows and
// spread over the whole card, and whatever does not fit is read from L2.
//
// Bound on an H100 (B = 128, T = 192, D = 2): 103.1 GFLOP at H = 512 (the
// forward 1.54 ms at 67 TFLOP/s f32, the backward's two products 3.08 ms),
// 412.3 GFLOP at H = 1024 (6.15 ms forward); the bytes (xw, h, c, gates)
// take a fraction of that.  The floor is again the chain of T dependent
// steps, each a real GEMM ([128, 512] x [512, 2048] at H = 512) followed by
// a barrier across the card.
//
// Design.  One persistent cooperative grid runs all D recurrences: CTA c
// owns the hidden units [j0, j0 + U) of direction d = c / (H / U), and
// computes every batch row of them.  A step of the forward is a product
// h[t-1] [B, H] x (the CTA's whh columns) [H, 4U], whose columns are laid
// out unit-major, gate-minor (the wrapper's permuted copy of whh, so that one
// thread's four columns are the four gates of one unit), then the gate math
// of each (row, unit) in the thread that summed it; the backward's is
// dpre[t+1] [B, 4H] x (whh^T's columns of the CTA's units) [4H, U], then
// the dpre of each (row, unit).  The step's operand (h, or dpre) is the
// previous step's output in device memory (h_out, or dxw): every CTA writes
// its units' columns and reads all of them, through L2, behind one barrier a
// step (a counter of arrivals per direction: a direction never waits for the
// other).  The rows [0, R) of the CTA's slice of whh stay in shared memory
// for all T steps; the rows [R, K) (K = H forward, 4H backward) are
// streamed from L2 every step, where the slice does not fit (H = 1024).  c
// (forward) and dc (backward) of each (row, unit) live in a [D, B, H]
// scratch, read and written by the one thread that owns them.
//
// The product is a register-tiled SGEMM over chunks of KC rows of K: the
// step's operand (4 RG batch rows x KC) and, past R, the chunk of whh
// arrive by 16-byte cp.async (through L2: the operand was written by other
// CTAs in this launch) into a ring of STAGES chunks, the next in flight
// while one is multiplied (one __syncthreads a chunk).  A thread sums a
// TILE x TILE tile: 4 batch rows (rg + RG r, strided so that a warp's float4
// reads of the operand fall in different banks) x 4 columns, 64 FMAs per 4 k
// from 8 LDS.128.  The threads form CG column groups x RG row groups x KS
// splits of each chunk's k; the splits' sums meet in shared memory and are
// added in a fixed order.  No atomics but
// the barrier's counter: the same inputs give the same bits.
//
// The wrapper (ops/lstm_scan.py, lstm_launch_plan) computes the plan of
// each kernel: U (the least multiple of 4 dividing H, at least 8 in the
// backward, that puts each direction's CTAs, D at a time, on the card's SMs,
// one each), R (as many chunks of whh as the shared memory leaves room for)
// and the shared-memory bytes; the
// C entry points check it against the rules below, and a grid that cannot
// be co-resident is refused by the cooperative launch
// (cudaErrorCooperativeLaunchTooLarge): it never hangs on the barrier.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace lstm_wide {
namespace {

constexpr int NT = 256;       // threads per CTA
constexpr int TILE = 4;       // a thread's tile: 4 batch rows x 4 columns
constexpr int PAD = 4;        // floats after each staged row of the operand
constexpr int KC = 64;        // rows of K (H forward, 4H backward) per chunk
constexpr int GRANULE = 64;   // H is a multiple of this (and so K of KC)
constexpr int MAX_RG = 32;    // row groups of a tile at most
constexpr int MAX_CG = 32;    // column groups of a tile at most
constexpr int STAGES = 2;     // chunks in the ring of staged operand (and streamed) rows

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

// The plan rules.  N is the CTA's columns (4U forward, U backward), B the
// batch, kc the chunk.  A tile is at most MAX_RG x 4 rows and MAX_CG x 4
// columns (the staging buffers' bound).  Column groups of a tile (4 columns
// each):
__host__ __device__ inline int col_groups(int N) { return imin(N / TILE, MAX_CG); }

// row groups of a tile (4 rows each):
__host__ __device__ inline int row_groups(int B, int cg) {
  return imin(imin((B + TILE - 1) / TILE, NT / cg), MAX_RG);
}

// splits of a chunk's k:
__host__ __device__ inline int k_splits(int kc, int cg, int rg) {
  return imin(kc / TILE, NT / (cg * rg));
}

// Shared memory: R resident rows of the slice, a ring of STAGES chunks of
// the operand's rows and, when rows of whh are streamed (`streamed` 1, R <
// K), of those rows, and the splits' sums.
inline size_t smem_bytes(int N, int R, int kc, int cg, int rg, int streamed) {
  return sizeof(float) * ((size_t)R * N + STAGES * (size_t)TILE * rg * (kc + PAD) +
                           streamed * STAGES * (size_t)kc * TILE * cg + TILE * TILE * NT);
}

// Directions per launch: as many as put their CTAs (H / U each) on the
// card's SMs, one CTA each; the launches run the rest in turn.
inline int dirs_per_launch(int D, int per_dir, int sms) {
  return per_dir > sms ? 1 : imin(sms / per_dir, D);
}

// Whether the plan's U and R are ones the kernels take for hidden size H
// (R of K rows, chunks of kc).
inline bool plan_ok(int H, int U, int R, int K, int kc) {
  return H % GRANULE == 0 && U >= 4 && U % 4 == 0 && H % U == 0 && R >= 0 && R <= K &&
         R % kc == 0;
}

// A tile of the step's product:
//   acc[r][c] += sum over k < K of A[b0 + rgi + RG r][k] W[k][n0 + 4 cgi + c]
// A: the step's operand in device memory, rows < B (lda floats apart; the
// rest read as 0).  W: the CTA's slice, rows < R resident in `ws` (N floats
// apart), row k >= R at wg + k ldw.  The tile's columns are n0 .. n0 + 4
// ncg.  Every thread of the CTA calls it (it stages and crosses
// __syncthreads); threads with ksi >= KS or cgi >= ncg only stage.
template <int KC>
__device__ __forceinline__ void step_product(float (&acc)[TILE][TILE], const float* A,
                                             int lda, int B, int b0, const float* wg,
                                             int ldw, const float* ws, int N, int R, int K,
                                             int n0, int ncg, float* abuf, float* wbuf,
                                             int CG, int RG, int KS, int cgi, int rgi,
                                             int ksi) {
  constexpr int AST = KC + PAD;  // floats of a staged operand row
  const int RB = TILE * RG, WST = TILE * CG;
  const int nq = K / KC, tid = threadIdx.x;
  // chunk q into ring slot q % STAGES, as one cp.async group (empty past nq)
  auto stage = [&](int q) {
    if (q < nq) {
      const int k0 = q * KC, slot = q % STAGES;
      float* as = abuf + slot * RB * AST;
      for (int p = tid; p < RB * (KC / 4); p += NT) {
        const int r = p / (KC / 4), c4 = p % (KC / 4);
        const bool ok = b0 + r < B;
        cp_async16(as + r * AST + 4 * c4, A + (size_t)(ok ? b0 + r : 0) * lda + k0 + 4 * c4,
                   ok);
      }
      if (k0 >= R) {
        float* w = wbuf + slot * KC * WST;
        for (int p = tid; p < KC * CG; p += NT) {
          const int r = p / CG, c4 = p % CG;
          const bool ok = c4 < ncg;
          cp_async16(w + r * WST + 4 * c4,
                     wg + (size_t)(k0 + r) * ldw + n0 + 4 * (ok ? c4 : 0), ok);
        }
      }
    }
    cp_async_commit();
  };
  const bool active = ksi < KS && cgi < ncg;
#pragma unroll
  for (int q = 0; q < STAGES - 1; ++q) stage(q);
  for (int q = 0; q < nq; ++q) {
    cp_async_wait<STAGES - 2>();  // chunk q has landed (this thread's copies)
    // every thread's copies of chunk q are visible, and every thread is done
    // with chunk q - 1, whose slot the next stage refills
    __syncthreads();
    stage(q + STAGES - 1);
    if (active) {
      const int k0 = q * KC, slot = q % STAGES;
      const float* as = abuf + slot * RB * AST + rgi * AST;
      const float* w;
      int wst;
      if (k0 < R) {
        w = ws + (size_t)k0 * N + n0 + 4 * cgi;
        wst = N;
      } else {
        w = wbuf + slot * KC * WST + 4 * cgi;
        wst = WST;
      }
#pragma unroll 2
      for (int i = ksi; i < KC / 4; i += KS) {
        float4 a[TILE], b[4];
#pragma unroll
        for (int r = 0; r < TILE; ++r)
          a[r] = *reinterpret_cast<const float4*>(as + r * RG * AST + 4 * i);
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4)
          b[q4] = *reinterpret_cast<const float4*>(w + (size_t)(4 * i + q4) * wst);
#pragma unroll
        for (int r = 0; r < TILE; ++r) {
          const float ak[4] = {a[r].x, a[r].y, a[r].z, a[r].w};
#pragma unroll
          for (int q4 = 0; q4 < 4; ++q4) {
            acc[r][0] = fmaf(ak[q4], b[q4].x, acc[r][0]);
            acc[r][1] = fmaf(ak[q4], b[q4].y, acc[r][1]);
            acc[r][2] = fmaf(ak[q4], b[q4].z, acc[r][2]);
            acc[r][3] = fmaf(ak[q4], b[q4].w, acc[r][3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every thread is done with the ring before the next tile stages
}

// Adds the KS splits' tiles into the threads of split 0, in split order.
// `red` holds NT x 16 floats.  Every thread calls it.
__device__ __forceinline__ void add_splits(float (&acc)[TILE][TILE], float* red, int KS,
                                           int CG, int RG, int ksi, bool active) {
  if (KS == 1) return;
  const int tid = threadIdx.x;
  if (active) {
#pragma unroll
    for (int v = 0; v < TILE * TILE; ++v) red[v * NT + tid] = acc[v / TILE][v % TILE];
  }
  __syncthreads();
  if (active && ksi == 0) {
    for (int s = 1; s < KS; ++s)
#pragma unroll
      for (int v = 0; v < TILE * TILE; ++v)
        acc[v / TILE][v % TILE] += red[v * NT + tid + s * CG * RG];
  }
  __syncthreads();
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// This CTA's writes of the step are done: count them on the direction's
// counter.
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

// Checks the plan (U units a CTA, R resident rows of the slice's K rows and
// N columns, `threads`, `smem` bytes) against the rules above and the card,
// and launches `kernel` cooperatively, once per group of directions that fits
// the SMs: (directions in the group) x H / U CTAs of NT threads, each group's
// first direction in *d0, which `args` (the kernel's argument addresses)
// points to.  A grid that cannot be co-resident is refused.
inline int launch_wide(const void* kernel, void** args, int* d0, int D, int B, int H, int U,
                       int R, int K, int N, int threads, long long smem, cudaStream_t stream) {
  int dev = 0, optin = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  if (!plan_ok(H, U, R, K, KC) || threads != NT || smem < 0) return (int)cudaErrorInvalidValue;
  const int cg = col_groups(N);
  if ((size_t)smem != smem_bytes(N, R, KC, cg, row_groups(B, cg), R < K) ||
      smem > (long long)optin)
    return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  const int per_dir = H / U, dirs = dirs_per_launch(D, per_dir, sms);
  for (*d0 = 0; *d0 < D; *d0 += dirs) {
    const int ctas = imin(D - *d0, dirs) * per_dir;
    if ((long long)per_sm * sms < ctas) return (int)cudaErrorCooperativeLaunchTooLarge;
    err = cudaLaunchCooperativeKernel(kernel, dim3(ctas), dim3(NT), args, (size_t)smem, stream);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace
}  // namespace lstm_wide
