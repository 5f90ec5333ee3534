// Launch plan, step product and exchange of the H = 256 LSTM recurrence
// kernels (lstm_scan.cu lstm_fwd_mid, lstm_scan_bwd.cu lstm_bwd_mid):
// --lstm_units 256, --latent_dim 512's second biLSTM, and every H from 129
// to 255, which the wrapper zero-pads to 256.
//
// Bound on an H100 (B = 128, T = 192, D = 2): 25.8 GFLOP for the forward's
// h whh (0.38 ms at 67 TFLOP/s f32; 0.05 ms at 495 TFLOP/s TF32, three
// TF32 products for one f32 one), the same for the backward's dpre whh^T;
// the bytes (xw, h, c, gates) take less.  The floor is the chain of T
// dependent steps, each a [B, 256] x [256, 1024] product, the gate math and
// an exchange of h (or of dh's partial sums) inside a thread-block cluster.
// On an H100 80GB HBM3 at 700 W (tools/lstm_mid_tiles.py, T = 192, B = 128)
// the forward takes about 1.05 ms at D = 2 and 0.76 ms at D = 1, the
// backward's recurrence 0.84 and 0.62 ms: 5.4 and 4.4 us a step at D = 2.
//
// Why not the designs beside it.  The cluster family of lstm_cluster.cuh
// held a CTA's 128 KiB slice of whh in the registers of 512 threads (128 a
// thread: the whole register file, and a spill) and tiled 8 batch rows, so
// D = 2 took 256 CTAs: on an H100 (132 SMs) at most 15 clusters of 8 CTAs
// are co-resident at one CTA an SM (cudaOccupancyMaxActiveClusters), so
// the grid ran in three waves.  The wide family (lstm_wide.cuh) pays a
// barrier across the grid every step, about 2 us, more than this design's
// step.
//
// Design.  One cluster of N = 8 CTAs (the portable size) per (batch tile,
// direction), 256 threads a CTA, one CTA an SM; CTA rank r owns the units
// [32 r, 32 r + 32).  The step's product puts the weights in the A operand
// of mma.sync m16n8k8 (M: the CTA's gate columns, or units) and the batch
// rows in N, so a tile is 8 NB rows (NB = 2, 3 or 4 n8 blocks) and the plan
// of ops/lstm_scan.py takes the smallest tile whose clusters are all
// co-resident: at B = 128, 16 rows at D = 1 (8 clusters) and 24 at D = 2 (12
// clusters on 96 SMs; 16-row tiles would need 16 clusters).
//
// The forward's step: whh-slice^T [128 gate columns, 256] x h[t-1]^T [256,
// 8 NB] on the tensor cores, then the gate math, c kept in the registers of
// the lane that owns (row, unit), then the new h of the CTA's units into the
// h buffer of every CTA of the cluster (16-byte st.async, counted on the
// receiver's mbarrier; the h of 4 units of a row a store).  Warp w owns the
// units 8 (w % 4) .. + 7 and the k-steps of its half (w / 4) of K: its two
// m16 blocks are the gates (i, f) and (g, o) of those 8 units (row m of a
// block is unit m % 8, gate m / 8), so lane (g, q) ends the product with
// the 4 gates of unit 8 (w % 4) + g in rows 2 q and 2 q + 1 of each n block.
// The two warps of a unit group swap the halves of their sums through
// shared memory (a barrier of the pair's 64 threads), so that each ends
// with the whole sum of one of the two rows: one add a value, in the same
// order on either side.
//
// The backward's step (split over the gate columns, not the units): the
// owner of (row, unit) computes its 4 dpre from the saved gates and dh, and
// writes them to dxw and to this CTA's dpre buffer; after one __syncthreads
// the CTA multiplies whh^T's rows of its dpre columns, as whh [256 units,
// 128] (M: units), by its dpre^T [128, 8 NB], giving a partial dh of all
// 256 units; warp w holds the 32 units of CTA w (row m of its m block mb is
// unit 4 (m % 8) + 2 mb + m / 8, so a lane's four sums of a row are four
// neighbouring units, one 16-byte store) and sends them there (st.async into
// that CTA's slot for this source); each CTA's owners then add the 8
// partials in rank order.  Exchanging dpre instead would send 4x the bytes,
// and two step buffers of it beside the 128 KiB slice would not fit.
//
// The product is split TF32 (rowtile::split_tf32): x = hi + lo, three
// mma.sync m16n8k8 products lo*hi, hi*lo, hi*hi with f32 sums, which agree
// with an f32 FMA chain to about 2^-20 of the terms.  The CTA's slice (128
// KiB in f32) stays in shared memory for all T steps, laid out in fragment
// order: a warp's A fragments of an m block and a k-step are 32 lanes x 4
// floats in a row, one 16-byte load a lane, without bank conflicts.  Both
// operands are split as they are loaded: a stored hi/lo pair of the slice
// would take 256 KiB, more than the SM has; the split costs an AND and a
// subtraction a register (16 a k-step for the weights, shared by the NB n
// blocks).  Within each k-step of 8 the mma's k index q < 4 is the
// operand's column 2 q and q + 4 its column 2 q + 1 (a permutation of the
// sum), so a lane's b0/b1 are one 8-byte load.  The rows of the forward's h
// buffer are H + 8 floats apart, those of the backward's dpre buffer 4 U +
// 8: those loads hit 32 banks.
//
// The exchange keeps what lstm_cluster.cuh learned: st.async counted on the
// receiver's mbarriers, two buffers and two mbarriers by step parity, no
// cluster barrier and no fence in the step loop, and a fixed order of every
// sum (the same inputs give the same bits).  Reuse is safe for the same
// reasons: every warp owns units and sends each step, after its own reads
// of the buffer; the backward's __syncthreads puts every owner's read of a
// partial buffer before any warp's next send; the forward's pair barrier
// puts a warp's read of its partner's half before the partner's next write
// (the partner writes again only after the next step's mbarrier, which
// waits for this warp's sends).  Thread 0 re-arms an
// mbarrier right after its wait, before its warp sends the values without
// which no peer can send into that phase.
//
// The wrapper (ops/lstm_scan.py, lstm_launch_plan) computes the plan (N,
// the batch tile, threads, shared-memory bytes, and the waves it claims);
// the C entry points check it against the rules below, and a grid whose
// clusters do not fit the claimed waves on the card (by
// cudaOccupancyMaxActiveClusters) is refused (cudaErrorCooperativeLaunchTooLarge).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_cluster.cuh"
#include "rowtile.cuh"

namespace lstm_mid {
namespace {

constexpr int H = 256;       // the hidden size this family runs
constexpr int N = 8;         // CTAs a cluster
constexpr int U = H / N;     // units a CTA
constexpr int NT = 256;      // threads a CTA
constexpr int NW = NT / 32;  // warps a CTA: 8 units and a half of K each (forward), or 32 units
constexpr int MIN_NB = 2;    // n8 blocks of batch rows: tiles of 16, 24 or 32 rows
constexpr int MAX_NB = 4;
constexpr int LDH = H + 8;   // floats between rows of the forward's h buffer
constexpr int LDP = 4 * U + 8;  // and of the backward's dpre buffer
constexpr int SLICE = H * 4 * U;  // floats of a CTA's slice of whh

// Shared memory: two mbarriers (16 bytes), the slice, then the forward's
// two h buffers and the halves its warps swap (NW warps x bt / 8 n blocks x
// 32 lanes x 4), or the backward's two dpre buffers and two partial-sum
// buffers (N sources x bt rows x U units each).
inline size_t fwd_smem_bytes(int bt) {
  return 16 + sizeof(float) * ((size_t)SLICE + 2 * (size_t)bt * LDH + 16 * (size_t)NW * bt);
}

inline size_t bwd_smem_bytes(int bt) {
  return 16 + sizeof(float) * ((size_t)SLICE + 2 * (size_t)bt * LDP + 2 * (size_t)N * bt * U);
}

// The plan rules: n CTAs a cluster, bt rows a tile, `threads` a CTA.
inline bool plan_ok(int n, int bt, int threads) {
  return n == N && threads == NT && bt % 8 == 0 && bt >= 8 * MIN_NB && bt <= 8 * MAX_NB;
}

// acc += a b for one m16n8k8 block in TF32, f32 sums.  Not volatile: the
// compiler may interleave the products with the next k-step's loads.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment (a0 .. a3, as stored in fragment order), split.
__device__ __forceinline__ void split_a(float4 v, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  rowtile::split_tf32(v.x, hi[0], lo[0]);
  rowtile::split_tf32(v.y, hi[1], lo[1]);
  rowtile::split_tf32(v.z, hi[2], lo[2]);
  rowtile::split_tf32(v.w, hi[3], lo[3]);
}

// The B fragments of NB n blocks at k-step s, split: row g of each block
// from `row0` (this lane's row g of block 0 at its column 2 q), rows `ld`
// floats apart; b0 is column 8 s + 2 q, b1 the next.
template <int NB>
__device__ __forceinline__ void load_b(const float* row0, int ld, int s, uint32_t (&hi)[NB][2],
                                       uint32_t (&lo)[NB][2]) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const float2 v = *reinterpret_cast<const float2*>(row0 + 8 * nb * ld + 8 * s);
    rowtile::split_tf32(v.x, hi[nb][0], lo[nb][0]);
    rowtile::split_tf32(v.y, hi[nb][1], lo[nb][1]);
  }
}

// acc[mb][nb] += A B for one k-step: lo*hi, hi*lo, then hi*hi, each a pass
// over all of the warp's blocks (bh, bl: [nb][b0, b1])
template <int MB, int NB>
__device__ __forceinline__ void step_products(float (&acc)[MB][NB][4],
                                              const uint32_t (&ah)[MB][4],
                                              const uint32_t (&al)[MB][4],
                                              const uint32_t (&bh)[NB][2],
                                              const uint32_t (&bl)[NB][2]) {
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) mma(acc[mb][nb], al[mb], bh[nb][0], bh[nb][1]);
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) mma(acc[mb][nb], ah[mb], bl[nb][0], bl[nb][1]);
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) mma(acc[mb][nb], ah[mb], bh[nb][0], bh[nb][1]);
}

// Checks the plan (n, bt, `waves` claimed for the grid's clusters, threads,
// smem against `want`) and the card, and launches `kernel` as a grid of
// clusters of N CTAs along x, one per (tile, direction).  A grid with more
// clusters than `waves` times the card's co-resident clusters of `kernel`
// is refused: the plan's waves are what runs.
template <typename... KArgs, typename... Args>
int launch(void (*kernel)(KArgs...), int D, int B, int n, int bt, int waves, int threads,
           long long smem, size_t want, cudaStream_t stream, Args&&... args) {
  if (!plan_ok(n, bt, threads) || waves < 1 || smem < 0 || (size_t)smem != want)
    return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > optin) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int clusters = (B + bt - 1) / bt * D;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = N;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters / D * N, D);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int resident = 0;
  err = cudaOccupancyMaxActiveClusters(&resident, (const void*)kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if ((long long)resident * waves < clusters) return (int)cudaErrorCooperativeLaunchTooLarge;
  err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The clusters of `kernel` co-resident on the current card at `smem` bytes
// (cudaOccupancyMaxActiveClusters), or minus a CUDA error code.
template <typename... KArgs>
int coresident(void (*kernel)(KArgs...), size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = N;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int resident = 0;
  err = cudaOccupancyMaxActiveClusters(&resident, (const void*)kernel, &cfg);
  return err == cudaSuccess ? resident : -(int)err;
}

}  // namespace
}  // namespace lstm_mid
