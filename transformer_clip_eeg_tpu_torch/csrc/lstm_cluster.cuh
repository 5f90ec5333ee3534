// Launch plan, thread layout and step exchange of the LSTM recurrence
// kernels (lstm_scan.cu forward, lstm_scan_bwd.cu backward).
//
// One thread-block cluster of n CTAs runs one recurrence (a batch tile of bt
// rows, one direction).  CTA rank r of the cluster owns the hidden units
// [r U, (r+1) U), U = H / n, and all four gates of each: c (forward) or dc
// (backward) stays in the registers of the thread that owns (row, unit).
// A CTA has OWNERS owner threads, one per (row, unit), so bt = OWNERS / U.
// This family runs H <= 128; H = 256 runs the clusters of lstm_mid.cuh.
//
// The step's product.  Every thread of the CTA (NT: at H >= 32 twice the
// owners, so that 16 warps hide the latencies of shared-memory loads and
// FMA chains) holds a fixed share of the CTA's weight slice in registers,
// sums RPT batch rows over its k group (forward) or gate-column group
// (backward), and the KG threads of a group, neighbouring lanes of one
// warp, add their partial sums by shuffles (group_sum): halving the values
// between lane pairs, then adding what is left in full.  The sums land in
// the owner threads, a fixed tree from run to run.  No shared memory and no
// __syncthreads in the reduction.
//
// The exchange.  Each step's h (forward) or dpre (backward) is written into
// the shared memory of every CTA of the cluster with 16-byte st.async (h of
// 4 units gathered in one lane; the 4 gates of one unit's dpre), which
// counts its bytes on an mbarrier of the receiving CTA.  The batch rows are
// independent recurrences, so a CTA's threads form GROUPS exchange groups
// (EG at H <= 128), each with the rows of its own threads and its own
// mbarriers: a group waits only until its rows of h (or dpre) have arrived
// from every CTA, and while one group waits for its exchange another
// computes.  Two buffers and two mbarriers a group, by step parity.  The
// forward sends the h of 4 units in one store (4 units' k groups share a
// warp: 4 KG <= 32).  A cluster of one CTA (the H <= 32
// layers) stores into its own buffer and crosses one __syncthreads a step:
// a block barrier costs less than the mbarrier round trip.  There is no cluster
// barrier and no memory fence in the step loop: a cluster barrier with
// release semantics compiles to MEMBAR.ALL.GPU, which waits for every
// global load and store in flight (the prefetched operands of the next step
// included).  Reuse is safe: every warp holds owners, which send the step's
// values only after the warp's shuffles, so after every read of the warp
// from the buffer those values' successors overwrite two steps later; and
// a CTA receives step t+1's values only after all of its own step t values
// were sent.  The same two facts keep the parity waits sound: every lane
// meets its warp's full-mask shuffles each step and every warp sends each
// step, so no thread falls a whole phase behind the others (a wait by
// parity would take a phase two ahead for the one it waits for, and hang).
//
// The wrapper (ops/lstm_scan.py, lstm_launch_plan) computes the plan (n, bt,
// threads, shared memory bytes) from (B, D, H); the C entry points check it
// against the rules below and return cudaErrorInvalidValue for any other.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace lstm {
namespace {

constexpr int OWNERS = 256;     // threads that own a (row, unit)
constexpr int MAX_CLUSTER = 8;  // the portable cluster size (this family takes 4 at most)
constexpr int EG = 2;           // exchange groups at most: threads [g NT / G, (g+1) NT / G)

// Threads per CTA at hidden size H.
template <int H>
constexpr int threads() {
  return H >= 32 ? 2 * OWNERS : OWNERS;
}

// Forward product h_prev [bt, H] x whh-slice [H, 4U]: split over k.  A thread
// holds KPT of the k (k = 4 KG i + 4 kg + q: neighbouring lanes read
// neighbouring float4s of h) x 4 gates of one unit's whh columns and sums
// RPT batch rows x 4 gates; its group keeps 4 gates of one row per owner.
template <int H>
struct Fwd {
  static constexpr int NT = threads<H>();
  static constexpr int KPT = H < 16 ? H : 16;
  static constexpr int KG = H / KPT;
  static constexpr int RPT = KG * OWNERS / NT;
  static constexpr int NV = 4 * RPT, KEEP = 4;
  static constexpr int GROUPS = EG;
};

// Backward product dpre [bt, 4H] x whh-slice^T [4H, U]: split over the 4H
// gate columns.  A thread holds UPT units x CPT columns of whh and sums RPT
// batch rows x UPT units; its group keeps one (row, unit) per owner.
template <int H>
struct Bwd {
  static constexpr int NT = threads<H>();
  static constexpr int UPT = 4;
  static constexpr int CPT = H >= 32 ? H / 8 : 4;
  static constexpr int KG = 4 * H / CPT;
  static constexpr int RPT = KG / UPT * OWNERS / NT;
  static constexpr int NV = RPT * UPT, KEEP = 1;
  static constexpr int GROUPS = EG;
};

// Adds the NV values v of the lanes of a group (the lane bits below 2M)
// with shuffles: at each level the two lanes of a pair split the values,
// the upper lane keeping the upper half, until KEEP remain; the remaining
// levels add those in full.  The lane's sums are then v[0, KEEP), values
// group_offset .. + KEEP of the group's; lanes whose low bits (the levels
// that add in full) are 0 own them.
template <int M, int NV, int KEEP, int CAP>
__device__ __forceinline__ void group_sum(float (&v)[CAP], int lane) {
  if constexpr (M >= 1) {
    const bool upper = (lane & M) != 0;
    if constexpr (NV > KEEP) {
      constexpr int half = NV / 2;
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const float give = upper ? v[i] : v[i + half];
        const float keep = upper ? v[i + half] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, give, M);
      }
      group_sum<M / 2, half, KEEP, CAP>(v, lane);
    } else {
#pragma unroll
      for (int i = 0; i < KEEP; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], M);
      group_sum<M / 2, NV, KEEP, CAP>(v, lane);
    }
  }
}

template <int M, int NV, int KEEP>
__device__ __forceinline__ int group_offset(int lane) {
  if constexpr (M >= 1 && NV > KEEP)
    return ((lane & M) ? NV / 2 : 0) + group_offset<M / 2, NV / 2, KEEP>(lane);
  else
    return 0;
}

// The plan rules shared by both kernels; nt, rpt and groups are the
// kernel's threads, rows per product thread and exchange groups.  Returns
// the units per CTA, or 0 if the plan is refused.
inline int plan_units(int H, int n, int bt, int threads, int nt, int rpt, int groups) {
  if (threads != nt || n < 1 || n > MAX_CLUSTER || H % n != 0) return 0;
  const int units = H / n;
  if (units < 4 || units % 4 != 0 || OWNERS % units != 0) return 0;
  if (bt != OWNERS / units || bt % (groups * rpt) != 0) return 0;
  return units;
}

// Shared memory: 2 EG mbarriers (the most groups a kernel has), then the
// two step buffers.
constexpr size_t BARRIER_BYTES = 2 * EG * sizeof(uint64_t);

inline size_t fwd_smem_bytes(int H, int bt) {
  return BARRIER_BYTES + sizeof(float) * 2 * (size_t)bt * H;  // h of the previous step
}

inline size_t bwd_smem_bytes(int H, int bt) {
  return BARRIER_BYTES + sizeof(float) * 2 * (size_t)bt * 4 * H;  // dpre of the step
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The same shared-memory offset in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// Makes initialised mbarriers visible to the other CTAs of the cluster.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arms the mbarrier's current phase: it completes when `bytes` have arrived.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Waits until the phase of parity `parity` has completed; what the peers
// wrote with st_async before completing it is then visible.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Stores v at the cluster address `dst` (16-byte aligned) and counts its 16
// bytes on the mbarrier at the cluster address `bar` (both in the same CTA).
__device__ __forceinline__ void st_async(uint32_t dst, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(dst),
      "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)), "r"(__float_as_uint(v.z)),
      "r"(__float_as_uint(v.w)), "r"(bar)
      : "memory");
}

// Writes v at shared-memory `slot` of every CTA of the cluster, counted on
// each CTA's mbarrier `bar`.  One 16-byte store per CTA: the receiver's
// mbarrier counts each store, so fewer and wider stores arrive sooner.
__device__ __forceinline__ void send_all(float* slot, uint64_t* bar, float4 v, int n) {
  const uint32_t a = smem_addr(slot), m = smem_addr(bar);
  for (int peer = 0; peer < n; ++peer) st_async(map_rank(a, peer), v, map_rank(m, peer));
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;\n" ::: "memory");
}

// Checks that `smem` is the bytes the plan needs and fits, raises the
// kernel's dynamic shared-memory limit to it, and launches `kernel` as a
// grid of clusters of n CTAs along x.
template <typename... KArgs, typename... Args>
int launch_clusters(void (*kernel)(KArgs...), dim3 grid, int nt, int n, size_t smem,
                    size_t want, cudaStream_t stream, Args&&... args) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem != want || smem > (size_t)optin || grid.x % n != 0)
    return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(nt);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace lstm
