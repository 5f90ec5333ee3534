// Weight-gradient reductions of the backward kernels: C = A^T B summed over
// many rows, and sums of per-CTA partial results, in a fixed order and
// without atomics.
//
// The TPU kernels accumulate their dW products in VMEM across the
// sequential grid (pallas_block.py _bwd_kernel :299-370, pallas_lstm.py
// _bwd_kernel :145-147, pallas_conv.py _bwd_kernel :193-215).  On the card
// the rows are spread over CTAs, so each CTA writes the partial sum of its
// chunk of rows into a workspace and a second kernel adds the partials in a
// fixed order: the result is the same bits from run to run.
//
// What bounds the product on an H100: f32 FMAs outside the tensor cores, 128
// a clock on each SM, but only if shared memory and the copies from L2 keep
// up.  The tile is therefore built like a register-tiled SGEMM:
//   - a CTA of 256 threads owns one 64 x 64 tile of C over KC rows.  The rows
//     arrive KT at a time by 16-byte cp.async into a ring of STAGES stages, so
//     the next rows are in flight while these are multiplied; the address of
//     a row is computed once per 16-byte copy, and a copy past the ragged edge
//     (rows, or columns of A or B) is a zero fill (src-size 0);
//   - the 8 warps form KG = 4 groups of 64 threads.  Each group takes a
//     quarter of every stage's rows and each thread holds 8 x 8 sums of the
//     whole tile (rows {4 ty.., 32 + 4 ty..}, columns {4 tx.., 32 + 4 tx..}),
//     reading its operands as four LDS.128 per row for 64 FMAs: the 8 lanes
//     of a quarter warp read 128 contiguous bytes of B and one broadcast
//     float4 of A, so no load conflicts;
//   - at the end the four groups' tiles meet in shared memory (the ring's
//     64 KB) and are added as (g0 + g1) + (g2 + g3);
//   - one launch runs a caller's whole set of products (a job table in the
//     kernel's arguments), so that E x E products over 24,576 rows, 64 CTAs
//     each, fill the card together with their larger neighbours; one more
//     launch adds every job's partials, and whatever per-CTA partial sums
//     the caller's row kernels wrote (bias gradients), 8 interleaved running
//     sums per output joined by a fixed tree.
//
// Rows are addressed in two levels so that one kernel reads the block's
// [B*T, C] activations and one direction of the LSTM's [T, D, B, C] tensors:
// row k of a Rows view is at p + (k / inner) * outer + (k % inner) * ld.
// Every row must start on a 16-byte boundary and M and N must be multiples
// of 4: add_product refuses anything else.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace wgrad {
namespace {  // each translation unit that includes this keeps its own copy

struct Rows {
  const float* p;
  int inner;        // rows per outer step
  long long outer;  // floats between outer steps
  long long ld;     // floats between rows of one outer step
};

// contiguous [K][ld] rows
__host__ __device__ inline Rows rows(const float* p, long long ld) {
  return Rows{p, INT_MAX, 0, ld};
}

__device__ __forceinline__ const float* row_ptr(const Rows& r, int k) {
  if (r.inner == INT_MAX) return r.p + (long long)k * r.ld;
  return r.p + (long long)(k / r.inner) * r.outer + (long long)(k % r.inner) * r.ld;
}

constexpr int TILE = 64;    // C tile edge
constexpr int KT = 32;      // rows per stage
constexpr int STAGES = 4;   // stages of the cp.async ring
constexpr int NT = 256;     // threads per CTA
constexpr int KG = 4;       // thread groups of a CTA, each with a quarter of a stage's rows
constexpr int KC = 384;     // rows per partial
constexpr int SMEM_BYTES = STAGES * 2 * KT * TILE * 4;  // the ring; then the groups' tiles
constexpr int MAX_JOBS = 8;   // products per launch
constexpr int MAX_SUMS = 16;  // sums per launch
constexpr int SUM_COLS = 32;  // outputs per CTA of the sums kernel
constexpr int SUM_WAYS = 8;   // interleaved running sums per output

static_assert(NT == KG * TILE, "a group of 64 threads holds a whole tile, 8 x 8 each");
static_assert(KT % KG == 0 && KT * TILE / 4 == 2 * NT, "two 16-byte copies per operand a thread");
static_assert(KG * TILE * TILE * 4 <= SMEM_BYTES, "the groups' tiles fit the ring");
static_assert(NT == SUM_COLS * SUM_WAYS, "one warp per running sum");

// the 16-byte copies of cp_async.cuh, also under this namespace's name
using ::cp_async16;
using ::cp_async_commit;
using ::cp_async_wait;

// this thread's 8 x 8 sums: acc[i][j] += a[i] * b[j] for one row, a and b
// each two float4 of a stage row (`ar`, `br`: the row's 64 floats of the A
// and B tile); ty, tx in 0..7 place the thread in the tile
__device__ __forceinline__ void fma_row(const float* ar, const float* br, int ty, int tx,
                                        float (&acc)[8][8]) {
  const float4 a0 = *reinterpret_cast<const float4*>(ar + 4 * ty);
  const float4 a1 = *reinterpret_cast<const float4*>(ar + 32 + 4 * ty);
  const float4 b0 = *reinterpret_cast<const float4*>(br + 4 * tx);
  const float4 b1 = *reinterpret_cast<const float4*>(br + 32 + 4 * tx);
  const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
}

// row 4 ty + i (i < 4) or 32 + 4 ty + i - 4 of the tile, for acc[i][..]
__device__ __forceinline__ int tile_row(int ty, int i) {
  return (i < 4 ? 0 : 32 - 4) + 4 * ty + i;
}

// out[m][n] (row stride N) = sum of A[k][m] B[k][n] over the rows k0 <= k < k1,
// for the TILE x TILE tile at (m0, n0); NT threads, SMEM_BYTES of `smem`
__device__ __forceinline__ void atb_tile(const Rows& A, const Rows& B, int M, int N, int k0,
                                         int k1, int m0, int n0, float* __restrict__ out,
                                         float* smem) {
  float* As = smem;                         // [STAGES][KT][TILE]
  float* Bs = smem + STAGES * KT * TILE;    // [STAGES][KT][TILE]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // copy role: float4 column c4 of the stage's rows lr and lr + 16
  const int c4 = (tid % 16) * 4, lr = tid / 16;
  const bool a_in = m0 + c4 < M, b_in = n0 + c4 < N;
  // product role: group g, thread (ty, tx) of the tile
  const int g = warp >> 1, tx = lane & 7, ty = ((warp & 1) << 2) | (lane >> 3);

  auto load_stage = [&](int st) {
    float* as = As + (st % STAGES) * KT * TILE;
    float* bs = Bs + (st % STAGES) * KT * TILE;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = lr + 16 * half, k = k0 + st * KT + r;
      const bool in = k < k1;
      cp_async16(as + r * TILE + c4, in && a_in ? row_ptr(A, k) + m0 + c4 : A.p, in && a_in);
      cp_async16(bs + r * TILE + c4, in && b_in ? row_ptr(B, k) + n0 + c4 : B.p, in && b_in);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nst = (k1 - k0 + KT - 1) / KT;
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nst) load_stage(st);
    cp_async_commit();
  }
  for (int it = 0; it < nst; ++it) {
    cp_async_wait<STAGES - 2>();  // stage `it` has landed (this thread's copies)
    __syncthreads();              // everyone's; and stage it-1 is read by no one now
    if (it + STAGES - 1 < nst) load_stage(it + STAGES - 1);
    cp_async_commit();
    const float* ar = As + ((it % STAGES) * KT + g * (KT / KG)) * TILE;
    const float* br = Bs + ((it % STAGES) * KT + g * (KT / KG)) * TILE;
#pragma unroll
    for (int kk = 0; kk < KT / KG; ++kk) fma_row(ar + kk * TILE, br + kk * TILE, ty, tx, acc);
  }
  cp_async_wait<0>();
  __syncthreads();

  // the groups' tiles into shared memory, then (g0 + g1) + (g2 + g3)
  float* red = smem;  // [KG][TILE][TILE]
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = red + (g * TILE + tile_row(ty, i)) * TILE;
    *reinterpret_cast<float4*>(row + 4 * tx) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + 32 + 4 * tx) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TILE * TILE / 4 / NT; ++i) {
    const int f = tid + NT * i, m = f / (TILE / 4), n = (f % (TILE / 4)) * 4;
    const float4 r0 = *reinterpret_cast<const float4*>(red + m * TILE + n);
    const float4 r1 = *reinterpret_cast<const float4*>(red + (TILE + m) * TILE + n);
    const float4 r2 = *reinterpret_cast<const float4*>(red + (2 * TILE + m) * TILE + n);
    const float4 r3 = *reinterpret_cast<const float4*>(red + (3 * TILE + m) * TILE + n);
    if (m0 + m < M && n0 + n < N)
      *reinterpret_cast<float4*>(out + (size_t)(m0 + m) * N + n0 + n) =
          make_float4((r0.x + r1.x) + (r2.x + r3.x), (r0.y + r1.y) + (r2.y + r3.y),
                      (r0.z + r1.z) + (r2.z + r3.z), (r0.w + r1.w) + (r2.w + r3.w));
  }
}

// one product: partial[s][m][n] = sum of A[k][m] B[k][n] over the rows k of
// chunk s; CTAs cta0 .. of the grid, tiles fastest, then chunks
struct Job {
  Rows a, b;
  int m, n, k;
  int cta0;
  float* partial;
};

struct Jobs {
  Job j[MAX_JOBS];
  int count;
};

// out[i] = sum over s < S of partial[s * stride + i], i < n.  With d0 > 0 the
// partial is a [d0][d1][n / (d0 d1)] array and out its transpose over the
// outer and inner axes, [n / (d0 d1)][d1][d0] (the conv's tap-major dW into
// torch's [C_out][C_in][K])
struct Sum {
  const float* partial;
  long long stride;
  int s, n;
  int d0, d1;
  int cta0;
  float* out;
};

struct Sums {
  Sum j[MAX_SUMS];
  int count;
};

__global__ void __launch_bounds__(NT, 2) products_kernel(const __grid_constant__ Jobs jobs) {
  extern __shared__ __align__(16) float wgrad_smem[];
  int ji = 0;
  while (ji + 1 < jobs.count && (int)blockIdx.x >= jobs.j[ji + 1].cta0) ++ji;
  const Job& J = jobs.j[ji];
  const int tiles_n = (J.n + TILE - 1) / TILE, tiles = tiles_n * ((J.m + TILE - 1) / TILE);
  const int local = blockIdx.x - J.cta0;
  const int tile = local % tiles, chunk = local / tiles;
  const int k0 = chunk * KC;
  const int k1 = k0 + KC < J.k ? k0 + KC : J.k;
  atb_tile(J.a, J.b, J.m, J.n, k0, k1, (tile / tiles_n) * TILE, (tile % tiles_n) * TILE,
           J.partial + (size_t)chunk * J.m * J.n, wgrad_smem);
}

__global__ void __launch_bounds__(NT) sums_kernel(const __grid_constant__ Sums sums) {
  __shared__ float part[SUM_WAYS][SUM_COLS];
  int ji = 0;
  while (ji + 1 < sums.count && (int)blockIdx.x >= sums.j[ji + 1].cta0) ++ji;
  const Sum& J = sums.j[ji];
  const int c = threadIdx.x % SUM_COLS, way = threadIdx.x / SUM_COLS;
  const int i = (blockIdx.x - J.cta0) * SUM_COLS + c;
  float acc = 0.f;
  if (i < J.n)
    for (int s = way; s < J.s; s += SUM_WAYS) acc += J.partial[(size_t)s * J.stride + i];
  part[way][c] = acc;
  __syncthreads();
  if (way != 0 || i >= J.n) return;
  const float v = ((part[0][c] + part[1][c]) + (part[2][c] + part[3][c])) +
                  ((part[4][c] + part[5][c]) + (part[6][c] + part[7][c]));
  if (J.d0 > 0) {
    const int d2 = J.n / (J.d0 * J.d1);
    const int i0 = i / (J.d1 * d2), i1 = (i / d2) % J.d1, i2 = i % d2;
    J.out[((size_t)i2 * J.d1 + i1) * J.d0 + i0] = v;
  } else {
    J.out[i] = v;
  }
}

inline int chunks(int K) { return K > 0 ? (K + KC - 1) / KC : 1; }

// floats of workspace a product over K rows needs for its partials
inline size_t workspace(int M, int N, int K) { return (size_t)chunks(K) * M * N; }

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

inline bool rows_ok(const Rows& r) {
  return aligned16(r.p) && r.ld % 4 == 0 && r.outer % 4 == 0 && r.inner > 0;
}

// A caller's products and sums, collected, then run as two launches.
struct Plan {
  Jobs jobs{};
  Sums sums{};
  int ctas = 0, sum_ctas = 0;

  // out[i] = the sum of S partials (see Sum); false when the table is full
  bool add_sum(const float* partial, long long stride, int S, int n, float* out, int d0 = 0,
               int d1 = 0) {
    if (sums.count >= MAX_SUMS || S <= 0 || n <= 0) return false;
    sums.j[sums.count++] = Sum{partial, stride, S, n, d0, d1, sum_ctas, out};
    sum_ctas += (n + SUM_COLS - 1) / SUM_COLS;
    return true;
  }

  // C[M][N] = A^T B over K rows (C is written whole; K = 0 gives zeros); its
  // partials go to `ws`, which is advanced past them.  False for a table that
  // is full or operands the 16-byte copies cannot take
  bool add_product(Rows A, Rows B, int M, int N, int K, float* C, float*& ws) {
    if (jobs.count >= MAX_JOBS || M <= 0 || N <= 0 || K < 0 || M % 4 || N % 4 ||
        !rows_ok(A) || !rows_ok(B) || !aligned16(ws) || !aligned16(C))
      return false;
    const int S = chunks(K);
    jobs.j[jobs.count++] = Job{A, B, M, N, K, ctas, ws};
    ctas += S * ((M + TILE - 1) / TILE) * ((N + TILE - 1) / TILE);
    if (!add_sum(ws, (long long)M * N, S, M * N, C)) return false;
    ws += (size_t)S * M * N;
    return true;
  }

  cudaError_t launch_products(cudaStream_t st) const {
    if (jobs.count == 0) return cudaSuccess;
    cudaError_t err = cudaFuncSetAttribute(products_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           SMEM_BYTES);
    if (err != cudaSuccess) return err;
    products_kernel<<<ctas, NT, SMEM_BYTES, st>>>(jobs);
    return cudaGetLastError();
  }

  cudaError_t launch_sums(cudaStream_t st) const {
    if (sums.count == 0) return cudaSuccess;
    sums_kernel<<<sum_ctas, NT, 0, st>>>(sums);
    return cudaGetLastError();
  }
};

}  // namespace
}  // namespace wgrad
