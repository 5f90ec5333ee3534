// Weight-gradient reductions of the backward kernels: C = A^T B summed over
// many rows, and column sums, in a fixed order and without atomics.
//
// The TPU kernels accumulate their dW products in VMEM across the
// sequential grid (pallas_block.py _bwd_kernel :299-370, pallas_lstm.py
// _bwd_kernel :145-147, pallas_conv.py _bwd_kernel :193-215).  On the card
// the rows are spread over CTAs, so each CTA writes the partial sum of its
// chunk of rows into a workspace and a second kernel adds the partials chunk
// by chunk, in chunk order: the result is the same from run to run.  Plain
// f32 FMAs, no tensor cores.
//
// Rows are addressed in two levels so that one kernel reads the block's
// [B*T, C] activations, one direction of the LSTM's [T, D, B, C] tensors and
// the conv's padded input shifted by a tap: row k of a Rows view is at
// p + (k / inner) * outer + (k % inner) * ld.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>

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
  return r.p + (long long)(k / r.inner) * r.outer + (long long)(k % r.inner) * r.ld;
}

constexpr int TILE = 64;     // C tile edge
constexpr int KT = 16;       // rows per shared-memory step
constexpr int NT = 256;      // threads: 16 x 16, each 4 x 4 outputs
constexpr int KC = 256;      // rows per partial (A^T B)
constexpr int KC_SUM = 64;   // rows per partial (column sums)

inline int chunks(int K, int kc) { return K > 0 ? (K + kc - 1) / kc : 1; }

// out[m][n] (row stride N) = sum of A[k][m] B[k][n] over the rows k0 <= k < k1,
// for the TILE x TILE tile at (m0, n0); NT threads
__device__ __forceinline__ void atb_tile(Rows A, Rows B, int M, int N, int k0, int k1,
                                         int m0, int n0, float* __restrict__ out) {
  __shared__ float As[KT][TILE];
  __shared__ float Bs[KT][TILE];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int kb = k0; kb < k1; kb += KT) {
    for (int i = threadIdx.x; i < KT * TILE; i += NT) {
      const int kk = i / TILE, c = i % TILE;
      const int k = kb + kk;
      As[kk][c] = (k < k1 && m0 + c < M) ? row_ptr(A, k)[m0 + c] : 0.f;
      Bs[kk][c] = (k < k1 && n0 + c < N) ? row_ptr(B, k)[n0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[kk][ty * 4 + i];
        b[i] = Bs[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty * 4 + i, n = n0 + tx * 4 + j;
      if (m < M && n < N) out[(size_t)m * N + n] = acc[i][j];
    }
}

// partial[s][m][n] = sum of A[k][m] B[k][n] over the rows k of chunk s
__global__ void __launch_bounds__(NT)
atb_partial_kernel(Rows A, Rows B, int M, int N, int K, float* __restrict__ partial) {
  const int k0 = blockIdx.z * KC;
  const int k1 = k0 + KC < K ? k0 + KC : K;
  atb_tile(A, B, M, N, k0, k1, blockIdx.y * TILE, blockIdx.x * TILE,
           partial + (size_t)blockIdx.z * M * N);
}

// partial[s][n] = sum of A[k][n] over the rows k of chunk s
__global__ void colsum_partial_kernel(Rows A, int N, int K, float* __restrict__ partial) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int k0 = blockIdx.y * KC_SUM;
  const int k1 = k0 + KC_SUM < K ? k0 + KC_SUM : K;
  float acc = 0.f;
  for (int k = k0; k < k1; ++k) acc += row_ptr(A, k)[n];
  partial[(size_t)blockIdx.y * N + n] = acc;
}

// out[i] = sum over s of partial[s][i], s in increasing order
__global__ void reduce_partials_kernel(const float* __restrict__ partial, int S, int MN,
                                       float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += partial[(size_t)s * MN + i];
  out[i] = acc;
}

// floats of workspace that atb / colsum need for K rows
inline size_t atb_workspace(int M, int N, int K) { return (size_t)chunks(K, KC) * M * N; }
inline size_t colsum_workspace(int N, int K) { return (size_t)chunks(K, KC_SUM) * N; }

// C[M][N] = A^T B over K rows (C is written whole; K = 0 gives zeros)
inline cudaError_t atb(Rows A, Rows B, int M, int N, int K, float* C, float* ws,
                       cudaStream_t st) {
  const int S = chunks(K, KC);
  if (K <= 0) return cudaMemsetAsync(C, 0, sizeof(float) * M * N, st);
  const dim3 grid((N + TILE - 1) / TILE, (M + TILE - 1) / TILE, (unsigned)S);
  atb_partial_kernel<<<grid, NT, 0, st>>>(A, B, M, N, K, ws);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_partials_kernel<<<(M * N + 255) / 256, 256, 0, st>>>(ws, S, M * N, C);
  return cudaGetLastError();
}

// C[N] = sum of A's K rows
inline cudaError_t colsum(Rows A, int N, int K, float* C, float* ws, cudaStream_t st) {
  const int S = chunks(K, KC_SUM);
  if (K <= 0) return cudaMemsetAsync(C, 0, sizeof(float) * N, st);
  const dim3 grid((N + 63) / 64, (unsigned)S);
  colsum_partial_kernel<<<grid, 64, 0, st>>>(A, N, K, ws);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_partials_kernel<<<(N + 255) / 256, 256, 0, st>>>(ws, S, N, C);
  return cudaGetLastError();
}

}  // namespace
}  // namespace wgrad
