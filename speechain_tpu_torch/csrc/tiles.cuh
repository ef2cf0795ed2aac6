// Tiled products and fixed-order sums shared by the backward kernels. Each
// helper is the body of one block of THREADS threads; the .cu files wrap
// them in __global__ kernels of their own names, so a profile tells the
// callers apart. All run on the FMA units in float32 and are deterministic:
// every sum runs in a fixed order, with no atomics.
#pragma once

#include "common.cuh"

namespace sct {

constexpr int WT = 64;   // output tile edge
constexpr int WK = 32;   // reduction rows staged per step

// C[i][j] = sum_r A[r][i] * B[r][j] over r < N, A (N, M1) and B (N, M2)
// row-major in T, C (M1, M2) float32; this block computes the 64 x 64 tile
// (blockIdx.y, blockIdx.x), summing rows in steps of 32, in order.
template <typename T>
__device__ __forceinline__ void wgrad_tile(const T* __restrict__ A,
                                           const T* __restrict__ B,
                                           float* __restrict__ C, int N,
                                           int M1, int M2) {
  __shared__ float As[WK][WT];
  __shared__ float Bs[WK][WT];
  const int i0 = blockIdx.y * WT, j0 = blockIdx.x * WT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int r0 = 0; r0 < N; r0 += WK) {
    for (int e = threadIdx.x; e < WK * WT; e += THREADS) {
      const int kk = e / WT, ii = e - kk * WT, r = r0 + kk;
      As[kk][ii] = (r < N && i0 + ii < M1)
                       ? to_f(A[(size_t)r * M1 + i0 + ii]) : 0.f;
      Bs[kk][ii] = (r < N && j0 + ii < M2)
                       ? to_f(B[(size_t)r * M2 + j0 + ii]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < WK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        a[u] = As[kk][ty + 16 * u];
        b[u] = Bs[kk][tx + 16 * u];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int i = i0 + ty + 16 * u, j = j0 + tx + 16 * v;
      if (i < M1 && j < M2) C[(size_t)i * M2 + j] = acc[u][v];
    }
}

// C[i][j] = round_T(sum_r A[i][r] * B[r][j]) over r < N, A (M1, N) and
// B (N, M2) row-major in T, C (M1, M2) in T; tile as wgrad_tile. A is
// staged transposed through a padded tile, so both loads coalesce and the
// stores are free of bank conflicts.
template <typename T>
__device__ __forceinline__ void gemm_nn_tile(const T* __restrict__ A,
                                             const T* __restrict__ B,
                                             T* __restrict__ C, int M1,
                                             int N, int M2) {
  __shared__ float As[WK][WT + 1];
  __shared__ float Bs[WK][WT];
  const int i0 = blockIdx.y * WT, j0 = blockIdx.x * WT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int r0 = 0; r0 < N; r0 += WK) {
    for (int e = threadIdx.x; e < WK * WT; e += THREADS) {
      const int ii = e / WK, kk = e - ii * WK, r = r0 + kk;
      As[kk][ii] = (r < N && i0 + ii < M1)
                       ? to_f(A[(size_t)(i0 + ii) * N + r]) : 0.f;
      const int kb = e / WT, jj = e - kb * WT, rb = r0 + kb;
      Bs[kb][jj] = (rb < N && j0 + jj < M2)
                       ? to_f(B[(size_t)rb * M2 + j0 + jj]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < WK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        a[u] = As[kk][ty + 16 * u];
        b[u] = Bs[kk][tx + 16 * u];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int i = i0 + ty + 16 * u, j = j0 + tx + 16 * v;
      if (i < M1 && j < M2) C[(size_t)i * M2 + j] = from_f<T>(acc[u][v]);
    }
}

// out[w] = sum_p part[p][w] over p < n_part, in order of p (part (n_part,
// W) float32): the fixed-order reduction of per-block partial sums. One
// thread per column w.
__device__ __forceinline__ void sum_parts(const float* __restrict__ part,
                                          float* __restrict__ out,
                                          int n_part, int W) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  float s = 0.f;
  for (int p = 0; p < n_part; ++p) s += part[(size_t)p * W + w];
  out[w] = s;
}

}  // namespace sct
