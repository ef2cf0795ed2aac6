// Helpers shared by the port's CUDA kernels: float <-> storage-type
// conversion, rounding to the compute dtype, activations, a block-wide
// "rows times transposed weight" product on the FMA units, and the host
// side's shared-memory limit of a kernel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>
#include <type_traits>

namespace sct {

constexpr int THREADS = 256;   // threads per block for the row kernels
constexpr int BK = 32;         // reduction depth of one weight tile

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);      // round to nearest even, like astype
}

// value rounded to the storage type T and widened back to float
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// activation codes shared with ops/cuda_ffn.py::ACT_CODES
__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case 1: return fmaxf(x, 0.f);                                   // ReLU
    case 2: return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));  // GELU
    case 3: return x / (1.f + expf(-x));                            // SiLU
    case 4: return tanhf(x);                                        // Tanh
    case 5: return 1.f / (1.f + expf(-x));                          // Sigmoid
    case 6: return x > 0.f ? x : expm1f(x);                         // ELU
    case 7: return x >= 0.f ? x : 0.01f * x;                        // LeakyReLU
    case 8: return x > 20.f ? x : log1pf(expf(x));                  // Softplus
    case 9: return fminf(fmaxf(x, -1.f), 1.f);                      // Hardtanh
    default: return x;                                              // Identity
  }
}

// derivative of activate() at x, same codes (ReLU and Hardtanh take the
// subgradient jax.grad gives: 0 at the kinks)
__device__ __forceinline__ float activate_grad(float x, int act) {
  switch (act) {
    case 1: return x > 0.f ? 1.f : 0.f;
    case 2: return 0.5f * (1.f + erff(x * 0.70710678118654752f)) +
                   x * 0.39894228040143268f * expf(-0.5f * x * x);
    case 3: { const float s = 1.f / (1.f + expf(-x));
              return s * (1.f + x * (1.f - s)); }
    case 4: { const float t = tanhf(x); return 1.f - t * t; }
    case 5: { const float s = 1.f / (1.f + expf(-x)); return s * (1.f - s); }
    case 6: return x > 0.f ? 1.f : expf(x);
    case 7: return x >= 0.f ? 1.f : 0.01f;
    case 8: return 1.f / (1.f + expf(-x));
    case 9: return (x > -1.f && x < 1.f) ? 1.f : 0.f;
    default: return 1.f;
  }
}

// fn(std::integral_constant<int, A>{}) for activation code act (activate
// above): one dispatch for a whole epilogue, so that the compiler sees
// the activation as a constant and interleaves the elements' arithmetic
template <typename Fn>
__device__ __forceinline__ void with_act(int act, Fn fn) {
  switch (act) {
    case 1: fn(std::integral_constant<int, 1>{}); break;
    case 2: fn(std::integral_constant<int, 2>{}); break;
    case 3: fn(std::integral_constant<int, 3>{}); break;
    case 4: fn(std::integral_constant<int, 4>{}); break;
    case 5: fn(std::integral_constant<int, 5>{}); break;
    case 6: fn(std::integral_constant<int, 6>{}); break;
    case 7: fn(std::integral_constant<int, 7>{}); break;
    case 8: fn(std::integral_constant<int, 8>{}); break;
    case 9: fn(std::integral_constant<int, 9>{}); break;
    default: fn(std::integral_constant<int, 0>{}); break;
  }
}

// Dropout bits: the murmur-style mixer of the JAX package's interpret-mode
// _dropout_mask (speechain_tpu/ops/pallas_attention.py:194-217), shared with
// the plain versions in ops/dropout.py. uint32 arithmetic wraps as in JAX.
__device__ __forceinline__ unsigned int dropout_bits(unsigned int lin,
                                                     unsigned int seed) {
  unsigned int x = lin * 2654435761u + seed;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

// keep-mask value: scale (= 1 / (1 - rate)) if kept, else 0
__device__ __forceinline__ float dropout_keep(unsigned int lin,
                                              unsigned int seed,
                                              unsigned int thresh,
                                              float scale) {
  return dropout_bits(lin, seed) >= thresh ? scale : 0.f;
}

// For R rows of A (float, shared memory, row stride K) and every column c of
// W (K rows of NC elements, row-major, type T, device memory), computes
// acc[r] = sum_k A[r][k] * W[k][c] and calls epi(r, c, acc[r]). Thread c
// reads W[k][c] straight from device memory (neighbouring threads read
// neighbouring addresses). Must be called by all THREADS threads.
template <typename T, int R, typename Epi>
__device__ __forceinline__ void rows_times_w(const float* A, int K,
                                             const T* __restrict__ W, int NC,
                                             Epi epi) {
  for (int c = threadIdx.x; c < NC; c += THREADS) {
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float w = to_f(W[(size_t)k * NC + c]);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(A[r * K + k], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) epi(r, c, acc[r]);
  }
}

// For R rows of A (float, shared memory, row stride K) and every column c of
// W (NC rows of K elements, row-major, type T, device memory), computes
// acc[r] = sum_k A[r][k] * W[c][k] and calls epi(r, c, acc[r]).
// One output column per thread per pass of THREADS columns; W is staged in
// (THREADS, BK) tiles through `ws` (THREADS * (BK + 1) floats; the +1 pad
// keeps the column reads free of bank conflicts). Must be called by all
// THREADS threads of the block.
template <typename T, int R, typename Epi>
__device__ __forceinline__ void rows_times_wt(const float* A, int K,
                                              const T* __restrict__ W, int NC,
                                              float* ws, Epi epi) {
  const int tid = threadIdx.x;
  for (int c0 = 0; c0 < NC; c0 += THREADS) {
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    for (int k0 = 0; k0 < K; k0 += BK) {
      for (int i = tid; i < THREADS * BK; i += THREADS) {
        const int cc = i / BK, kk = i - cc * BK;
        const int gc = c0 + cc, gk = k0 + kk;
        ws[cc * (BK + 1) + kk] =
            (gc < NC && gk < K) ? to_f(W[(size_t)gc * K + gk]) : 0.f;
      }
      __syncthreads();
      const int kmax = min(BK, K - k0);
      const float* wrow = ws + tid * (BK + 1);
      for (int kk = 0; kk < kmax; ++kk) {
        const float w = wrow[kk];
#pragma unroll
        for (int r = 0; r < R; ++r)
          acc[r] = fmaf(A[r * K + k0 + kk], w, acc[r]);
      }
      __syncthreads();
    }
    const int c = c0 + tid;
    if (c < NC) {
#pragma unroll
      for (int r = 0; r < R; ++r) epi(r, c, acc[r]);
    }
  }
}

constexpr int MAX_DEVICES = 64;
typedef std::atomic<size_t> SmemSet[MAX_DEVICES];

// Raises a kernel's dynamic shared-memory limit to `bytes`, with the SM's
// largest shared-memory carveout so that the blocks the launch bounds ask
// for fit beside each other, when a launch needs more than was set on
// this device before (`set`, one per kernel instance): a path whose
// shapes repeat sets no attribute.
template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes, SmemSet& set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (bytes <= set[dev].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) set[dev].store(bytes);
  return err;
}

// a kernel's static shared memory plus `dynamic` -> *out
template <typename Kern>
cudaError_t smem_of(Kern kern, size_t dynamic, long long* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kern);
  if (err == cudaSuccess) *out = (long long)(a.sharedSizeBytes + dynamic);
  return err;
}

}  // namespace sct
